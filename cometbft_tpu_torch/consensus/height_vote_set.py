"""Per-height vote bookkeeping across rounds (a copy of
cometbft_tpu/consensus/height_vote_set.py; reference:
internal/consensus/types/height_vote_set.go).

Keeps prevote/precommit VoteSets for every round at one height, plus
per-peer "catchup" round tracking so a byzantine peer can't make us
allocate unbounded VoteSets (SetPeerMaj23 limits each peer to one
catchup round).  Its lock is ``utils/sync``'s ``Mutex()``.
"""

from __future__ import annotations

import threading

from cometbft_tpu_torch.types.block import BlockID
from cometbft_tpu_torch.types.canonical import PRECOMMIT_TYPE, PREVOTE_TYPE
from cometbft_tpu_torch.types.validator import ValidatorSet
from cometbft_tpu_torch.types.vote import Vote
from cometbft_tpu_torch.types.vote_set import VoteSet
from cometbft_tpu_torch.utils.bit_array import BitArray
from cometbft_tpu_torch.utils import sync as cmtsync


class HeightVoteSetError(Exception):
    pass


class HeightVoteSet:
    def __init__(
        self,
        chain_id: str,
        height: int,
        val_set: ValidatorSet,
        extensions_enabled: bool = False,
    ):
        self.chain_id = chain_id
        self.height = height
        self.val_set = val_set
        self.extensions_enabled = extensions_enabled
        self._mtx = cmtsync.Mutex()
        self._round = 0
        self._round_vote_sets: dict[int, tuple[VoteSet, VoteSet]] = {}
        self._peer_catchup_rounds: dict[str, list[int]] = {}
        self._add_round(0)

    def _add_round(self, round_: int) -> None:
        if round_ in self._round_vote_sets:
            return
        prevotes = VoteSet(
            self.chain_id, self.height, round_, PREVOTE_TYPE, self.val_set
        )
        precommits = VoteSet(
            self.chain_id,
            self.height,
            round_,
            PRECOMMIT_TYPE,
            self.val_set,
            extensions_enabled=self.extensions_enabled,
        )
        self._round_vote_sets[round_] = (prevotes, precommits)

    def set_round(self, round_: int) -> None:
        """Ensure vote sets exist up to round+1 (height_vote_set.go
        SetRound)."""
        with self._mtx:
            new_round = max(self._round, round_)
            for r in range(self._round, new_round + 2):
                self._add_round(r)
            self._round = new_round

    def round(self) -> int:
        with self._mtx:
            return self._round

    def _get(self, round_: int, vote_type: int) -> VoteSet | None:
        rvs = self._round_vote_sets.get(round_)
        if rvs is None:
            return None
        return rvs[0] if vote_type == PREVOTE_TYPE else rvs[1]

    def add_vote(self, vote: Vote, peer_id: str = "") -> bool:
        """(height_vote_set.go AddVote) — may raise ConflictingVoteError
        for equivocations, surfaced to the evidence pool."""
        with self._mtx:
            if vote.type not in (PREVOTE_TYPE, PRECOMMIT_TYPE):
                raise HeightVoteSetError(f"bad vote type {vote.type}")
            vote_set = self._get(vote.round, vote.type)
            if vote_set is None:
                rounds = self._peer_catchup_rounds.setdefault(peer_id, [])
                if len(rounds) < 2:
                    self._add_round(vote.round)
                    vote_set = self._get(vote.round, vote.type)
                    rounds.append(vote.round)
                else:
                    # Peer has used its catchup allowance
                    # (ErrGotVoteFromUnwantedRound)
                    raise HeightVoteSetError(
                        "peer has sent votes for too many catchup rounds"
                    )
        return vote_set.add_vote(vote)

    def prevotes(self, round_: int) -> VoteSet | None:
        with self._mtx:
            return self._get(round_, PREVOTE_TYPE)

    def precommits(self, round_: int) -> VoteSet | None:
        with self._mtx:
            return self._get(round_, PRECOMMIT_TYPE)

    def pol_info(self) -> tuple[int, BlockID | None]:
        """Highest round with a prevote +2/3 (POLRound, POLBlockID)
        (height_vote_set.go POLInfo)."""
        with self._mtx:
            for r in sorted(self._round_vote_sets, reverse=True):
                vote_set = self._get(r, PREVOTE_TYPE)
                maj23 = vote_set.two_thirds_majority() if vote_set else None
                if maj23 is not None:
                    return r, maj23
        return -1, None

    def set_peer_maj23(
        self, round_: int, vote_type: int, peer_id: str, block_id: BlockID
    ) -> None:
        with self._mtx:
            if vote_type not in (PREVOTE_TYPE, PRECOMMIT_TYPE):
                raise HeightVoteSetError(f"bad vote type {vote_type}")
            self._add_round(round_)
            vote_set = self._get(round_, vote_type)
        vote_set.set_peer_maj23(peer_id, block_id)
