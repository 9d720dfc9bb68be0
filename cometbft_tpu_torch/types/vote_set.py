"""VoteSet — tallying votes for one (height, round, type) (a copy of
cometbft_tpu/types/vote_set.py; reference types/vote_set.go).

Tracks which validators voted for which BlockID, detects +2/3
majorities, and surfaces conflicting votes as equivocation evidence.
Thread-safe: the consensus state machine and gossip goroutines both
read it.  Its lock is ``utils/sync``'s ``Mutex()`` and the class is
``@guarded`` (the lock-order, deadlock and race modes, armed by
``sync.configure``); ``add_vote`` is a trust-guard sink and ``_verify``
a validator (``utils/trustguard``), as in the reference.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

from cometbft_tpu_torch.types.block import (
    BLOCK_ID_FLAG_ABSENT,
    BlockID,
    Commit,
    CommitSig,
    NIL_BLOCK_ID,
)
from cometbft_tpu_torch.types.canonical import PRECOMMIT_TYPE, PREVOTE_TYPE
from cometbft_tpu_torch.types.validator import ValidatorSet
from cometbft_tpu_torch.types.vote import Vote
from cometbft_tpu_torch.utils.bit_array import BitArray
from cometbft_tpu_torch.utils import sync as cmtsync
from cometbft_tpu_torch.utils import trustguard


class VoteSetError(Exception):
    pass


class ConflictingVoteError(VoteSetError):
    """Equivocation: same validator, same (h, r, type), different block.
    Carries both votes for the evidence pool (types/vote_set.go:219)."""

    def __init__(self, existing: Vote, conflicting: Vote):
        super().__init__("conflicting votes from validator")
        self.vote_a = existing
        self.vote_b = conflicting


@dataclass
class _BlockVotes:
    peer_maj23: bool
    bit_array: BitArray
    votes: list[Vote | None]
    sum: int


@cmtsync.guarded
class VoteSet:

    _GUARDED_BY = {
        "_votes_bit_array": "_mtx",
        "_votes": "_mtx",
        "_sum": "_mtx",
        "_maj23": "_mtx",
        "_votes_by_block": "_mtx",
        "_peer_maj23s": "_mtx",
    }
    def __init__(
        self,
        chain_id: str,
        height: int,
        round_: int,
        signed_msg_type: int,
        val_set: ValidatorSet,
        extensions_enabled: bool = False,
    ):
        if height == 0:
            raise VoteSetError("cannot make VoteSet for height 0")
        self.chain_id = chain_id
        self.height = height
        self.round = round_
        self.signed_msg_type = signed_msg_type
        self.val_set = val_set
        self.extensions_enabled = extensions_enabled
        # guards _votes_bit_array, _votes, _sum, _maj23, _votes_by_block
        # and _peer_maj23s
        self._mtx = cmtsync.Mutex()
        n = len(val_set)
        self._votes_bit_array = BitArray(n)
        self._votes: list[Vote | None] = [None] * n
        self._sum = 0
        self._maj23: BlockID | None = None
        self._votes_by_block: dict[bytes, _BlockVotes] = {}
        self._peer_maj23s: dict[str, BlockID] = {}

    # -- adding votes --------------------------------------------------

    def add_vote(self, vote: Vote) -> bool:
        """Validate + add. Returns True if the vote was newly added.
        Raises ConflictingVoteError on equivocation (caller reports to
        the evidence pool, internal/consensus/state.go:2268)."""
        if vote is None:
            raise VoteSetError("nil vote")
        with self._mtx:
            return self._add_vote_locked(vote)

    def _add_vote_locked(self, vote: Vote) -> bool:  # holds _mtx
        val_idx = vote.validator_index
        if val_idx < 0:
            raise VoteSetError("vote has negative validator index")
        if (
            vote.height != self.height
            or vote.round != self.round
            or vote.type != self.signed_msg_type
        ):
            raise VoteSetError(
                f"expected {self.height}/{self.round}/{self.signed_msg_type}, "
                f"got {vote.height}/{vote.round}/{vote.type}"
            )
        val = self.val_set.get_by_index(val_idx)
        if val is None:
            raise VoteSetError(f"no validator at index {val_idx}")
        if val.address != vote.validator_address:
            raise VoteSetError("vote validator address/index mismatch")

        existing = self._votes[val_idx]
        if existing is not None:
            if existing.block_id == vote.block_id:
                return False  # duplicate
            # Only the first vote counts; a different block is equivocation
            # unless it matches a peer-claimed maj23 block (vote_set.go).
            blk_key = vote.block_id.key()
            bv = self._votes_by_block.get(blk_key)
            if bv is None or not bv.peer_maj23:
                self._verify(vote, val.pub_key)
                raise ConflictingVoteError(existing, vote)

        self._verify(vote, val.pub_key)
        trustguard.check_sink("vote_set.add_vote")

        if existing is None:
            self._votes[val_idx] = vote
            self._votes_bit_array.set_index(val_idx, True)
            self._sum += val.voting_power

        blk_key = vote.block_id.key()
        bv = self._votes_by_block.get(blk_key)
        if bv is None:
            bv = _BlockVotes(
                peer_maj23=False,
                bit_array=BitArray(len(self.val_set)),
                votes=[None] * len(self.val_set),
                sum=0,
            )
            self._votes_by_block[blk_key] = bv
        elif existing is not None and bv.votes[val_idx] is not None:
            return False  # already counted for this block
        bv.bit_array.set_index(val_idx, True)
        bv.votes[val_idx] = vote
        bv.sum += val.voting_power

        if (
            self._maj23 is None
            and bv.sum * 3 > self.val_set.total_voting_power() * 2
        ):
            self._maj23 = vote.block_id
        return True

    def _verify(self, vote: Vote, pub_key) -> None:
        """Signature checks on vote receipt — the SPECULATIVE verify
        plane: both the vote signature and (on extension-enabled
        non-nil precommits) the extension signature go to the verify
        queue as ONE batched submission, so concurrent gossip votes
        coalesce into device-sized batches and the verdicts land in
        the speculative-result cache — ``verify_commit`` at finalize
        is then mostly a cache hit instead of a synchronous full-set
        launch.  With no queue installed, ``verify_or_fallback``
        degrades to the exact per-call ``verify_signature`` path this
        method always had; error precedence is unchanged either way
        (vote signature first, then extension shape, then extension
        signature)."""
        from cometbft_tpu_torch.crypto import verify_queue as _vq

        ext_slot = (
            self.extensions_enabled
            and self.signed_msg_type == PRECOMMIT_TYPE
            and not vote.is_nil()
        )
        items = [
            (pub_key, vote.sign_bytes(self.chain_id), vote.signature)
        ]
        if ext_slot and vote.extension_signature:
            items.append((
                pub_key,
                vote.extension_sign_bytes(self.chain_id),
                vote.extension_signature,
            ))
        results = _vq.verify_or_fallback(items)
        if not results[0]:
            raise VoteSetError("invalid vote signature")
        if not ext_slot:
            # extensions ride ONLY non-nil precommits (vote.go
            # ValidateBasic): a nil/prevote extension is never
            # signature-checked, so accepting one would hand the app
            # attacker-controlled unverified bytes downstream
            if vote.extension or vote.extension_signature:
                raise VoteSetError(
                    "vote extension on a nil vote or prevote"
                )
            trustguard.note_validated("VoteSet._verify")
            return
        if not vote.extension_signature:
            raise VoteSetError("missing vote extension signature")
        if not results[1]:
            raise VoteSetError("invalid vote extension signature")
        trustguard.note_validated("VoteSet._verify")

    def set_peer_maj23(self, peer_id: str, block_id: BlockID) -> None:
        """A peer claims +2/3 for block_id (anti-entropy, vote_set.go:
        SetPeerMaj23); unlocks acceptance of conflicting votes for it."""
        with self._mtx:
            if peer_id in self._peer_maj23s:
                return
            self._peer_maj23s[peer_id] = block_id
            key = block_id.key()
            bv = self._votes_by_block.get(key)
            if bv is None:
                bv = _BlockVotes(
                    peer_maj23=True,
                    bit_array=BitArray(len(self.val_set)),
                    votes=[None] * len(self.val_set),
                    sum=0,
                )
                self._votes_by_block[key] = bv
            else:
                bv.peer_maj23 = True

    # -- queries -------------------------------------------------------

    def bit_array(self) -> BitArray:
        with self._mtx:
            return self._votes_bit_array.copy()

    def bit_array_by_block_id(self, block_id: BlockID) -> BitArray | None:
        with self._mtx:
            bv = self._votes_by_block.get(block_id.key())
            return bv.bit_array.copy() if bv else None

    def get_by_index(self, idx: int) -> Vote | None:
        with self._mtx:
            return self._votes[idx] if 0 <= idx < len(self._votes) else None

    def get_by_address(self, addr: bytes) -> Vote | None:
        idx, _ = self.val_set.get_by_address(addr)
        return self.get_by_index(idx) if idx >= 0 else None

    def has_two_thirds_majority(self) -> bool:
        with self._mtx:
            return self._maj23 is not None

    def two_thirds_majority(self) -> BlockID | None:
        with self._mtx:
            return self._maj23

    def has_two_thirds_any(self) -> bool:
        with self._mtx:
            return self._sum * 3 > self.val_set.total_voting_power() * 2

    def has_all(self) -> bool:
        with self._mtx:
            return self._sum == self.val_set.total_voting_power()

    def sum_voting_power(self) -> int:
        with self._mtx:
            return self._sum

    def votes(self) -> list[Vote | None]:
        with self._mtx:
            return list(self._votes)

    # -- commit construction -------------------------------------------

    def make_commit(self) -> Commit:
        """Build a Commit from +2/3 precommits (vote_set.go MakeExtended
        Commit/MakeCommit)."""
        if self.signed_msg_type != PRECOMMIT_TYPE:
            raise VoteSetError("cannot make commit from non-precommit set")
        with self._mtx:
            if self._maj23 is None or self._maj23.is_nil():
                raise VoteSetError("no +2/3 majority for a block")
            sigs = []
            for vote in self._votes:
                if vote is None:
                    sigs.append(CommitSig(block_id_flag=BLOCK_ID_FLAG_ABSENT))
                    continue
                sig = vote.commit_sig()
                # votes for a block other than maj23 are excluded as
                # absent (vote_set.go MakeCommit); nil votes stay NIL
                if sig.is_commit() and vote.block_id != self._maj23:
                    sigs.append(CommitSig(block_id_flag=BLOCK_ID_FLAG_ABSENT))
                else:
                    sigs.append(sig)
            return Commit(
                height=self.height,
                round=self.round,
                block_id=self._maj23,
                signatures=tuple(sigs),
            )

    def __repr__(self) -> str:
        return (
            f"VoteSet(h={self.height} r={self.round} t={self.signed_msg_type} "
            f"sum={self._sum})"  # unguarded: repr snapshot, int read can't tear
        )


def vote_set_for_prevote(chain_id, height, round_, val_set) -> VoteSet:
    return VoteSet(chain_id, height, round_, PREVOTE_TYPE, val_set)


def vote_set_for_precommit(chain_id, height, round_, val_set) -> VoteSet:
    return VoteSet(chain_id, height, round_, PRECOMMIT_TYPE, val_set)
