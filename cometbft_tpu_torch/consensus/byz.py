"""Byzantine-behavior injection (a copy of cometbft_tpu/consensus/byz.py).

A real adversary inside a real node, not a mocked message: an
equivocating validator whose duplicate votes land as committed
evidence, a proposer that smuggles a forged ``stx:`` envelope into a
block (which every honest ``process_proposal`` must refuse), and a
gossiper that corrupts block parts on the wire.  The modes::

    equivocate | forge_stx | corrupt_parts

Where the port departs from its reference: the mode is an argument,
``Byz(mode)``, not the process-wide ``CMT_TPU_BYZ`` read once at node
assembly.  A node's ``BlockExecutor(byz=...)`` holds its adversary;
``ConsensusState`` reads the executor's, and
``ConsensusReactor`` registers its vote-channel broadcast with the
consensus state's.  An unarmed ``Byz()`` (every node's default) makes
each hook a no-op: one attribute read per call.  So one port node of a
network in one process can misbehave while the others stay honest.

The behaviors, honestly stated:

- **equivocate** — after the node signs a real precommit, sign a
  second precommit for a flipped block hash with the RAW key (the
  FilePV double-sign guard refuses, exactly as designed — a byzantine
  validator bypasses its own safety layer) and broadcast it straight
  onto the vote channel.  It cannot ride normal vote gossip: gossip
  picks from vote sets, and a node's own conflict never enters its
  set.  Honest peers hit ``ConflictingVoteError`` →
  ``report_conflicting_votes`` → DuplicateVoteEvidence → committed.
  Once per height, so evidence stays bounded.
- **forge_stx** — append one forged signed-tx envelope (real pubkey,
  signature by a DIFFERENT key: parses clean, verifies false) to
  every block this node proposes.  Only the app-level admission check
  in ``process_proposal`` can catch it — and must.
- **corrupt_parts** — flip a byte in every 4th block part this node
  gossips.  The receiver's merkle-proof check rejects the part; the
  sender still marks it delivered, so recovery must come from honest
  gossip.
"""

from __future__ import annotations

from dataclasses import replace as dc_replace

from cometbft_tpu_torch.utils import sync as cmtsync

BYZ_MODES = ("equivocate", "forge_stx", "corrupt_parts")

#: payload of the forged envelope (kvstore-executable shape, so IF a
#: forged block ever committed, the poison would be visible in state)
_FORGED_PAYLOAD = b"byz_forged=1"


class Byz:
    """One node's adversary; unarmed (``mode=None``) by default."""

    def __init__(self, mode: str | None = None):
        if mode is not None and mode not in BYZ_MODES:
            raise ValueError(
                f"byzantine mode must be one of {BYZ_MODES} or None, "
                f"got {mode!r}"
            )
        self.mode = mode
        self._mtx = cmtsync.Mutex()
        self._broadcast = None  # raw-bytes vote-channel broadcast
        self._equivocated_h = 0  # highest height already equivocated
        self._part_counter = 0

    def register_broadcast(self, fn) -> None:
        """Reactor start: the vote-channel raw broadcast the
        equivocator needs (gossip can't carry a self-conflict)."""
        self._broadcast = fn

    # -- hooks (each a no-op unless its mode is armed) -------------------

    def maybe_equivocate(self, vote, priv_validator, chain_id) -> None:
        """consensus/state._sign_add_vote: emit the conflicting twin
        of a just-signed non-nil precommit."""
        if self.mode != "equivocate" or vote is None:
            return
        try:
            from cometbft_tpu_torch.consensus.messages import (
                VoteMessage,
                encode_message,
            )
            from cometbft_tpu_torch.types.block import BlockID
            from cometbft_tpu_torch.types.canonical import PRECOMMIT_TYPE
            from cometbft_tpu_torch.types.part_set import PartSetHeader

            if vote.type != PRECOMMIT_TYPE or not vote.block_id.hash:
                return
            with self._mtx:
                if vote.height <= self._equivocated_h:
                    return
                self._equivocated_h = vote.height
            if self._broadcast is None:
                return
            fake = bytes(b ^ 0xFF for b in vote.block_id.hash)
            evil = dc_replace(
                vote,
                block_id=BlockID(
                    hash=fake,
                    part_set_header=PartSetHeader(
                        total=1, hash=fake[::-1]
                    ),
                ),
                signature=b"",
            )
            # the FilePV double-sign guard would refuse (that guard
            # working is half the point) — a byzantine validator signs
            # with the raw key underneath it
            evil = dc_replace(
                evil,
                signature=priv_validator._priv_key.sign(
                    evil.sign_bytes(chain_id)
                ),
            )
            self._broadcast(encode_message(VoteMessage(vote=evil)))
        except Exception:  # noqa: BLE001 — the adversary never crashes its host
            pass

    def maybe_forge_stx(self, txs: tuple) -> tuple:
        """state/execution.create_proposal_block: smuggle a forged
        envelope into the proposed tx list."""
        if self.mode != "forge_stx":
            return txs
        try:
            from cometbft_tpu_torch.crypto import ed25519 as ed
            from cometbft_tpu_torch.mempool.ingest import (
                SIGNED_TX_PREFIX,
                sign_bytes,
            )

            claimed = ed.priv_key_from_secret(b"byz-claimed-identity")
            actual = ed.priv_key_from_secret(b"byz-actual-signer")
            forged = (
                SIGNED_TX_PREFIX
                + claimed.pub_key().bytes().hex().encode()
                + actual.sign(sign_bytes(_FORGED_PAYLOAD)).hex().encode()
                + b":"
                + _FORGED_PAYLOAD
            )
            return txs + (forged,)
        except Exception:  # noqa: BLE001
            return txs

    def maybe_corrupt_part(self, part):
        """consensus/reactor block-part gossip: flip one byte in every
        4th part sent (merkle proof catches it at the receiver)."""
        if self.mode != "corrupt_parts" or part is None:
            return part
        try:
            with self._mtx:
                self._part_counter += 1
                if self._part_counter % 4 != 0:
                    return part
            if not part.bytes:
                return part
            data = bytearray(part.bytes)
            data[0] ^= 0xFF
            return dc_replace(part, bytes=bytes(data))
        except Exception:  # noqa: BLE001
            return part


__all__ = ["BYZ_MODES", "Byz"]
