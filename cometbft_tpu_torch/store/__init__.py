"""Block store — part-based persistent block storage (a copy of
cometbft_tpu/store/__init__.py; reference: store/store.go:46,
store/db_key_layout.go).

Blocks are saved as their gossip part-sets plus a BlockMeta per height,
the canonical commit for height H (inside block H+1's storage path in
the reference; here keyed directly), and the "seen commit" (the +2/3
precommits this node itself observed, which may differ in round).

The store locks with ``utils/sync``'s ``RMutex()`` (the class is
``@guarded``), and ``save_block`` is a trust-guard sink, as in the
reference.
"""

from __future__ import annotations

import threading
import time

from cometbft_tpu_torch.utils.flight import FLIGHT
from cometbft_tpu_torch.utils.trace import TRACER

from cometbft_tpu_torch.types import codec
from cometbft_tpu_torch.types.block import Block, Commit
from cometbft_tpu_torch.types.block_meta import BlockMeta
from cometbft_tpu_torch.types.part_set import Part, PartSet
from cometbft_tpu_torch.utils.db import DB
from cometbft_tpu_torch.utils.protoio import ProtoReader, ProtoWriter
from cometbft_tpu_torch.utils import sync as cmtsync
from cometbft_tpu_torch.utils import trustguard

# Key layout (store/db_key_layout.go v1): prefix + big-endian height so
# range iteration walks heights in order.
_META = b"H:"
_PART = b"P:"
_COMMIT = b"C:"
_SEEN_COMMIT = b"SC:"
_SEEN_EXT_VOTES = b"SEV:"
_EXT_COMMIT = b"EC:"
_HASH = b"BH:"
_STATE_KEY = b"blockStore"


def _hkey(prefix: bytes, height: int) -> bytes:
    return prefix + height.to_bytes(8, "big")


def _pkey(height: int, index: int) -> bytes:
    return _PART + height.to_bytes(8, "big") + index.to_bytes(4, "big")


class BlockStoreError(Exception):
    pass


@cmtsync.guarded
class BlockStore:
    """Contiguous range [base, height] of blocks (store/store.go:37-46).
    ``_base`` and ``_height`` are read and written under ``_mtx``."""

    _GUARDED_BY = {"_base": "_mtx", "_height": "_mtx"}

    def __init__(self, db: DB, metrics=None):
        from cometbft_tpu_torch.metrics import StoreMetrics

        self._db = db
        self.metrics = metrics if metrics is not None else StoreMetrics()
        self._mtx = cmtsync.RMutex()
        self._base, self._height = self._load_state()

    # -- range ---------------------------------------------------------

    def _load_state(self) -> tuple[int, int]:
        raw = self._db.get(_STATE_KEY)
        if raw is None:
            return 0, 0
        f = ProtoReader(raw).to_dict()
        return int(f.get(1, [0])[0]), int(f.get(2, [0])[0])

    def _save_state_ops(self) -> tuple[bytes, bytes]:  # holds _mtx
        w = ProtoWriter()
        w.varint(1, self._base)
        w.varint(2, self._height)
        return _STATE_KEY, w.finish()

    def base(self) -> int:
        with self._mtx:
            return self._base

    def height(self) -> int:
        with self._mtx:
            return self._height

    def size(self) -> int:
        with self._mtx:
            return 0 if self._height == 0 else self._height - self._base + 1

    # -- loads ---------------------------------------------------------

    def load_block_meta(self, height: int) -> BlockMeta | None:
        raw = self._db.get(_hkey(_META, height))
        return BlockMeta.decode(raw) if raw is not None else None

    def load_block(self, height: int) -> Block | None:
        t0 = time.perf_counter()
        meta = self.load_block_meta(height)
        if meta is None:
            return None
        buf = bytearray()
        for i in range(meta.block_id.part_set_header.total):
            part = self.load_block_part(height, i)
            if part is None:
                raise BlockStoreError(
                    f"missing part {i} of block {height}"
                )
            buf += part.bytes
        block = codec.decode_block(bytes(buf))
        self.metrics.block_load_seconds.observe(time.perf_counter() - t0)
        return block

    def load_block_by_hash(self, block_hash: bytes) -> Block | None:
        raw = self._db.get(_HASH + block_hash)
        if raw is None:
            return None
        return self.load_block(int.from_bytes(raw, "big"))

    def load_block_part(self, height: int, index: int) -> Part | None:
        raw = self._db.get(_pkey(height, index))
        return codec.decode_part(raw) if raw is not None else None

    def load_block_commit(self, height: int) -> Commit | None:
        """The canonical commit for block at ``height`` (carried in the
        child block's LastCommit, store/store.go LoadBlockCommit)."""
        raw = self._db.get(_hkey(_COMMIT, height))
        return codec.decode_commit(raw) if raw is not None else None

    def load_seen_commit(self, height: int) -> Commit | None:
        raw = self._db.get(_hkey(_SEEN_COMMIT, height))
        return codec.decode_commit(raw) if raw is not None else None

    # -- saves ---------------------------------------------------------

    def save_block(
        self, block: Block, part_set: PartSet, seen_commit: Commit,
        extended_votes=None,
    ) -> None:
        """Atomically persist block parts + meta + commits — and, when
        given, the precommit votes with their vote extensions IN THE
        SAME BATCH (store/store.go SaveBlock /
        SaveBlockWithExtendedCommit: a crash between the two writes
        would silently lose the extensions the height+1 proposer
        needs)."""
        if block is None or not part_set.is_complete():
            raise BlockStoreError("cannot save incomplete block")
        trustguard.check_sink("store.save_block")
        height = block.header.height
        with self._mtx, TRACER.span(
            "store/save_block", cat="store", height=height
        ):
            # timer starts INSIDE the lock (and the span enters after
            # it): the histogram measures the write batch, not
            # contention on _mtx
            t0 = time.perf_counter()
            expected = self._height + 1 if self._height > 0 else height
            if height != expected:
                raise BlockStoreError(
                    f"cannot save block {height}, expected {expected}"
                )
            meta = BlockMeta.from_parts(block, part_set)
            ops: list[tuple[bytes, bytes | None]] = [
                (_hkey(_META, height), meta.encode()),
                (_HASH + block.hash(), height.to_bytes(8, "big")),
                (_hkey(_SEEN_COMMIT, height), codec.encode_commit(seen_commit)),
            ]
            if extended_votes is not None:
                ops.append(
                    (
                        _hkey(_SEEN_EXT_VOTES, height),
                        self._encode_extended_votes(extended_votes),
                    )
                )
            for i in range(part_set.header.total):
                part = part_set.get_part(i)
                ops.append((_pkey(height, i), codec.encode_part(part)))
            if block.last_commit is not None:
                ops.append(
                    (
                        _hkey(_COMMIT, height - 1),
                        codec.encode_commit(block.last_commit),
                    )
                )
            prev_base, prev_height = self._base, self._height
            self._height = height
            if self._base == 0:
                self._base = height
            ops.append(self._save_state_ops())
            try:
                self._db.write_batch(ops)
            except BaseException:
                self._base, self._height = prev_base, prev_height
                raise
        self.metrics.block_save_seconds.observe(time.perf_counter() - t0)
        FLIGHT.record(
            "store_save", height=height, parts=part_set.header.total
        )

    def save_seen_commit(self, height: int, commit: Commit) -> None:
        self._db.set(_hkey(_SEEN_COMMIT, height), codec.encode_commit(commit))

    @staticmethod
    def _encode_extended_votes(votes) -> bytes:
        """Length-prefixed Vote encodings; absent votes are empty
        entries so validator-index alignment survives."""
        from cometbft_tpu_torch.utils.protoio import length_prefixed

        return b"".join(
            length_prefixed(v.encode() if v is not None else b"")
            for v in votes
        )

    def save_seen_extended_votes(self, height: int, votes) -> None:
        """Persist the precommit votes WITH their vote extensions for
        ``height`` (blocksync's path; consensus saves them atomically
        inside save_block)."""
        self._db.set(
            _hkey(_SEEN_EXT_VOTES, height),
            self._encode_extended_votes(votes),
        )

    @staticmethod
    def decode_extended_votes(raw: bytes):
        """Inverse of _encode_extended_votes (also used to decode the
        blob ferried in blocksync block responses)."""
        from cometbft_tpu_torch.types.vote import Vote
        from cometbft_tpu_torch.utils.protoio import read_length_prefixed

        votes, off, raw = [], 0, bytes(raw)
        while off < len(raw):
            payload, off = read_length_prefixed(raw, off)
            votes.append(Vote.decode(payload) if payload else None)
        return votes

    def load_seen_extended_votes_raw(self, height: int) -> bytes | None:
        raw = self._db.get(_hkey(_SEEN_EXT_VOTES, height))
        return bytes(raw) if raw is not None else None

    def load_seen_extended_votes(self, height: int):
        """Inverse of save_seen_extended_votes; None when unset."""
        raw = self.load_seen_extended_votes_raw(height)
        if raw is None:
            return None
        return self.decode_extended_votes(raw)

    # -- pruning -------------------------------------------------------

    def prune_last_block(self) -> None:
        """Delete the newest block — the `rollback --hard` path
        (store/store.go DeleteLatestBlock)."""
        with self._mtx:
            h = self._height
            if h == 0:
                raise BlockStoreError("block store is empty")
            meta = self.load_block_meta(h)
            ops: list[tuple[bytes, bytes | None]] = [
                (_hkey(_META, h), None),
                (_hkey(_COMMIT, h), None),
                (_hkey(_COMMIT, h - 1), None),
                (_hkey(_SEEN_COMMIT, h), None),
                (_hkey(_SEEN_EXT_VOTES, h), None),
            ]
            if meta is not None:
                ops.append((_HASH + meta.block_id.hash, None))
                for i in range(meta.block_id.part_set_header.total):
                    ops.append((_pkey(h, i), None))
            prev_base, prev_height = self._base, self._height
            self._height = h - 1
            if self._height < self._base:
                self._base = self._height
            ops.append(self._save_state_ops())
            try:
                self._db.write_batch(ops)
            except BaseException:
                self._base, self._height = prev_base, prev_height
                raise

    def prune_blocks(self, retain_height: int) -> int:
        """Remove blocks below ``retain_height``; returns count pruned
        (store/store.go PruneBlocks)."""
        with self._mtx:
            t0 = time.perf_counter()  # batch time, not lock-wait
            if retain_height <= self._base:
                return 0
            if retain_height > self._height:
                raise BlockStoreError(
                    f"cannot prune beyond height {self._height}"
                )
            pruned = 0
            ops: list[tuple[bytes, bytes | None]] = []
            for h in range(self._base, retain_height):
                meta = self.load_block_meta(h)
                if meta is None:
                    continue
                ops.append((_hkey(_META, h), None))
                ops.append((_HASH + meta.block_id.hash, None))
                ops.append((_hkey(_COMMIT, h), None))
                ops.append((_hkey(_SEEN_COMMIT, h), None))
                ops.append((_hkey(_SEEN_EXT_VOTES, h), None))
                for i in range(meta.block_id.part_set_header.total):
                    ops.append((_pkey(h, i), None))
                pruned += 1
            prev_base = self._base
            self._base = retain_height
            ops.append(self._save_state_ops())
            try:
                self._db.write_batch(ops)
            except BaseException:
                self._base = prev_base
                raise
        self.metrics.block_prune_seconds.observe(time.perf_counter() - t0)
        FLIGHT.record(
            "store_prune", retain_height=retain_height, pruned=pruned
        )
        return pruned
