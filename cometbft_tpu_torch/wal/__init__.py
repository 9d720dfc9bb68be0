"""Consensus write-ahead log (a copy of cometbft_tpu/wal/__init__.py;
reference: internal/consensus/wal.go).

Every consensus input is logged BEFORE it is processed (the
WAL-before-process invariant, SURVEY.md §7 hard part (b)); on restart
the tail of the log is replayed to reconstruct the in-flight height.

Record framing (wal.go WALEncoder): ``crc32(payload) | len | payload``
with both fixed32 big-endian, payload being a TimedWALMessage — a
timestamp plus a tagged message body.  The body encoding is owned by
the consensus layer; the WAL sees ``(kind, data)`` pairs, except the
height-boundary marker (``EndHeightMessage``, wal.go:85) which the WAL
understands natively so it can seek to a height without consensus
involvement (``search_for_end_height``, wal.go SearchForEndHeight).

The port writes the reference's bytes: the same records with the same
times give byte-equal files, and each package reads the other's.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

import time

from cometbft_tpu_torch.utils.flight import FLIGHT
from cometbft_tpu_torch.utils.protoio import (
    ProtoReader,
    ProtoWriter,
    sfixed64_from_u64,
)
from cometbft_tpu_torch.utils.service import BaseService
from cometbft_tpu_torch.utils.time import now_ns
from cometbft_tpu_torch.utils.trace import TRACER
from cometbft_tpu_torch.wal.autofile import Group

# Tagged record kinds (wal.go WALMessage union members)
KIND_END_HEIGHT = 1
KIND_MSG_INFO = 2
KIND_TIMEOUT = 3
# the determinism guard's record: a per-height transition digest
# (state/determinism.py TransitionDigest) written right after the
# height's end-height marker; replay recomputes and compares it.
KIND_TRANSITION_DIGEST = 4

MAX_MSG_SIZE_BYTES = 2 * 1024 * 1024


class WALError(Exception):
    pass


class WALCorruptionError(WALError):
    """A record failed CRC/length checks mid-stream (wal.go DataCorruption)."""


@dataclass(frozen=True)
class WALRecord:
    """Decoded TimedWALMessage (wal.go:36)."""

    time_ns: int
    kind: int
    data: bytes

    @property
    def end_height(self) -> int:
        if self.kind != KIND_END_HEIGHT:
            raise WALError("not an end-height record")
        return int.from_bytes(self.data, "big")


def encode_record(rec: WALRecord) -> bytes:
    w = ProtoWriter()
    w.sfixed64(1, rec.time_ns)
    w.varint(2, rec.kind)
    w.bytes_(3, rec.data)
    payload = w.finish()
    if len(payload) > MAX_MSG_SIZE_BYTES:
        raise WALError(f"wal message too big: {len(payload)} bytes")
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    return struct.pack(">II", crc, len(payload)) + payload


def decode_records(
    data: bytes, allow_torn_tail: bool = True
) -> list[WALRecord]:
    """Decode a record stream.  A torn final record (crash mid-write) is
    tolerated; corruption before the tail raises (wal.go WALDecoder)."""

    out: list[WALRecord] = []
    off = 0
    n = len(data)
    while off < n:
        if off + 8 > n:
            if allow_torn_tail:
                break
            raise WALCorruptionError("truncated record header")
        crc, length = struct.unpack_from(">II", data, off)
        if length > MAX_MSG_SIZE_BYTES:
            raise WALCorruptionError(f"record length {length} too large")
        if off + 8 + length > n:
            if allow_torn_tail:
                break
            raise WALCorruptionError("truncated record payload")
        payload = data[off + 8 : off + 8 + length]
        if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
            if allow_torn_tail and off + 8 + length == n:
                break  # torn final record
            raise WALCorruptionError("crc mismatch")
        f = ProtoReader(payload).to_dict()
        out.append(
            WALRecord(
                time_ns=sfixed64_from_u64(int(f.get(1, [0])[0])),
                kind=int(f.get(2, [0])[0]),
                data=bytes(f.get(3, [b""])[0]),
            )
        )
        off += 8 + length
    return out


class WAL(BaseService):
    """File-backed WAL on an autofile group (wal.go BaseWAL)."""

    def __init__(
        self,
        path: str,
        head_size_limit: int = 10 * 1024 * 1024,
        total_size_limit: int = 1024 * 1024 * 1024,
        metrics=None,
    ):
        super().__init__(name="WAL")
        from cometbft_tpu_torch.metrics import WALMetrics

        self.metrics = metrics if metrics is not None else WALMetrics()
        self._group = Group(
            path,
            head_size_limit=head_size_limit,
            total_size_limit=total_size_limit,
        )

    # -- writes ----------------------------------------------------------

    def write(self, kind: int, data: bytes) -> None:
        """Buffered write — used for peer messages (wal.go Write)."""
        if not self.is_running():
            return
        rec = WALRecord(time_ns=now_ns(), kind=kind, data=data)
        framed = encode_record(rec)
        self._group.write(framed)
        self.metrics.write_bytes.inc(len(framed))
        FLIGHT.record("wal_write", rec_kind=kind, bytes=len(framed))

    def _sync(self) -> None:
        """fsync the head, timed (the replication plane's disk-latency
        tripwire: a slow fsync here IS commit latency)."""
        t0 = time.perf_counter()
        self._group.sync()  # blocking ok: wal_fsync — this IS the stage; fsync_duration_seconds times it
        elapsed = time.perf_counter() - t0
        self.metrics.fsync_duration_seconds.observe(elapsed)
        FLIGHT.record("wal_fsync", ms=round(elapsed * 1e3, 3))

    def write_sync(self, kind: int, data: bytes) -> None:
        """Write + fsync — used for our OWN messages (votes, proposals),
        so a crash cannot forget something we already signed
        (wal.go WriteSync)."""
        if not self.is_running():
            return
        self.write(kind, data)
        self._sync()

    def write_end_height(self, height: int) -> None:
        """Height-boundary marker; fsynced (wal.go:85 EndHeightMessage)."""
        if not self.is_running():
            return
        with TRACER.span("wal/write_end_height", cat="wal", height=height):
            self.write_sync(KIND_END_HEIGHT, height.to_bytes(8, "big"))
            if self._group.maybe_rotate():
                self.metrics.rotations.inc()
                FLIGHT.record("wal_rotate", height=height)

    def flush_and_sync(self) -> None:
        self._sync()

    # -- reads -----------------------------------------------------------

    def records(self) -> list[WALRecord]:
        return decode_records(self._group.read_all())

    def search_for_end_height(self, height: int) -> list[WALRecord] | None:
        """Records logged AFTER the end-height marker of ``height`` —
        i.e. the in-flight inputs of height+1 (wal.go SearchForEndHeight).
        None if the marker is absent (the WAL predates that height or
        was pruned)."""
        recs = self.records()
        found_at = None
        for i, rec in enumerate(recs):
            if rec.kind == KIND_END_HEIGHT and rec.end_height == height:
                found_at = i
        if found_at is None:
            return None
        return recs[found_at + 1 :]

    # -- lifecycle -------------------------------------------------------

    def on_start(self) -> None:
        pass

    def on_stop(self) -> None:
        self._group.close()


class NopWAL:
    """Disabled WAL (wal.go nilWAL) — statesync'd nodes and tests."""

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass

    def is_running(self) -> bool:
        return True

    def write(self, kind: int, data: bytes) -> None:
        pass

    def write_sync(self, kind: int, data: bytes) -> None:
        pass

    def write_end_height(self, height: int) -> None:
        pass

    def flush_and_sync(self) -> None:
        pass

    def records(self) -> list[WALRecord]:
        return []

    def search_for_end_height(self, height: int) -> list[WALRecord] | None:
        return None


__all__ = [
    "KIND_END_HEIGHT",
    "KIND_MSG_INFO",
    "KIND_TIMEOUT",
    "KIND_TRANSITION_DIGEST",
    "NopWAL",
    "WAL",
    "WALCorruptionError",
    "WALError",
    "WALRecord",
    "decode_records",
    "encode_record",
]
