"""Consensus write-ahead log, the parts consensus reads (a part of
cometbft_tpu/wal/__init__.py: 31-63 and 206-236; reference:
internal/consensus/wal.go).

The record kinds, ``WALRecord`` (a decoded TimedWALMessage) and the
disabled WAL, ``NopWAL``, which the consensus state writes to before it
handles every input.  The file WAL on its autofile group
(``wal/autofile.py``), its record framing and its replay search come
with the WAL item: until then a consensus node keeps no log, and a
restart recovers through the Handshaker alone.
"""

from __future__ import annotations

from dataclasses import dataclass

# Tagged record kinds (wal.go WALMessage union members)
KIND_END_HEIGHT = 1
KIND_MSG_INFO = 2
KIND_TIMEOUT = 3
# the reference's CMT_TPU_DETERMINISM=1 extension: a per-height
# transition digest written right after the height's end-height marker
KIND_TRANSITION_DIGEST = 4


class WALError(Exception):
    pass


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
    "WALError",
    "WALRecord",
]
