"""Trusted light-block store (a copy of cometbft_tpu/light/store.py;
reference: light/store/db/db.go).  Keys are the height, big-endian, so
``first``, ``latest``, ``light_block_before`` and ``prune`` read heights
in order."""

from __future__ import annotations


from cometbft_tpu_torch.types.light_block import LightBlock
from cometbft_tpu_torch.utils.db import DB
from cometbft_tpu_torch.utils import sync as cmtsync

_PREFIX = b"lb/"


def _key(height: int) -> bytes:
    return _PREFIX + height.to_bytes(8, "big")


class LightStore:
    """(light/store/store.go Store iface, db implementation)"""

    def __init__(self, db: DB):
        self.db = db
        self._mtx = cmtsync.Mutex()

    def save(self, lb: LightBlock) -> None:
        with self._mtx:
            self.db.set(_key(lb.height), lb.encode())

    def get(self, height: int) -> LightBlock | None:
        raw = self.db.get(_key(height))
        return LightBlock.decode(bytes(raw)) if raw is not None else None

    def latest(self) -> LightBlock | None:
        """(db.go LastLightBlockHeight) — one reverse-range step."""
        with self._mtx:
            for _, raw in self.db.reverse_iterator(
                _PREFIX, _key(1 << 62)
            ):
                return LightBlock.decode(bytes(raw))
        return None

    def first(self) -> LightBlock | None:
        with self._mtx:
            for _, raw in self.db.prefix_iterator(_PREFIX):
                return LightBlock.decode(bytes(raw))
        return None

    def light_block_before(self, height: int) -> LightBlock | None:
        """Largest stored height strictly below ``height`` — one
        reverse-range step (db.go LightBlockBefore)."""
        with self._mtx:
            for _, raw in self.db.reverse_iterator(_PREFIX, _key(height)):
                return LightBlock.decode(bytes(raw))
        return None

    def delete(self, height: int) -> None:
        with self._mtx:
            self.db.delete(_key(height))

    def prune(self, keep: int) -> int:
        """Drop oldest blocks beyond ``keep`` (db.go Prune)."""
        with self._mtx:
            keys = [k for k, _ in self.db.prefix_iterator(_PREFIX)]
            excess = len(keys) - keep
            for k in keys[: max(excess, 0)]:
                self.db.delete(k)
            return max(excess, 0)

    def size(self) -> int:
        with self._mtx:
            return sum(1 for _ in self.db.prefix_iterator(_PREFIX))


__all__ = ["LightStore"]
