"""Thread-safe bit vector (a copy of cometbft_tpu/utils/bit_array.py;
reference: internal/bits/bit_array.go:17).

Used for vote/part presence gossip: each peer advertises which votes or
block parts it has, and the gossip routines pick what to send from the
set difference.
"""

from __future__ import annotations

import random
import threading


class BitArray:
    def __init__(self, bits: int):
        if bits < 0:
            raise ValueError("negative bit count")
        self._bits = bits
        self._elems = bytearray((bits + 7) // 8)
        self._mtx = threading.Lock()

    @property
    def size(self) -> int:
        return self._bits

    def get_index(self, i: int) -> bool:
        with self._mtx:
            if i < 0 or i >= self._bits:
                return False
            return bool(self._elems[i // 8] & (1 << (i % 8)))

    def set_index(self, i: int, v: bool) -> bool:
        with self._mtx:
            if i < 0 or i >= self._bits:
                return False
            if v:
                self._elems[i // 8] |= 1 << (i % 8)
            else:
                self._elems[i // 8] &= ~(1 << (i % 8))
            return True

    def copy(self) -> "BitArray":
        out = BitArray(self._bits)
        with self._mtx:
            out._elems = bytearray(self._elems)
        return out

    def _masked(self) -> bytearray:
        """Internal elems with trailing bits beyond size zeroed."""
        elems = bytearray(self._elems)
        extra = len(elems) * 8 - self._bits
        if extra and elems:
            elems[-1] &= 0xFF >> extra
        return elems

    def or_(self, other: "BitArray") -> "BitArray":
        """Union; result size is max(sizes) (bit_array.go Or)."""
        out = BitArray(max(self._bits, other._bits))
        with self._mtx:
            a = self._masked()
        with other._mtx:
            b = other._masked()
        for i in range(len(out._elems)):
            av = a[i] if i < len(a) else 0
            bv = b[i] if i < len(b) else 0
            out._elems[i] = av | bv
        return out

    def and_(self, other: "BitArray") -> "BitArray":
        out = BitArray(min(self._bits, other._bits))
        with self._mtx:
            a = self._masked()
        with other._mtx:
            b = other._masked()
        for i in range(len(out._elems)):
            out._elems[i] = a[i] & b[i]
        return out

    def not_(self) -> "BitArray":
        out = BitArray(self._bits)
        with self._mtx:
            for i in range(len(self._elems)):
                out._elems[i] = ~self._elems[i] & 0xFF
        return out

    def sub(self, other: "BitArray") -> "BitArray":
        """Bits set in self but not in other (bit_array.go Sub)."""
        out = BitArray(self._bits)
        with self._mtx:
            a = self._masked()
        with other._mtx:
            b = other._masked()
        for i in range(len(out._elems)):
            bv = b[i] if i < len(b) else 0
            out._elems[i] = a[i] & ~bv & 0xFF
        return out

    def is_empty(self) -> bool:
        with self._mtx:
            return not any(self._masked())

    def is_full(self) -> bool:
        with self._mtx:
            elems = self._masked()
        for i in range(self._bits):
            if not (elems[i // 8] & (1 << (i % 8))):
                return False
        return True

    def true_indices(self) -> list[int]:
        with self._mtx:
            elems = self._masked()
        return [
            i for i in range(self._bits) if elems[i // 8] & (1 << (i % 8))
        ]

    def pick_random(self, rng: random.Random | None = None) -> tuple[int, bool]:
        """A uniformly random set bit, or (0, False) when empty
        (bit_array.go PickRandom — used by pickVoteToSend)."""
        trues = self.true_indices()
        if not trues:
            return 0, False
        r = rng or random
        return r.choice(trues), True

    def to_bytes(self) -> bytes:
        with self._mtx:
            return bytes(self._masked())

    @classmethod
    def from_bytes(cls, bits: int, data: bytes) -> "BitArray":
        out = cls(bits)
        n = min(len(out._elems), len(data))
        out._elems[:n] = data[:n]
        out._elems = bytearray(out._masked())
        return out

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, BitArray):
            return NotImplemented
        return self._bits == other._bits and self.to_bytes() == other.to_bytes()

    def __repr__(self) -> str:
        bits = "".join(
            "x" if self.get_index(i) else "_" for i in range(min(self._bits, 64))
        )
        return f"BA{{{self._bits}:{bits}}}"
