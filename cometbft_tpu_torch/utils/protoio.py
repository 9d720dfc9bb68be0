"""Deterministic protobuf wire-format writer/reader (a copy of
cometbft_tpu/utils/protoio.py).

The consensus-critical encodings (vote sign-bytes, header fields, wire
messages) must be byte-deterministic. The reference relies on gogoproto
marshalling (types/canonical.go:57, libs/protoio); here we implement the
wire format directly — fields are always emitted in ascending field-number
order with no unknown fields, which makes determinism a construction-time
property instead of a library promise.

Wire types: 0 varint, 1 fixed64, 2 length-delimited, 5 fixed32.
"""

from __future__ import annotations

import struct
from typing import Iterator


# single-byte varints (field keys, small lengths, counts) dominate the
# call profile — the QA campaign measured 1.29M encode_uvarint calls in
# a 60 s saturation run, almost all < 0x80 — so they come from a table
_UV1 = [bytes([i]) for i in range(0x80)]


def encode_uvarint(n: int) -> bytes:
    if n < 0x80:
        if n < 0:
            raise ValueError("uvarint must be non-negative")
        return _UV1[n]
    out = bytearray()
    while n > 0x7F:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def decode_uvarint(buf: bytes, offset: int = 0) -> tuple[int, int]:
    """Returns (value, next_offset)."""
    result = 0
    shift = 0
    while True:
        if offset >= len(buf):
            raise ValueError("truncated uvarint")
        b = buf[offset]
        offset += 1
        # Reject 64-bit overflow before accumulating (binary.Uvarint parity:
        # at most 10 bytes, and the 10th byte may only contribute bit 63).
        if shift > 63 or (shift == 63 and (b & 0x7F) > 1):
            raise ValueError("uvarint overflows 64 bits")
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, offset
        shift += 7


def read_uvarint_from(read_exact, max_value: int = 1 << 63) -> int:
    """Decode a uvarint from a stream via ``read_exact(1)`` calls,
    rejecting values above ``max_value`` before any allocation happens.
    Shared by the p2p transport and MConnection packet reader so
    length-cap enforcement lives in one place."""
    result, shift = 0, 0
    while True:
        b = read_exact(1)[0]
        if shift > 63:
            raise ValueError("uvarint overflows 64 bits")
        result |= (b & 0x7F) << shift
        if result > max_value:
            raise ValueError(f"uvarint {result} exceeds cap {max_value}")
        if not (b & 0x80):
            return result
        shift += 7


def _zigzag(n: int) -> int:
    return (n << 1) ^ (n >> 63) if n < 0 else n << 1


def _unzigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


class ProtoWriter:
    """Appends protobuf fields; caller must emit in ascending tag order."""

    def __init__(self) -> None:
        self._buf = bytearray()

    def _key(self, field: int, wire_type: int) -> None:
        key = (field << 3) | wire_type
        # fields <= 15 (every message here) key in one table byte
        self._buf += _UV1[key] if key < 0x80 else encode_uvarint(key)

    def varint(self, field: int, value: int) -> None:
        """int32/int64/uint64/bool/enum. Negative ints use two's complement
        64-bit (protobuf int64 semantics)."""
        if value == 0:
            return
        self._key(field, 0)
        self._buf += encode_uvarint(value & 0xFFFFFFFFFFFFFFFF)

    def svarint(self, field: int, value: int) -> None:
        """sint64 (zigzag)."""
        if value == 0:
            return
        self._key(field, 0)
        self._buf += encode_uvarint(_zigzag(value))

    def bool_(self, field: int, value: bool) -> None:
        self.varint(field, 1 if value else 0)

    def sfixed64(self, field: int, value: int) -> None:
        if value == 0:
            return
        self._key(field, 1)
        self._buf += struct.pack("<q", value)

    def fixed64(self, field: int, value: int) -> None:
        if value == 0:
            return
        self._key(field, 1)
        self._buf += struct.pack("<Q", value)

    def bytes_(self, field: int, value: bytes) -> None:
        if not value:
            return
        self._key(field, 2)
        self._buf += encode_uvarint(len(value))
        self._buf += value

    def string(self, field: int, value: str) -> None:
        self.bytes_(field, value.encode("utf-8"))

    def message(self, field: int, value: bytes | None) -> None:
        """Embedded message; ``None`` omits, ``b''`` emits an empty message
        (proto3 presence for message fields)."""
        if value is None:
            return
        self._key(field, 2)
        self._buf += encode_uvarint(len(value))
        self._buf += value

    def finish(self) -> bytes:
        return bytes(self._buf)


def length_prefixed(payload: bytes) -> bytes:
    """Length-delimited framing used for sign-bytes and wire I/O
    (reference: libs/protoio delimited writer; types/vote.go:151)."""
    return encode_uvarint(len(payload)) + payload


def read_length_prefixed(buf: bytes, offset: int = 0) -> tuple[bytes, int]:
    n, offset = decode_uvarint(buf, offset)
    if offset + n > len(buf):
        raise ValueError("truncated length-prefixed payload")
    return buf[offset : offset + n], offset + n


class ProtoReader:
    """Minimal field iterator for decoding our own messages."""

    def __init__(self, buf: bytes):
        self.buf = buf

    def fields(self) -> Iterator[tuple[int, int, int | bytes]]:
        """Yields (field_number, wire_type, value)."""
        buf, off = self.buf, 0
        while off < len(buf):
            key, off = decode_uvarint(buf, off)
            field, wt = key >> 3, key & 7
            if field == 0:
                # proto3 field numbers start at 1; rejecting 0 also cuts
                # off degenerate all-zero buffers immediately
                raise ValueError("invalid field number 0")
            if wt == 0:
                val, off = decode_uvarint(buf, off)
                yield field, wt, val
            elif wt == 1:
                if off + 8 > len(buf):
                    raise ValueError("truncated fixed64")
                yield field, wt, struct.unpack_from("<Q", buf, off)[0]
                off += 8
            elif wt == 2:
                ln, off = decode_uvarint(buf, off)
                if off + ln > len(buf):
                    raise ValueError("truncated bytes field")
                yield field, wt, buf[off : off + ln]
                off += ln
            elif wt == 5:
                if off + 4 > len(buf):
                    raise ValueError("truncated fixed32")
                yield field, wt, struct.unpack_from("<I", buf, off)[0]
                off += 4
            else:
                raise ValueError(f"unsupported wire type {wt}")

    def to_dict(self) -> dict[int, list[int | bytes]]:
        out: dict[int, list[int | bytes]] = {}
        for field, _, val in self.fields():
            out.setdefault(field, []).append(val)
        return out


def sfixed64_from_u64(v: int) -> int:
    return struct.unpack("<q", struct.pack("<Q", v))[0]


def int64_from_varint(v: int) -> int:
    return sfixed64_from_u64(v & 0xFFFFFFFFFFFFFFFF)
