"""Statesync wire messages (a copy of cometbft_tpu/statesync/messages.py;
reference: statesync/messages.go, proto/cometbft/statesync/v1/types.proto).

Two channels (statesync/reactor.go:23-25): 0x60 carries snapshot
discovery, 0x61 carries chunk transfer.
"""

from __future__ import annotations

from dataclasses import dataclass

from cometbft_tpu_torch.utils.protoio import ProtoReader, ProtoWriter
from cometbft_tpu_torch.types.codec import as_bytes as _bz, as_int as _iv

SNAPSHOT_CHANNEL = 0x60
CHUNK_CHANNEL = 0x61

_F_SNAPSHOTS_REQUEST = 1
_F_SNAPSHOTS_RESPONSE = 2
_F_CHUNK_REQUEST = 3
_F_CHUNK_RESPONSE = 4


@dataclass(frozen=True)
class SnapshotsRequest:
    pass


@dataclass(frozen=True)
class SnapshotsResponse:
    height: int
    format: int
    chunks: int
    hash: bytes
    metadata: bytes = b""


@dataclass(frozen=True)
class ChunkRequest:
    height: int
    format: int
    index: int


@dataclass(frozen=True)
class ChunkResponse:
    height: int
    format: int
    index: int
    chunk: bytes = b""
    missing: bool = False


def encode_ss_message(msg) -> bytes:
    w = ProtoWriter()
    if isinstance(msg, SnapshotsRequest):
        w.message(_F_SNAPSHOTS_REQUEST, b"")
    elif isinstance(msg, SnapshotsResponse):
        m = ProtoWriter()
        m.varint(1, msg.height)
        m.varint(2, msg.format)
        m.varint(3, msg.chunks)
        m.bytes_(4, msg.hash)
        m.bytes_(5, msg.metadata)
        w.message(_F_SNAPSHOTS_RESPONSE, m.finish())
    elif isinstance(msg, ChunkRequest):
        m = ProtoWriter()
        m.varint(1, msg.height)
        m.varint(2, msg.format)
        m.varint(3, msg.index)
        w.message(_F_CHUNK_REQUEST, m.finish())
    elif isinstance(msg, ChunkResponse):
        m = ProtoWriter()
        m.varint(1, msg.height)
        m.varint(2, msg.format)
        m.varint(3, msg.index)
        m.bytes_(4, msg.chunk)
        m.bool_(5, msg.missing)
        w.message(_F_CHUNK_RESPONSE, m.finish())
    else:
        raise TypeError(f"unknown statesync message {type(msg)}")
    return w.finish()


def decode_ss_message(data: bytes):
    f = ProtoReader(data).to_dict()
    if _F_SNAPSHOTS_REQUEST in f:
        return SnapshotsRequest()
    if _F_SNAPSHOTS_RESPONSE in f:
        m = ProtoReader(_bz(f[_F_SNAPSHOTS_RESPONSE][0])).to_dict()
        return SnapshotsResponse(
            height=_iv(m.get(1, [0])[0]),
            format=_iv(m.get(2, [0])[0]),
            chunks=_iv(m.get(3, [0])[0]),
            hash=_bz(m.get(4, [b""])[0]),
            metadata=_bz(m.get(5, [b""])[0]),
        )
    if _F_CHUNK_REQUEST in f:
        m = ProtoReader(_bz(f[_F_CHUNK_REQUEST][0])).to_dict()
        return ChunkRequest(
            height=_iv(m.get(1, [0])[0]),
            format=_iv(m.get(2, [0])[0]),
            index=_iv(m.get(3, [0])[0]),
        )
    if _F_CHUNK_RESPONSE in f:
        m = ProtoReader(_bz(f[_F_CHUNK_RESPONSE][0])).to_dict()
        return ChunkResponse(
            height=_iv(m.get(1, [0])[0]),
            format=_iv(m.get(2, [0])[0]),
            index=_iv(m.get(3, [0])[0]),
            chunk=_bz(m.get(4, [b""])[0]),
            missing=bool(m.get(5, [0])[0]),
        )
    raise ValueError("unknown statesync message")


__all__ = [
    "CHUNK_CHANNEL",
    "ChunkRequest",
    "ChunkResponse",
    "SNAPSHOT_CHANNEL",
    "SnapshotsRequest",
    "SnapshotsResponse",
    "decode_ss_message",
    "encode_ss_message",
]
