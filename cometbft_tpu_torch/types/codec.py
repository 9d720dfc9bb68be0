"""Wire codec for composite types: the header and commit part of
cometbft_tpu/types/codec.py (its lines 28-173), copied.

A deterministic protobuf-wire encoding mirroring the shape of the
reference's proto/cometbft/types messages.  It is how state crosses
from the reference to the port: ``decode_commit`` and ``decode_header``
take the reference's bytes, and re-encoding gives the same bytes back.
The evidence, block, proof and part codecs are not ported yet.
"""

from __future__ import annotations

from cometbft_tpu_torch.types import canonical
from cometbft_tpu_torch.types.block import (
    BlockID,
    Commit,
    CommitSig,
    Header,
    PartSetHeader,
)
from cometbft_tpu_torch.utils.protoio import (
    ProtoReader,
    ProtoWriter,
    int64_from_varint,
)


def s64(v) -> int:
    """Wire value -> signed int64 (varint or fixed64 payloads)."""
    if not isinstance(v, int):
        raise CodecError("expected varint, got length-delimited field")
    return int64_from_varint(v)


class CodecError(ValueError):
    """Malformed wire bytes (typed: decoders must never surface
    OverflowError/MemoryError from bytes(huge_varint) — fuzz-found)."""


def _bz(v) -> bytes:
    """Wire value -> bytes; a varint here would make bytes(n) try to
    allocate n zero bytes (OverflowError/MemoryError DoS)."""
    if not isinstance(v, (bytes, bytearray, memoryview)):
        raise CodecError("expected length-delimited field, got varint")
    return bytes(v)


def _iv(v) -> int:
    if not isinstance(v, int):
        raise CodecError("expected varint, got length-delimited field")
    return v


# public names for other modules' decoders
as_bytes = _bz
as_int = _iv


def decode_timestamp(data: bytes) -> int:
    f = ProtoReader(data).to_dict()
    sec = s64(f.get(1, [0])[0])
    nanos = _iv(f.get(2, [0])[0])
    return sec * 1_000_000_000 + nanos


def decode_part_set_header(data: bytes) -> PartSetHeader:
    f = ProtoReader(data).to_dict()
    return PartSetHeader(
        total=_iv(f.get(1, [0])[0]), hash=_bz(f.get(2, [b""])[0])
    )


def decode_block_id(data: bytes) -> BlockID:
    f = ProtoReader(data).to_dict()
    return BlockID(
        hash=_bz(f.get(1, [b""])[0]),
        part_set_header=(
            decode_part_set_header(_bz(f[2][0])) if 2 in f else PartSetHeader()
        ),
    )


# -- header ------------------------------------------------------------

def encode_header(h: Header) -> bytes:
    w = ProtoWriter()
    ver = ProtoWriter()
    ver.varint(1, h.version_block)
    ver.varint(2, h.version_app)
    w.message(1, ver.finish())
    w.string(2, h.chain_id)
    w.varint(3, h.height)
    w.message(4, canonical.encode_timestamp(h.time_ns))
    w.message(5, h.last_block_id.encode())
    w.bytes_(6, h.last_commit_hash)
    w.bytes_(7, h.data_hash)
    w.bytes_(8, h.validators_hash)
    w.bytes_(9, h.next_validators_hash)
    w.bytes_(10, h.consensus_hash)
    w.bytes_(11, h.app_hash)
    w.bytes_(12, h.last_results_hash)
    w.bytes_(13, h.evidence_hash)
    w.bytes_(14, h.proposer_address)
    return w.finish()


def decode_header(data: bytes) -> Header:
    f = ProtoReader(data).to_dict()
    vb, va = 0, 0
    if 1 in f:
        vf = ProtoReader(_bz(f[1][0])).to_dict()
        vb = _iv(vf.get(1, [0])[0])
        va = _iv(vf.get(2, [0])[0])
    return Header(
        version_block=vb,
        version_app=va,
        chain_id=_bz(f.get(2, [b""])[0]).decode("utf-8"),
        height=s64(f.get(3, [0])[0]),
        time_ns=decode_timestamp(_bz(f[4][0])) if 4 in f else 0,
        last_block_id=decode_block_id(_bz(f[5][0])) if 5 in f else BlockID(),
        last_commit_hash=_bz(f.get(6, [b""])[0]),
        data_hash=_bz(f.get(7, [b""])[0]),
        validators_hash=_bz(f.get(8, [b""])[0]),
        next_validators_hash=_bz(f.get(9, [b""])[0]),
        consensus_hash=_bz(f.get(10, [b""])[0]),
        app_hash=_bz(f.get(11, [b""])[0]),
        last_results_hash=_bz(f.get(12, [b""])[0]),
        evidence_hash=_bz(f.get(13, [b""])[0]),
        proposer_address=_bz(f.get(14, [b""])[0]),
    )


# -- commit ------------------------------------------------------------

def encode_commit(c: Commit) -> bytes:
    w = ProtoWriter()
    w.varint(1, c.height)
    w.varint(2, c.round)
    w.message(3, c.block_id.encode())
    for cs in c.signatures:
        w.message(4, cs.encode())
    if c.agg_signature:
        # field 5: the commit-level BLS aggregate (types/block.py
        # Commit docstring); omitted entirely for per-signature
        # commits so their wire bytes are unchanged
        w.bytes_(5, c.agg_signature)
    return w.finish()


def decode_commit(data: bytes) -> Commit:
    f = ProtoReader(data).to_dict()
    sigs = []
    for raw in f.get(4, []):
        sf = ProtoReader(_bz(raw)).to_dict()
        sigs.append(
            CommitSig(
                block_id_flag=_iv(sf.get(1, [0])[0]),
                validator_address=_bz(sf.get(2, [b""])[0]),
                timestamp_ns=decode_timestamp(_bz(sf[3][0])) if 3 in sf else 0,
                signature=_bz(sf.get(4, [b""])[0]),
            )
        )
    return Commit(
        height=s64(f.get(1, [0])[0]),
        round=_iv(f.get(2, [0])[0]),
        block_id=decode_block_id(_bz(f[3][0])) if 3 in f else BlockID(),
        signatures=tuple(sigs),
        agg_signature=_bz(f.get(5, [b""])[0]),
    )
