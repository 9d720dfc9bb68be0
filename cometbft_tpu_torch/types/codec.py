"""Wire codec for composite types (block/commit/evidence encode+decode;
a copy of cometbft_tpu/types/codec.py).

A deterministic protobuf-wire encoding mirroring the shape of the
reference's proto/cometbft/types messages; used for block parts, the
block store, and p2p payloads.  It is also how state crosses from the
reference to the port in the parity tests: decoding the reference's
bytes and encoding again gives the same bytes back.
"""

from __future__ import annotations

from cometbft_tpu_torch.types import canonical
from cometbft_tpu_torch.types.block import (
    Block,
    BlockID,
    Commit,
    CommitSig,
    Data,
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


# -- evidence ----------------------------------------------------------

def encode_evidence(ev) -> bytes:
    from cometbft_tpu_torch.types.evidence import (
        DuplicateVoteEvidence,
        LightClientAttackEvidence,
    )

    w = ProtoWriter()
    if isinstance(ev, DuplicateVoteEvidence):
        inner = ProtoWriter()
        inner.message(1, ev.vote_a.encode())
        inner.message(2, ev.vote_b.encode())
        inner.varint(3, ev.total_voting_power)
        inner.varint(4, ev.validator_power)
        inner.message(5, canonical.encode_timestamp(ev.timestamp_ns))
        w.message(1, inner.finish())
    elif isinstance(ev, LightClientAttackEvidence):
        inner = ProtoWriter()
        inner.message(1, ev.conflicting_block.encode())
        inner.varint(3, ev.common_height)
        for addr in ev.byzantine_validators:
            inner.bytes_(4, addr)
        inner.varint(5, ev.total_voting_power)
        inner.message(6, canonical.encode_timestamp(ev.timestamp_ns))
        w.message(2, inner.finish())
    else:
        raise TypeError(f"unknown evidence type {type(ev).__name__}")
    return w.finish()


def decode_evidence(data: bytes):
    from cometbft_tpu_torch.types.evidence import (
        DuplicateVoteEvidence,
        LightClientAttackEvidence,
    )
    from cometbft_tpu_torch.types.vote import Vote

    f = ProtoReader(data).to_dict()
    if 1 in f:
        ef = ProtoReader(_bz(f[1][0])).to_dict()
        return DuplicateVoteEvidence(
            vote_a=Vote.decode(_bz(ef[1][0])),
            vote_b=Vote.decode(_bz(ef[2][0])),
            total_voting_power=s64(ef.get(3, [0])[0]),
            validator_power=s64(ef.get(4, [0])[0]),
            timestamp_ns=decode_timestamp(_bz(ef[5][0])) if 5 in ef else 0,
        )
    if 2 in f:
        from cometbft_tpu_torch.types.light_block import LightBlock

        ef = ProtoReader(_bz(f[2][0])).to_dict()
        if 1 not in ef:
            raise ValueError("light client attack evidence missing block")
        return LightClientAttackEvidence(
            conflicting_block=LightBlock.decode(_bz(ef[1][0])),
            common_height=s64(ef.get(3, [0])[0]),
            byzantine_validators=tuple(_bz(a) for a in ef.get(4, [])),
            total_voting_power=s64(ef.get(5, [0])[0]),
            timestamp_ns=decode_timestamp(_bz(ef[6][0])) if 6 in ef else 0,
        )
    raise ValueError("unknown evidence encoding")


# -- block -------------------------------------------------------------

def encode_block(b: Block) -> bytes:
    w = ProtoWriter()
    w.message(1, encode_header(b.header))
    d = ProtoWriter()
    for tx in b.data.txs:
        d.bytes_(1, tx)
    w.message(2, d.finish())
    e = ProtoWriter()
    for ev in b.evidence:
        e.message(1, encode_evidence(ev))
    w.message(3, e.finish())
    if b.last_commit is not None:
        w.message(4, encode_commit(b.last_commit))
    return w.finish()


def decode_block(data: bytes) -> Block:
    f = ProtoReader(data).to_dict()
    header = decode_header(_bz(f[1][0]))
    txs: tuple[bytes, ...] = ()
    if 2 in f:
        df = ProtoReader(_bz(f[2][0])).to_dict()
        txs = tuple(_bz(t) for t in df.get(1, []))
    evidence = ()
    if 3 in f:
        ef = ProtoReader(_bz(f[3][0])).to_dict()
        evidence = tuple(decode_evidence(_bz(raw)) for raw in ef.get(1, []))
    last_commit = decode_commit(_bz(f[4][0])) if 4 in f else None
    return Block(
        header=header,
        data=Data(txs=txs),
        evidence=evidence,
        last_commit=last_commit,
    )


# -- parts + proofs ----------------------------------------------------

def encode_proof(p) -> bytes:
    w = ProtoWriter()
    w.varint(1, p.total)
    w.varint(2, p.index)
    w.bytes_(3, p.leaf_hash)
    for aunt in p.aunts:
        w.bytes_(4, aunt)
    return w.finish()


def decode_proof(data: bytes):
    from cometbft_tpu_torch.crypto.merkle import Proof

    f = ProtoReader(data).to_dict()
    return Proof(
        total=_iv(f.get(1, [0])[0]),
        index=_iv(f.get(2, [0])[0]),
        leaf_hash=_bz(f.get(3, [b""])[0]),
        aunts=[_bz(a) for a in f.get(4, [])],
    )


def encode_part(p) -> bytes:
    w = ProtoWriter()
    w.varint(1, p.index)
    w.bytes_(2, p.bytes)
    w.message(3, encode_proof(p.proof))
    return w.finish()


def decode_part(data: bytes):
    from cometbft_tpu_torch.types.part_set import Part

    f = ProtoReader(data).to_dict()
    return Part(
        index=_iv(f.get(1, [0])[0]),
        bytes=_bz(f.get(2, [b""])[0]),
        proof=decode_proof(_bz(f[3][0])),
    )
