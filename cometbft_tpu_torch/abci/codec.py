"""ABCI wire codec for the messages state execution stores (a part of
cometbft_tpu/abci/codec.py; reference: proto/cometbft/abci/v1/types.proto).

Declarative per-type field specs drive a small generic encoder, as in
the reference, but only for the messages this port encodes:
``ExecTxResult`` (``Header.last_results_hash`` hashes its deterministic
part; ``EventDataTx`` carries it) and ``FinalizeBlockResponse`` (the
state store persists it per height), with what they hold: ``Event``,
``EventAttribute``, ``ValidatorUpdate``, the nested ``ConsensusParams``
and ``google.protobuf.Duration``.  The bytes are the reference's: field
numbers of the upstream proto, integers as plain varints with 64-bit
two's complement for negatives (proto3 int64, not zigzag), zero values
omitted.  The request/response envelopes, the socket server and client
and gRPC come with the node.
"""

from __future__ import annotations

from cometbft_tpu_torch.abci import types as T
from cometbft_tpu_torch.utils.protoio import ProtoReader, ProtoWriter, int64_from_varint


class AbciCodecError(ValueError):
    pass


def _f(no: int, attr: str, kind: str, cls=None):
    return (no, attr, kind, cls)


# Spec: type -> [(field_no, attr, kind, nested_cls)]
# kinds: str, bytes, int (plain proto3 varint, two's complement), bool,
#        dur (google.protobuf.Duration), params (ConsensusParams msg),
#        rep_msg
_SPEC: dict[type, list] = {
    T.EventAttribute: [
        _f(1, "key", "str"),
        _f(2, "value", "str"),
        _f(3, "index", "bool"),
    ],
    T.Event: [
        _f(1, "type", "str"),
        _f(2, "attributes", "rep_msg", T.EventAttribute),
    ],
    T.ValidatorUpdate: [
        # field 1 reserved upstream (legacy pub_key)
        _f(2, "power", "int"),
        _f(3, "pub_key_bytes", "bytes"),
        _f(4, "pub_key_type", "str"),
    ],
    T.ExecTxResult: [
        _f(1, "code", "int"),
        _f(2, "data", "bytes"),
        _f(3, "log", "str"),
        _f(4, "info", "str"),
        _f(5, "gas_wanted", "int"),
        _f(6, "gas_used", "int"),
        _f(7, "events", "rep_msg", T.Event),
        _f(8, "codespace", "str"),
    ],
    T.FinalizeBlockResponse: [
        _f(1, "events", "rep_msg", T.Event),
        _f(2, "tx_results", "rep_msg", T.ExecTxResult),
        _f(3, "validator_updates", "rep_msg", T.ValidatorUpdate),
        _f(4, "consensus_param_updates", "params"),
        _f(5, "app_hash", "bytes"),
        _f(6, "next_block_delay_ns", "dur"),
    ],
}


def _encode_duration(ns: int) -> bytes:
    """google.protobuf.Duration: seconds(1) int64 + nanos(2) int32."""
    w = ProtoWriter()
    w.varint(1, (ns // 1_000_000_000) & 0xFFFFFFFFFFFFFFFF)
    w.varint(2, ns % 1_000_000_000)
    return w.finish()


def _decode_duration(raw: bytes) -> int:
    f = ProtoReader(bytes(raw)).to_dict()
    sec = int64_from_varint(int(f.get(1, [0])[0]))
    return sec * 1_000_000_000 + int(f.get(2, [0])[0])


def _encode_i64_value(v: int) -> bytes:
    """google.protobuf.Int64Value wrapper: value(1)."""
    w = ProtoWriter()
    w.varint(1, v & 0xFFFFFFFFFFFFFFFF)
    return w.finish()


def _decode_i64_value(raw: bytes) -> int:
    f = ProtoReader(bytes(raw)).to_dict()
    return int64_from_varint(int(f.get(1, [0])[0]))


def _encode_params(params) -> bytes:
    """cometbft.types.v1.ConsensusParams (params.proto:14): block(1),
    evidence(2), validator(3), version(4, not tracked — omitted),
    synchrony(6), feature(7)."""
    w = ProtoWriter()
    b = ProtoWriter()
    b.varint(1, params.block.max_bytes & 0xFFFFFFFFFFFFFFFF)
    b.varint(2, params.block.max_gas & 0xFFFFFFFFFFFFFFFF)
    w.message(1, b.finish())
    e = ProtoWriter()
    e.varint(1, params.evidence.max_age_num_blocks)
    e.message(2, _encode_duration(params.evidence.max_age_duration_ns))
    e.varint(3, params.evidence.max_bytes)
    w.message(2, e.finish())
    v = ProtoWriter()
    for t in params.validator.pub_key_types:
        v.string(1, t)
    w.message(3, v.finish())
    sy = ProtoWriter()
    sy.message(1, _encode_duration(params.synchrony.precision_ns))
    sy.message(2, _encode_duration(params.synchrony.message_delay_ns))
    w.message(6, sy.finish())
    fe = ProtoWriter()
    if params.feature.vote_extensions_enable_height > 0:
        fe.message(
            1, _encode_i64_value(params.feature.vote_extensions_enable_height)
        )
    if params.feature.pbts_enable_height > 0:
        fe.message(2, _encode_i64_value(params.feature.pbts_enable_height))
    w.message(7, fe.finish())
    return w.finish()


def _decode_params(raw: bytes):
    from cometbft_tpu_torch.types.params import (
        BlockParams,
        ConsensusParams,
        EvidenceParams,
        FeatureParams,
        SynchronyParams,
        ValidatorParams,
    )

    s64 = int64_from_varint
    f = ProtoReader(bytes(raw)).to_dict()
    block, evidence = BlockParams(), EvidenceParams()
    validator, synchrony = ValidatorParams(), SynchronyParams()
    feature = FeatureParams()
    if 1 in f:
        bf = ProtoReader(_as_bytes(f[1][0])).to_dict()
        block = BlockParams(
            max_bytes=s64(int(bf.get(1, [0])[0])),
            max_gas=s64(int(bf.get(2, [0])[0])),
        )
    if 2 in f:
        ef = ProtoReader(_as_bytes(f[2][0])).to_dict()
        evidence = EvidenceParams(
            max_age_num_blocks=s64(int(ef.get(1, [0])[0])),
            max_age_duration_ns=(
                _decode_duration(_as_bytes(ef[2][0])) if 2 in ef else 0
            ),
            max_bytes=s64(int(ef.get(3, [0])[0])),
        )
    if 3 in f:
        vf = ProtoReader(_as_bytes(f[3][0])).to_dict()
        validator = ValidatorParams(
            pub_key_types=tuple(
                _as_bytes(t).decode() for t in vf.get(1, [])
            )
        )
    if 6 in f:
        sf = ProtoReader(_as_bytes(f[6][0])).to_dict()
        synchrony = SynchronyParams(
            precision_ns=(
                _decode_duration(_as_bytes(sf[1][0])) if 1 in sf else 0
            ),
            message_delay_ns=(
                _decode_duration(_as_bytes(sf[2][0])) if 2 in sf else 0
            ),
        )
    if 7 in f:
        ff = ProtoReader(_as_bytes(f[7][0])).to_dict()
        feature = FeatureParams(
            vote_extensions_enable_height=(
                _decode_i64_value(_as_bytes(ff[1][0])) if 1 in ff else 0
            ),
            pbts_enable_height=(
                _decode_i64_value(_as_bytes(ff[2][0])) if 2 in ff else 0
            ),
        )
    return ConsensusParams(
        block=block,
        evidence=evidence,
        validator=validator,
        synchrony=synchrony,
        feature=feature,
    )


def encode_msg(obj) -> bytes:
    spec = _SPEC.get(type(obj))
    if spec is None:
        raise AbciCodecError(f"no wire spec for {type(obj).__name__}")
    w = ProtoWriter()
    for no, attr, kind, _ in spec:
        v = getattr(obj, attr)
        if kind == "str":
            w.string(no, v)
        elif kind == "bytes":
            w.bytes_(no, bytes(v))
        elif kind == "int":
            # proto3 int64/uint64/uint32: plain varint, negatives as
            # 64-bit two's complement (ProtoWriter omits zero)
            w.varint(no, int(v) & 0xFFFFFFFFFFFFFFFF)
        elif kind == "bool":
            w.varint(no, 1 if v else 0)
        elif kind == "dur":
            if v:
                w.message(no, _encode_duration(int(v)))
        elif kind == "params":
            if v is not None:
                w.message(no, _encode_params(v))
        elif kind == "rep_msg":
            for item in v:
                w.message(no, encode_msg(item))
        else:  # pragma: no cover
            raise AbciCodecError(f"unknown kind {kind}")
    return w.finish()


def _as_bytes(v) -> bytes:
    """Wire value -> bytes, rejecting type confusion: a varint/fixed
    value where a length-delimited field is expected must error, not be
    reinterpreted (bytes(huge_int) would allocate huge_int ZEROS — a
    decoder DoS found by fuzzing)."""
    if not isinstance(v, (bytes, bytearray, memoryview)):
        raise AbciCodecError(
            f"expected length-delimited field, got {type(v).__name__}"
        )
    return bytes(v)


def decode_msg(cls: type, raw: bytes):
    spec = _SPEC.get(cls)
    if spec is None:
        raise AbciCodecError(f"no wire spec for {cls.__name__}")
    try:
        f = ProtoReader(bytes(raw)).to_dict()
    except Exception as exc:
        raise AbciCodecError(f"malformed {cls.__name__}: {exc}") from exc
    kwargs = {}
    for no, attr, kind, sub in spec:
        vals = f.get(no)
        try:
            if kind == "str":
                kwargs[attr] = (
                    _as_bytes(vals[0]).decode() if vals else ""
                )
            elif kind == "bytes":
                kwargs[attr] = _as_bytes(vals[0]) if vals else b""
            elif kind == "int":
                kwargs[attr] = int64_from_varint(int(vals[0])) if vals else 0
            elif kind == "bool":
                kwargs[attr] = bool(vals[0]) if vals else False
            elif kind == "dur":
                kwargs[attr] = (
                    _decode_duration(_as_bytes(vals[0])) if vals else 0
                )
            elif kind == "params":
                kwargs[attr] = (
                    _decode_params(_as_bytes(vals[0])) if vals else None
                )
            elif kind == "rep_msg":
                kwargs[attr] = tuple(
                    decode_msg(sub, _as_bytes(v)) for v in (vals or [])
                )
        except AbciCodecError:
            raise
        except Exception as exc:
            raise AbciCodecError(
                f"malformed {cls.__name__}.{attr}: {exc}"
            ) from exc
    return cls(**kwargs)


__all__ = ["AbciCodecError", "decode_msg", "encode_msg"]
