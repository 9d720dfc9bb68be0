"""ABCI wire codec — request/response envelopes for the socket protocol
(a copy of cometbft_tpu/abci/codec.py; reference:
proto/cometbft/abci/v1/types.proto Request/Response oneofs,
abci/server/socket_server.go framing).

Declarative per-type field specs drive a small generic encoder. The
encoding is proto3-faithful to the upstream ABCI surface: field numbers
match proto/cometbft/abci/v1/types.proto exactly (including reserved
gaps like CheckTxRequest.type=3 and CommitResponse.retain_height=3),
integers are plain varints with 64-bit two's complement for negatives
(proto3 int64 — not zigzag), timestamps/durations are nested
google.protobuf.Timestamp/Duration messages, ConsensusParams is the
nested cometbft.types.v1.ConsensusParams message, and zero values are
omitted — so external ABCI apps speaking the upstream protocol
interoperate on the wire (including QueryResponse.proof_ops as the
upstream ProofOps wrapper message).  The bytes are the reference's,
field for field, both ways (tests/test_torch_abci_remote.py).
"""

from __future__ import annotations

from dataclasses import dataclass

from cometbft_tpu_torch.abci import types as T
from cometbft_tpu_torch.utils.protoio import ProtoReader, ProtoWriter


class AbciCodecError(ValueError):
    pass


# -- field kinds --------------------------------------------------------

def _f(no: int, attr: str, kind: str, cls=None):
    return (no, attr, kind, cls)


# Spec: type -> [(field_no, attr, kind, nested_cls)]
# kinds: str, bytes, int (plain proto3 varint, two's complement), bool,
#        enum (plain varint), msg, time (google.protobuf.Timestamp),
#        dur (google.protobuf.Duration), params (ConsensusParams msg),
#        validator (nested Validator from (address, power) attr pair),
#        rep_bytes, rep_str, rep_int, rep_msg
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
    T.VoteInfo: [
        _f(1, ("validator_address", "validator_power"), "validator"),
        # field 2 reserved upstream (signed_last_block)
        _f(3, "block_id_flag", "int"),
    ],
    T.ExtendedVoteInfo: [
        _f(1, ("validator_address", "validator_power"), "validator"),
        _f(3, "vote_extension", "bytes"),
        _f(4, "extension_signature", "bytes"),
        _f(5, "block_id_flag", "int"),
    ],
    T.ExtendedCommitInfo: [
        _f(1, "round", "int"),
        _f(2, "votes", "rep_msg", T.ExtendedVoteInfo),
    ],
    T.CommitInfo: [
        _f(1, "round", "int"),
        _f(2, "votes", "rep_msg", T.VoteInfo),
    ],
    T.Misbehavior: [
        _f(1, "type", "int"),
        _f(2, ("validator_address", "validator_power"), "validator"),
        _f(3, "height", "int"),
        _f(4, "time_ns", "time"),
        _f(5, "total_voting_power", "int"),
    ],
    T.Snapshot: [
        _f(1, "height", "int"),
        _f(2, "format", "int"),
        _f(3, "chunks", "int"),
        _f(4, "hash", "bytes"),
        _f(5, "metadata", "bytes"),
    ],
    # requests
    T.InfoRequest: [
        _f(1, "version", "str"),
        _f(2, "block_version", "int"),
        _f(3, "p2p_version", "int"),
        _f(4, "abci_version", "str"),
    ],
    T.QueryRequest: [
        _f(1, "data", "bytes"),
        _f(2, "path", "str"),
        _f(3, "height", "int"),
        _f(4, "prove", "bool"),
    ],
    T.CheckTxRequest: [
        _f(1, "tx", "bytes"),
        # field 2 reserved upstream
        _f(3, "type", "int"),
    ],
    T.InitChainRequest: [
        _f(1, "time_ns", "time"),
        _f(2, "chain_id", "str"),
        _f(3, "consensus_params", "params"),
        _f(4, "validators", "rep_msg", T.ValidatorUpdate),
        _f(5, "app_state_bytes", "bytes"),
        _f(6, "initial_height", "int"),
    ],
    T.PrepareProposalRequest: [
        _f(1, "max_tx_bytes", "int"),
        _f(2, "txs", "rep_bytes"),
        _f(3, "local_last_commit", "msg", T.ExtendedCommitInfo),
        _f(4, "misbehavior", "rep_msg", T.Misbehavior),
        _f(5, "height", "int"),
        _f(6, "time_ns", "time"),
        _f(7, "next_validators_hash", "bytes"),
        _f(8, "proposer_address", "bytes"),
    ],
    T.ProcessProposalRequest: [
        _f(1, "txs", "rep_bytes"),
        _f(2, "proposed_last_commit", "msg", T.CommitInfo),
        _f(3, "misbehavior", "rep_msg", T.Misbehavior),
        _f(4, "hash", "bytes"),
        _f(5, "height", "int"),
        _f(6, "time_ns", "time"),
        _f(7, "next_validators_hash", "bytes"),
        _f(8, "proposer_address", "bytes"),
    ],
    T.ExtendVoteRequest: [
        # NOTE: the dataclass carries ``round`` for in-process apps, but
        # the upstream proto has no round field — the wire drops it.
        _f(1, "hash", "bytes"),
        _f(2, "height", "int"),
        _f(3, "time_ns", "time"),
        _f(4, "txs", "rep_bytes"),
        _f(5, "proposed_last_commit", "msg", T.CommitInfo),
        _f(6, "misbehavior", "rep_msg", T.Misbehavior),
        _f(7, "next_validators_hash", "bytes"),
        _f(8, "proposer_address", "bytes"),
    ],
    T.VerifyVoteExtensionRequest: [
        _f(1, "hash", "bytes"),
        _f(2, "validator_address", "bytes"),
        _f(3, "height", "int"),
        _f(4, "vote_extension", "bytes"),
    ],
    T.FinalizeBlockRequest: [
        _f(1, "txs", "rep_bytes"),
        _f(2, "decided_last_commit", "msg", T.CommitInfo),
        _f(3, "misbehavior", "rep_msg", T.Misbehavior),
        _f(4, "hash", "bytes"),
        _f(5, "height", "int"),
        _f(6, "time_ns", "time"),
        _f(7, "next_validators_hash", "bytes"),
        _f(8, "proposer_address", "bytes"),
        _f(9, "syncing_to_height", "int"),
    ],
    T.OfferSnapshotRequest: [
        _f(1, "snapshot", "msg", T.Snapshot),
        _f(2, "app_hash", "bytes"),
    ],
    T.LoadSnapshotChunkRequest: [
        _f(1, "height", "int"),
        _f(2, "format", "int"),
        _f(3, "chunk", "int"),
    ],
    T.ApplySnapshotChunkRequest: [
        _f(1, "index", "int"),
        _f(2, "chunk", "bytes"),
        _f(3, "sender", "str"),
    ],
    # responses
    T.InfoResponse: [
        _f(1, "data", "str"),
        _f(2, "version", "str"),
        _f(3, "app_version", "int"),
        _f(4, "last_block_height", "int"),
        _f(5, "last_block_app_hash", "bytes"),
    ],
    T.ProofOp: [
        _f(1, "type", "str"),
        _f(2, "key", "bytes"),
        _f(3, "data", "bytes"),
    ],
    T.QueryResponse: [
        _f(1, "code", "int"),
        # field 2 reserved upstream (data; use value)
        _f(3, "log", "str"),
        _f(4, "info", "str"),
        _f(5, "index", "int"),
        _f(6, "key", "bytes"),
        _f(7, "value", "bytes"),
        # ProofOps wrapper message: repeated ProofOp ops = 1
        _f(8, "proof_ops", "proofops"),
        _f(9, "height", "int"),
        _f(10, "codespace", "str"),
    ],
    T.CheckTxResponse: [
        _f(1, "code", "int"),
        _f(2, "data", "bytes"),
        _f(3, "log", "str"),
        _f(4, "info", "str"),
        _f(5, "gas_wanted", "int"),
        _f(6, "gas_used", "int"),
        _f(7, "events", "rep_msg", T.Event),
        _f(8, "codespace", "str"),
    ],
    T.InitChainResponse: [
        _f(1, "consensus_params", "params"),
        _f(2, "validators", "rep_msg", T.ValidatorUpdate),
        _f(3, "app_hash", "bytes"),
    ],
    T.PrepareProposalResponse: [
        _f(1, "txs", "rep_bytes"),
    ],
    T.ProcessProposalResponse: [
        _f(1, "status", "enum", T.ProposalStatus),
    ],
    T.ExtendVoteResponse: [
        _f(1, "vote_extension", "bytes"),
    ],
    T.VerifyVoteExtensionResponse: [
        _f(1, "status", "enum", T.VerifyStatus),
    ],
    T.FinalizeBlockResponse: [
        _f(1, "events", "rep_msg", T.Event),
        _f(2, "tx_results", "rep_msg", T.ExecTxResult),
        _f(3, "validator_updates", "rep_msg", T.ValidatorUpdate),
        _f(4, "consensus_param_updates", "params"),
        _f(5, "app_hash", "bytes"),
        _f(6, "next_block_delay_ns", "dur"),
    ],
    T.CommitResponse: [
        # fields 1-2 reserved upstream (legacy data)
        _f(3, "retain_height", "int"),
    ],
    T.ListSnapshotsResponse: [
        _f(1, "snapshots", "rep_msg", T.Snapshot),
    ],
    T.OfferSnapshotResponse: [
        _f(1, "result", "enum", T.OfferSnapshotResult),
    ],
    T.LoadSnapshotChunkResponse: [
        _f(1, "chunk", "bytes"),
    ],
    T.ApplySnapshotChunkResponse: [
        _f(1, "result", "enum", T.ApplySnapshotChunkResult),
        _f(2, "refetch_chunks", "rep_int"),
        _f(3, "reject_senders", "rep_str"),
    ],
}


def _encode_duration(ns: int) -> bytes:
    """google.protobuf.Duration: seconds(1) int64 + nanos(2) int32."""
    w = ProtoWriter()
    w.varint(1, (ns // 1_000_000_000) & 0xFFFFFFFFFFFFFFFF)
    w.varint(2, ns % 1_000_000_000)
    return w.finish()


def _decode_duration(raw: bytes) -> int:
    from cometbft_tpu_torch.utils.protoio import int64_from_varint

    f = ProtoReader(bytes(raw)).to_dict()
    sec = int64_from_varint(int(f.get(1, [0])[0]))
    return sec * 1_000_000_000 + int(f.get(2, [0])[0])


def _encode_i64_value(v: int) -> bytes:
    """google.protobuf.Int64Value wrapper: value(1)."""
    w = ProtoWriter()
    w.varint(1, v & 0xFFFFFFFFFFFFFFFF)
    return w.finish()


def _decode_i64_value(raw: bytes) -> int:
    from cometbft_tpu_torch.utils.protoio import int64_from_varint

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
    from cometbft_tpu_torch.utils.protoio import int64_from_varint as s64

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


def _encode_wire_validator(address: bytes, power: int) -> bytes:
    """abci Validator: address(1) bytes, power(3) int64."""
    w = ProtoWriter()
    w.bytes_(1, bytes(address))
    w.varint(3, power & 0xFFFFFFFFFFFFFFFF)
    return w.finish()


def encode_msg(obj) -> bytes:
    spec = _SPEC.get(type(obj))
    if spec is None:
        raise AbciCodecError(f"no wire spec for {type(obj).__name__}")
    w = ProtoWriter()
    for no, attr, kind, cls in spec:
        if kind == "validator":
            addr_attr, power_attr = attr
            w.message(
                no,
                _encode_wire_validator(
                    getattr(obj, addr_attr), getattr(obj, power_attr)
                ),
            )
            continue
        v = getattr(obj, attr)
        if kind == "str":
            w.string(no, v)
        elif kind == "bytes":
            w.bytes_(no, bytes(v))
        elif kind == "int" or kind == "enum":
            # proto3 int64/uint64/uint32/enum: plain varint, negatives
            # as 64-bit two's complement (ProtoWriter omits zero)
            w.varint(no, int(v) & 0xFFFFFFFFFFFFFFFF)
        elif kind == "bool":
            w.varint(no, 1 if v else 0)
        elif kind == "time":
            if v:
                from cometbft_tpu_torch.types import canonical as _canon

                w.message(no, _canon.encode_timestamp(int(v)))
        elif kind == "dur":
            if v:
                w.message(no, _encode_duration(int(v)))
        elif kind == "msg":
            if v is not None:
                w.message(no, encode_msg(v))
        elif kind == "params":
            if v is not None:
                w.message(no, _encode_params(v))
        elif kind == "proofops":
            if v:
                inner = ProtoWriter()
                for op in v:
                    inner.message(1, encode_msg(op))
                w.message(no, inner.finish())
        elif kind == "rep_bytes":
            for item in v:
                w.bytes_(no, bytes(item))
        elif kind == "rep_str":
            for item in v:
                w.string(no, item)
        elif kind == "rep_int":
            # proto3 canonical form for repeated scalars is PACKED:
            # one length-delimited field holding concatenated varints.
            if v:
                from cometbft_tpu_torch.utils.protoio import encode_uvarint

                w.bytes_(
                    no,
                    b"".join(
                        encode_uvarint(int(item) & 0xFFFFFFFFFFFFFFFF)
                        for item in v
                    ),
                )
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
    from cometbft_tpu_torch.types import codec as _tcodec
    from cometbft_tpu_torch.utils.protoio import int64_from_varint as _s64

    kwargs = {}
    for no, attr, kind, sub in spec:
        vals = f.get(no)
        try:
            if kind == "validator":
                addr_attr, power_attr = attr
                addr, power = b"", 0
                if vals:
                    vf = ProtoReader(_as_bytes(vals[0])).to_dict()
                    addr = _as_bytes(vf.get(1, [b""])[0])
                    power = _s64(int(vf.get(3, [0])[0]))
                kwargs[addr_attr] = addr
                kwargs[power_attr] = power
            elif kind == "str":
                kwargs[attr] = (
                    _as_bytes(vals[0]).decode() if vals else ""
                )
            elif kind == "bytes":
                kwargs[attr] = _as_bytes(vals[0]) if vals else b""
            elif kind == "int":
                kwargs[attr] = _s64(int(vals[0])) if vals else 0
            elif kind == "enum":
                kwargs[attr] = sub(int(vals[0])) if vals else sub(0)
            elif kind == "bool":
                kwargs[attr] = bool(vals[0]) if vals else False
            elif kind == "time":
                kwargs[attr] = (
                    _tcodec.decode_timestamp(_as_bytes(vals[0]))
                    if vals
                    else 0
                )
            elif kind == "dur":
                kwargs[attr] = (
                    _decode_duration(_as_bytes(vals[0])) if vals else 0
                )
            elif kind == "msg":
                kwargs[attr] = (
                    decode_msg(sub, _as_bytes(vals[0])) if vals else None
                )
            elif kind == "params":
                kwargs[attr] = (
                    _decode_params(_as_bytes(vals[0])) if vals else None
                )
            elif kind == "proofops":
                ops: tuple = ()
                if vals:
                    inner = ProtoReader(_as_bytes(vals[0])).to_dict()
                    ops = tuple(
                        decode_msg(T.ProofOp, _as_bytes(raw_op))
                        for raw_op in inner.get(1, [])
                    )
                kwargs[attr] = ops
            elif kind == "rep_bytes":
                kwargs[attr] = tuple(_as_bytes(v) for v in (vals or []))
            elif kind == "rep_str":
                kwargs[attr] = tuple(
                    _as_bytes(v).decode() for v in (vals or [])
                )
            elif kind == "rep_int":
                # accept both packed (bytes of concatenated varints,
                # proto3 canonical) and unpacked (one varint per key)
                items = []
                for v in vals or []:
                    if isinstance(v, (bytes, bytearray)):
                        from cometbft_tpu_torch.utils.protoio import (
                            decode_uvarint,
                        )

                        off = 0
                        while off < len(v):
                            n, off = decode_uvarint(v, off)
                            items.append(_s64(n))
                    else:
                        items.append(_s64(int(v)))
                kwargs[attr] = tuple(items)
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
    # FinalizeBlockRequest.decided_last_commit is non-optional
    if cls is T.FinalizeBlockRequest and kwargs.get("decided_last_commit") is None:
        kwargs["decided_last_commit"] = T.CommitInfo()
    return cls(**kwargs)


# -- envelopes ----------------------------------------------------------

@dataclass(frozen=True)
class Echo:
    message: str = ""


@dataclass(frozen=True)
class Flush:
    pass


@dataclass(frozen=True)
class ResponseException:
    error: str = ""


_SPEC[Echo] = [_f(1, "message", "str")]
_SPEC[Flush] = []
_SPEC[ResponseException] = [_f(1, "error", "str")]

# Zero-argument methods get empty request placeholder types so the
# envelope stays uniform (the reference has CommitRequest{} etc.).


@dataclass(frozen=True)
class CommitRequest:
    pass


@dataclass(frozen=True)
class ListSnapshotsRequest:
    pass


_SPEC[CommitRequest] = []
_SPEC[ListSnapshotsRequest] = []

# oneof numbers from proto/cometbft/abci/v1/types.proto Request
_REQUEST_ONEOF: list[tuple[int, type]] = [
    (1, Echo),
    (2, Flush),
    (3, T.InfoRequest),
    (5, T.InitChainRequest),
    (6, T.QueryRequest),
    (8, T.CheckTxRequest),
    (11, CommitRequest),
    (12, ListSnapshotsRequest),
    (13, T.OfferSnapshotRequest),
    (14, T.LoadSnapshotChunkRequest),
    (15, T.ApplySnapshotChunkRequest),
    (16, T.PrepareProposalRequest),
    (17, T.ProcessProposalRequest),
    (18, T.ExtendVoteRequest),
    (19, T.VerifyVoteExtensionRequest),
    (20, T.FinalizeBlockRequest),
]

# oneof numbers from proto/.../types.proto Response
_RESPONSE_ONEOF: list[tuple[int, type]] = [
    (1, ResponseException),
    (2, Echo),
    (3, Flush),
    (4, T.InfoResponse),
    (6, T.InitChainResponse),
    (7, T.QueryResponse),
    (9, T.CheckTxResponse),
    (12, T.CommitResponse),
    (13, T.ListSnapshotsResponse),
    (14, T.OfferSnapshotResponse),
    (15, T.LoadSnapshotChunkResponse),
    (16, T.ApplySnapshotChunkResponse),
    (17, T.PrepareProposalResponse),
    (18, T.ProcessProposalResponse),
    (19, T.ExtendVoteResponse),
    (20, T.VerifyVoteExtensionResponse),
    (21, T.FinalizeBlockResponse),
]

_REQ_NO = {cls: no for no, cls in _REQUEST_ONEOF}
_REQ_CLS = {no: cls for no, cls in _REQUEST_ONEOF}
_RESP_NO = {cls: no for no, cls in _RESPONSE_ONEOF}
_RESP_CLS = {no: cls for no, cls in _RESPONSE_ONEOF}


def _encode_envelope(obj, table: dict) -> bytes:
    no = table.get(type(obj))
    if no is None:
        raise AbciCodecError(f"not an envelope type: {type(obj).__name__}")
    w = ProtoWriter()
    w.message(no, encode_msg(obj))
    return w.finish()


def _decode_envelope(raw: bytes, table: dict):
    try:
        f = ProtoReader(bytes(raw)).to_dict()
    except Exception as exc:
        raise AbciCodecError(f"malformed envelope: {exc}") from exc
    for no, vals in f.items():
        cls = table.get(no)
        if cls is not None and vals:
            return decode_msg(cls, _as_bytes(vals[0]))
    raise AbciCodecError("empty or unknown envelope")


def encode_request(req) -> bytes:
    return _encode_envelope(req, _REQ_NO)


def decode_request(raw: bytes):
    return _decode_envelope(raw, _REQ_CLS)


def encode_response(resp) -> bytes:
    return _encode_envelope(resp, _RESP_NO)


def decode_response(raw: bytes):
    return _decode_envelope(raw, _RESP_CLS)


__all__ = [
    "AbciCodecError",
    "CommitRequest",
    "Echo",
    "Flush",
    "ListSnapshotsRequest",
    "ResponseException",
    "decode_msg",
    "decode_request",
    "decode_response",
    "encode_msg",
    "encode_request",
    "encode_response",
]
