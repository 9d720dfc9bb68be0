"""Consensus wire messages (a copy of cometbft_tpu/consensus/messages.py;
reference: internal/consensus/msgs.go,
proto/cometbft/consensus/v2/types.proto).

One tagged union covering the state-machine inputs (Proposal,
BlockPart, Vote) and the gossip control messages (NewRoundStep,
NewValidBlock, ProposalPOL, HasVote, VoteSetMaj23, VoteSetBits).  The
same encoding serves the WAL and the p2p channels.

Fleet plane (docs/observability.md "Fleet plane"): consensus-critical
envelopes (proposal, block-part, vote) may carry an optional TRAILING
trace-context field — origin node id, height/round, and the origin's
wall-clock send timestamp — so receivers can record per-hop gossip
latency and the fleet aggregator can stitch one cross-node height
timeline.  The field is strictly additive: an untagged message encodes
byte-identically to the pre-fleet codec, and ``decode_message``
tolerates (and strips) the context, so tagged and untagged nodes
interoperate in one localnet.

Where the port departs from its reference: whether a node stamps its
sends is the module constant ``TRACE_CTX`` (on, the reference's
default); the port reads no ``CMT_TPU_TRACE_CTX``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from cometbft_tpu_torch.types import codec
from cometbft_tpu_torch.types.block import BlockID
from cometbft_tpu_torch.types.part_set import Part
from cometbft_tpu_torch.types.vote import Proposal, Vote
from cometbft_tpu_torch.utils.bit_array import BitArray
from cometbft_tpu_torch.utils.protoio import ProtoReader, ProtoWriter, _unzigzag
from cometbft_tpu_torch.types.codec import as_bytes as _bz, as_int as _iv


#: absolute cap on wire-decoded bit arrays (votes/parts are bounded
#: by validator count and part count; 1M bits = 128KB is generous)
_MAX_BIT_ARRAY_BITS = 1 << 20


class MessageError(ValueError):
    pass


# -- cross-node causal trace context ------------------------------------


@dataclass(frozen=True)
class TraceContext:
    """Per-hop origin stamp for consensus-critical gossip.

    ``origin`` is the node id of THIS hop's sender (a forwarding node
    re-stamps, so hop latency is always sender→receiver, never a
    multi-hop accumulation); ``send_wall`` is the sender's
    ``time.time()`` at encode time — receivers correct it with the
    peer clock-offset estimate (MConnection pong piggyback) before
    histogramming, and clamp at zero.
    """

    origin: str
    height: int
    round: int
    send_wall: float

    @property
    def send_wall_ns(self) -> int:
        return int(self.send_wall * 1e9)


#: whether a node tags outbound consensus gossip by default.  Off =
#: behave like a pre-fleet node: send untagged, record no hops —
#: receiving tagged messages still works, which is the mixed-version
#: interop contract.
TRACE_CTX = True


def stamping_enabled() -> bool:
    """Whether this node tags outbound consensus gossip (``TRACE_CTX``)."""
    return TRACE_CTX


def make_trace_ctx(origin: str, height: int, round_: int) -> TraceContext:
    return TraceContext(
        origin=origin, height=height, round=round_, send_wall=time.time()
    )


def _enc_trace_ctx(ctx: TraceContext) -> bytes:
    w = ProtoWriter()
    w.string(1, ctx.origin)
    w.varint(2, ctx.height)
    w.svarint(3, ctx.round)
    w.varint(4, ctx.send_wall_ns)
    return w.finish()


def _dec_trace_ctx(data: bytes) -> TraceContext:
    f = ProtoReader(data).to_dict()
    return TraceContext(
        origin=_bz(f.get(1, [b""])[0]).decode("utf-8", "replace"),
        height=_iv(f.get(2, [0])[0]),
        round=_unzigzag(_iv(f.get(3, [0])[0])),
        send_wall=_iv(f.get(4, [0])[0]) / 1e9,  # deterministic: trace-plane timestamp, diagnostics only — never enters state
    )


@dataclass(frozen=True)
class NewRoundStepMessage:
    """Peer's current HRS (reactor.go NewRoundStepMessage)."""

    height: int
    round: int
    step: int
    seconds_since_start_time: int = 0
    last_commit_round: int = -1


@dataclass(frozen=True)
class NewValidBlockMessage:
    """Peer observed a POL-valid block (reactor.go NewValidBlockMessage)."""

    height: int
    round: int
    block_part_set_header: object  # PartSetHeader
    block_parts: BitArray
    is_commit: bool = False


@dataclass(frozen=True)
class ProposalMessage:
    proposal: Proposal


@dataclass(frozen=True)
class ProposalPOLMessage:
    height: int
    proposal_pol_round: int
    proposal_pol: BitArray


@dataclass(frozen=True)
class BlockPartMessage:
    height: int
    round: int
    part: Part


@dataclass(frozen=True)
class VoteMessage:
    vote: Vote


@dataclass(frozen=True)
class HasVoteMessage:
    height: int
    round: int
    type: int
    index: int


@dataclass(frozen=True)
class VoteSetMaj23Message:
    height: int
    round: int
    type: int
    block_id: BlockID


@dataclass(frozen=True)
class VoteSetBitsMessage:
    height: int
    round: int
    type: int
    block_id: BlockID
    votes: BitArray


# -- wire codec ---------------------------------------------------------

_TAG_NEW_ROUND_STEP = 1
_TAG_NEW_VALID_BLOCK = 2
_TAG_PROPOSAL = 3
_TAG_PROPOSAL_POL = 4
_TAG_BLOCK_PART = 5
_TAG_VOTE = 6
_TAG_HAS_VOTE = 7
_TAG_VOTE_SET_MAJ23 = 8
_TAG_VOTE_SET_BITS = 9
#: optional trailing trace-context field (fleet plane).  15 is the
#: last one-byte-key field number — far from the body tags so future
#: message kinds (10..14) never collide with it.
_TAG_TRACE_CTX = 15


def _enc_bit_array(ba: BitArray) -> bytes:
    w = ProtoWriter()
    w.varint(1, ba.size)
    w.bytes_(2, ba.to_bytes())
    return w.finish()


def _dec_bit_array(data: bytes) -> BitArray:
    f = ProtoReader(data).to_dict()
    bits = _iv(f.get(1, [0])[0])
    data = _bz(f.get(2, [b""])[0])
    # the bit count is attacker-controlled and sizes an allocation:
    # bound it by the payload actually sent (+ an absolute cap far
    # above any real validator-set/part-set size)
    if bits < 0 or bits > _MAX_BIT_ARRAY_BITS or (bits + 7) // 8 > max(
        len(data), 1
    ):
        raise MessageError(f"implausible bit array ({bits} bits, "
                           f"{len(data)} bytes)")
    return BitArray.from_bytes(bits, data)


def encode_message(msg, ctx: TraceContext | None = None) -> bytes:
    """Encode one consensus message; ``ctx`` (fleet plane) appends the
    optional trailing trace-context field.  Without ``ctx`` the output
    is byte-identical to the pre-fleet codec — the WAL and untagged
    sends never change."""
    w = ProtoWriter()
    if isinstance(msg, NewRoundStepMessage):
        m = ProtoWriter()
        m.varint(1, msg.height)
        m.svarint(2, msg.round)
        m.varint(3, msg.step)
        m.varint(4, msg.seconds_since_start_time)
        m.svarint(5, msg.last_commit_round)
        w.message(_TAG_NEW_ROUND_STEP, m.finish())
    elif isinstance(msg, NewValidBlockMessage):
        m = ProtoWriter()
        m.varint(1, msg.height)
        m.svarint(2, msg.round)
        m.message(3, msg.block_part_set_header.encode())
        m.message(4, _enc_bit_array(msg.block_parts))
        m.bool_(5, msg.is_commit)
        w.message(_TAG_NEW_VALID_BLOCK, m.finish())
    elif isinstance(msg, ProposalMessage):
        w.message(_TAG_PROPOSAL, msg.proposal.encode())
    elif isinstance(msg, ProposalPOLMessage):
        m = ProtoWriter()
        m.varint(1, msg.height)
        m.svarint(2, msg.proposal_pol_round)
        m.message(3, _enc_bit_array(msg.proposal_pol))
        w.message(_TAG_PROPOSAL_POL, m.finish())
    elif isinstance(msg, BlockPartMessage):
        m = ProtoWriter()
        m.varint(1, msg.height)
        m.svarint(2, msg.round)
        m.message(3, codec.encode_part(msg.part))
        w.message(_TAG_BLOCK_PART, m.finish())
    elif isinstance(msg, VoteMessage):
        w.message(_TAG_VOTE, msg.vote.encode())
    elif isinstance(msg, HasVoteMessage):
        m = ProtoWriter()
        m.varint(1, msg.height)
        m.svarint(2, msg.round)
        m.varint(3, msg.type)
        m.svarint(4, msg.index)
        w.message(_TAG_HAS_VOTE, m.finish())
    elif isinstance(msg, VoteSetMaj23Message):
        m = ProtoWriter()
        m.varint(1, msg.height)
        m.svarint(2, msg.round)
        m.varint(3, msg.type)
        m.message(4, msg.block_id.encode())
        w.message(_TAG_VOTE_SET_MAJ23, m.finish())
    elif isinstance(msg, VoteSetBitsMessage):
        m = ProtoWriter()
        m.varint(1, msg.height)
        m.svarint(2, msg.round)
        m.varint(3, msg.type)
        m.message(4, msg.block_id.encode())
        m.message(5, _enc_bit_array(msg.votes))
        w.message(_TAG_VOTE_SET_BITS, m.finish())
    else:
        raise MessageError(f"cannot encode {type(msg).__name__}")
    if ctx is not None:
        w.message(_TAG_TRACE_CTX, _enc_trace_ctx(ctx))
    return w.finish()


def decode_message(data: bytes):
    """Decode one consensus message, dropping any trace context —
    every pre-fleet call site keeps its exact contract."""
    return decode_message_traced(data)[0]


def decode_message_traced(data: bytes):
    """Decode -> (message, TraceContext | None).

    The trailing context field is stripped BEFORE the one-body check,
    so tagged and untagged messages both parse; a malformed context on
    a well-formed body yields ``ctx=None`` rather than rejecting the
    message (observability must never cost consensus a vote).  Any
    OTHER extra field still fails the strict one-body check — the
    fuzz surface does not widen beyond the one tag."""
    f = ProtoReader(data).to_dict()
    ctx = None
    raw_ctx = f.pop(_TAG_TRACE_CTX, None)
    if raw_ctx:
        if len(raw_ctx) != 1:
            raise MessageError("repeated trace context")
        try:
            ctx = _dec_trace_ctx(_bz(raw_ctx[0]))
        except Exception as exc:  # noqa: BLE001 — bad ctx is ignored, not
            # fatal: the message body still decodes; leave a breadcrumb
            # naming the type instead of nothing
            from cometbft_tpu_torch.utils.flight import FLIGHT

            FLIGHT.record(
                "trace_ctx_rejected", err=type(exc).__name__
            )
            ctx = None
    if len(f) != 1:
        raise MessageError("consensus message must have exactly one body")
    tag = next(iter(f))
    if len(f[tag]) != 1:
        raise MessageError("consensus message must have exactly one body")
    return _decode_body(tag, _bz(f[tag][0])), ctx


def _decode_body(tag: int, body: bytes):
    m = ProtoReader(body).to_dict() if tag != _TAG_PROPOSAL else None
    if tag == _TAG_NEW_ROUND_STEP:
        return NewRoundStepMessage(
            height=_iv(m.get(1, [0])[0]),
            round=_unzigzag(_iv(m.get(2, [0])[0])),
            step=_iv(m.get(3, [0])[0]),
            seconds_since_start_time=_iv(m.get(4, [0])[0]),
            last_commit_round=_unzigzag(_iv(m.get(5, [0])[0])),
        )
    if tag == _TAG_NEW_VALID_BLOCK:
        return NewValidBlockMessage(
            height=_iv(m.get(1, [0])[0]),
            round=_unzigzag(_iv(m.get(2, [0])[0])),
            block_part_set_header=codec.decode_part_set_header(
                _bz(m[3][0])
            ),
            block_parts=_dec_bit_array(_bz(m[4][0])),
            is_commit=bool(m.get(5, [0])[0]),
        )
    if tag == _TAG_PROPOSAL:
        return ProposalMessage(proposal=Proposal.decode(body))
    if tag == _TAG_PROPOSAL_POL:
        return ProposalPOLMessage(
            height=_iv(m.get(1, [0])[0]),
            proposal_pol_round=_unzigzag(_iv(m.get(2, [0])[0])),
            proposal_pol=_dec_bit_array(_bz(m[3][0])),
        )
    if tag == _TAG_BLOCK_PART:
        return BlockPartMessage(
            height=_iv(m.get(1, [0])[0]),
            round=_unzigzag(_iv(m.get(2, [0])[0])),
            part=codec.decode_part(_bz(m[3][0])),
        )
    if tag == _TAG_VOTE:
        return VoteMessage(vote=Vote.decode(body))
    if tag == _TAG_HAS_VOTE:
        return HasVoteMessage(
            height=_iv(m.get(1, [0])[0]),
            round=_unzigzag(_iv(m.get(2, [0])[0])),
            type=_iv(m.get(3, [0])[0]),
            index=_unzigzag(_iv(m.get(4, [0])[0])),
        )
    if tag == _TAG_VOTE_SET_MAJ23:
        return VoteSetMaj23Message(
            height=_iv(m.get(1, [0])[0]),
            round=_unzigzag(_iv(m.get(2, [0])[0])),
            type=_iv(m.get(3, [0])[0]),
            block_id=codec.decode_block_id(_bz(m[4][0])),
        )
    if tag == _TAG_VOTE_SET_BITS:
        return VoteSetBitsMessage(
            height=_iv(m.get(1, [0])[0]),
            round=_unzigzag(_iv(m.get(2, [0])[0])),
            type=_iv(m.get(3, [0])[0]),
            block_id=codec.decode_block_id(_bz(m[4][0])),
            votes=_dec_bit_array(_bz(m[5][0])),
        )
    raise MessageError(f"unknown consensus message tag {tag}")
