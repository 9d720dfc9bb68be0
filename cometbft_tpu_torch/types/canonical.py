"""Canonical sign-bytes — the byte-deterministic encodings validators sign
(a copy of cometbft_tpu/types/canonical.py).

Mirrors the semantics of the reference's canonicalization
(types/canonical.go:57 CanonicalizeVote, types/vote.go:151
VoteSignBytes): length-delimited protobuf with fixed-width height/round
(sfixed64) so encodings are unambiguous and identically sized across
implementations. The signed payload deliberately excludes validator
address/index (signatures must be position-independent) and includes
chain_id for cross-chain replay protection.

These bytes are exactly what the keyed tier's sha512_keyed kernel
hashes on the card, so this module is consensus-critical: any nondeterminism here is a fork.
"""

from __future__ import annotations

from cometbft_tpu_torch.utils.protoio import ProtoWriter, length_prefixed

# SignedMsgType (types/signed_msg_type.go)
PREVOTE_TYPE = 1
PRECOMMIT_TYPE = 2
PROPOSAL_TYPE = 32


def encode_timestamp(ns: int) -> bytes:
    """google.protobuf.Timestamp: seconds(1) + nanos(2), from unix-epoch
    nanoseconds."""
    w = ProtoWriter()
    w.varint(1, (ns // 1_000_000_000) & 0xFFFFFFFFFFFFFFFF)
    w.varint(2, ns % 1_000_000_000)
    return w.finish()


def encode_canonical_part_set_header(total: int, hash_: bytes) -> bytes:
    w = ProtoWriter()
    w.varint(1, total)
    w.bytes_(2, hash_)
    return w.finish()


def encode_canonical_block_id(block_id) -> bytes | None:
    """CanonicalBlockID; None for nil block ids (field omitted)."""
    if block_id is None or block_id.is_nil():
        return None
    w = ProtoWriter()
    w.bytes_(1, block_id.hash)
    w.message(
        2,
        encode_canonical_part_set_header(
            block_id.part_set_header.total, block_id.part_set_header.hash
        ),
    )
    return w.finish()


def vote_sign_bytes(
    chain_id: str,
    msg_type: int,
    height: int,
    round_: int,
    block_id,
    timestamp_ns: int,
) -> bytes:
    """CanonicalVote marshal, length-prefixed (types/vote.go:151)."""
    w = ProtoWriter()
    w.varint(1, msg_type)
    w.sfixed64(2, height)
    w.sfixed64(3, round_)
    w.message(4, encode_canonical_block_id(block_id))
    w.message(5, encode_timestamp(timestamp_ns))
    w.string(6, chain_id)
    return length_prefixed(w.finish())


def proposal_sign_bytes(
    chain_id: str,
    height: int,
    round_: int,
    pol_round: int,
    block_id,
    timestamp_ns: int,
) -> bytes:
    """CanonicalProposal marshal, length-prefixed (types/proposal.go)."""
    w = ProtoWriter()
    w.varint(1, PROPOSAL_TYPE)
    w.sfixed64(2, height)
    w.sfixed64(3, round_)
    # pol_round is -1 when absent; encode via two's complement varint
    w.varint(4, pol_round & 0xFFFFFFFFFFFFFFFF)
    w.message(5, encode_canonical_block_id(block_id))
    w.message(6, encode_timestamp(timestamp_ns))
    w.string(7, chain_id)
    return length_prefixed(w.finish())


def vote_extension_sign_bytes(
    chain_id: str, height: int, round_: int, extension: bytes
) -> bytes:
    """CanonicalVoteExtension (types/vote.go VoteExtensionSignBytes)."""
    w = ProtoWriter()
    w.bytes_(1, extension)
    w.sfixed64(2, height)
    w.sfixed64(3, round_)
    w.string(4, chain_id)
    return length_prefixed(w.finish())
