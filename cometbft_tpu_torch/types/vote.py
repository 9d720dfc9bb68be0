"""Vote and Proposal — the signed consensus messages (a copy of
cometbft_tpu/types/vote.py; reference types/vote.go, types/proposal.go)."""

from __future__ import annotations

from dataclasses import dataclass, field

from cometbft_tpu_torch.types import canonical
from cometbft_tpu_torch.types.block import (
    BLOCK_ID_FLAG_ABSENT,
    BLOCK_ID_FLAG_COMMIT,
    BLOCK_ID_FLAG_NIL,
    BlockID,
    CommitSig,
)
from cometbft_tpu_torch.utils.protoio import ProtoWriter, ProtoReader


def _codec_bz(v):
    from cometbft_tpu_torch.types.codec import as_bytes

    return as_bytes(v)


def _codec_iv(v):
    from cometbft_tpu_torch.types.codec import as_int

    return as_int(v)


@dataclass(frozen=True)
class Vote:
    """A prevote or precommit (types/vote.go:39)."""

    type: int = canonical.PREVOTE_TYPE
    height: int = 0
    round: int = 0
    block_id: BlockID = field(default_factory=BlockID)
    timestamp_ns: int = 0
    validator_address: bytes = b""
    validator_index: int = -1
    signature: bytes = b""
    extension: bytes = b""
    extension_signature: bytes = b""

    def sign_bytes(self, chain_id: str) -> bytes:
        """(types/vote.go:151 VoteSignBytes)"""
        return canonical.vote_sign_bytes(
            chain_id,
            self.type,
            self.height,
            self.round,
            self.block_id,
            self.timestamp_ns,
        )

    def extension_sign_bytes(self, chain_id: str) -> bytes:
        return canonical.vote_extension_sign_bytes(
            chain_id, self.height, self.round, self.extension
        )

    def is_nil(self) -> bool:
        return self.block_id.is_nil()

    def commit_sig(self) -> CommitSig:
        """Convert to a CommitSig (types/vote.go CommitSig)."""
        if self.is_nil():
            flag = BLOCK_ID_FLAG_NIL
        else:
            flag = BLOCK_ID_FLAG_COMMIT
        return CommitSig(
            block_id_flag=flag,
            validator_address=self.validator_address,
            timestamp_ns=self.timestamp_ns,
            signature=self.signature,
        )

    def validate_basic(self) -> None:
        if self.type not in (canonical.PREVOTE_TYPE, canonical.PRECOMMIT_TYPE):
            raise ValueError("invalid vote type")
        if self.height < 0 or self.round < 0:
            raise ValueError("negative height/round")
        if not self.block_id.is_nil() and not self.block_id.is_complete():
            raise ValueError("blockID must be nil or complete")
        if len(self.validator_address) != 20:
            raise ValueError("invalid validator address")
        if self.validator_index < 0:
            raise ValueError("negative validator index")
        if not self.signature or len(self.signature) > 96:
            raise ValueError("invalid signature size")
        if self.type == canonical.PREVOTE_TYPE and self.extension:
            raise ValueError("prevotes cannot carry extensions")

    def encode(self) -> bytes:
        w = ProtoWriter()
        w.varint(1, self.type)
        w.sfixed64(2, self.height)
        w.sfixed64(3, self.round)
        w.message(4, self.block_id.encode() if not self.block_id.is_nil() else None)
        w.message(5, canonical.encode_timestamp(self.timestamp_ns))
        w.bytes_(6, self.validator_address)
        w.varint(7, self.validator_index & 0xFFFFFFFFFFFFFFFF)
        w.bytes_(8, self.signature)
        w.bytes_(9, self.extension)
        w.bytes_(10, self.extension_signature)
        return w.finish()

    @classmethod
    def decode(cls, data: bytes) -> "Vote":
        from cometbft_tpu_torch.types import codec

        f = ProtoReader(data).to_dict()
        return cls(
            type=_codec_iv(f.get(1, [0])[0]),
            height=codec.s64(f.get(2, [0])[0]),
            round=codec.s64(f.get(3, [0])[0]),
            block_id=codec.decode_block_id(codec.as_bytes(f[4][0])) if 4 in f else BlockID(),
            timestamp_ns=codec.decode_timestamp(codec.as_bytes(f[5][0])) if 5 in f else 0,
            validator_address=_codec_bz(f.get(6, [b""])[0]),
            validator_index=codec.s64(f.get(7, [0])[0]),
            signature=_codec_bz(f.get(8, [b""])[0]),
            extension=_codec_bz(f.get(9, [b""])[0]),
            extension_signature=_codec_bz(f.get(10, [b""])[0]),
        )


@dataclass(frozen=True)
class Proposal:
    """A proposed block at (height, round) (types/proposal.go:20)."""

    height: int = 0
    round: int = 0
    pol_round: int = -1
    block_id: BlockID = field(default_factory=BlockID)
    timestamp_ns: int = 0
    signature: bytes = b""

    def sign_bytes(self, chain_id: str) -> bytes:
        return canonical.proposal_sign_bytes(
            chain_id,
            self.height,
            self.round,
            self.pol_round,
            self.block_id,
            self.timestamp_ns,
        )

    def validate_basic(self) -> None:
        if self.height < 0 or self.round < 0:
            raise ValueError("negative height/round")
        if self.pol_round < -1 or self.pol_round >= self.round:
            raise ValueError("invalid POL round")
        if not self.block_id.is_complete():
            raise ValueError("proposal blockID must be complete")
        if not self.signature or len(self.signature) > 96:
            raise ValueError("invalid signature size")

    def encode(self) -> bytes:
        w = ProtoWriter()
        w.sfixed64(1, self.height)
        w.sfixed64(2, self.round)
        w.varint(3, self.pol_round & 0xFFFFFFFFFFFFFFFF)
        w.message(4, self.block_id.encode())
        w.message(5, canonical.encode_timestamp(self.timestamp_ns))
        w.bytes_(6, self.signature)
        return w.finish()

    @classmethod
    def decode(cls, data: bytes) -> "Proposal":
        from cometbft_tpu_torch.types import codec

        f = ProtoReader(data).to_dict()
        return cls(
            height=codec.s64(f.get(1, [0])[0]),
            round=codec.s64(f.get(2, [0])[0]),
            pol_round=codec.s64(f.get(3, [0])[0]),
            block_id=codec.decode_block_id(codec.as_bytes(f[4][0])) if 4 in f else BlockID(),
            timestamp_ns=codec.decode_timestamp(codec.as_bytes(f[5][0])) if 5 in f else 0,
            signature=_codec_bz(f.get(6, [b""])[0]),
        )
