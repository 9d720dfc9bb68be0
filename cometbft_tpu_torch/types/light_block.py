"""Light blocks: header + commit + validator set (a copy of
cometbft_tpu/types/light_block.py; reference: types/light.go).

The unit of light-client verification: a ``SignedHeader`` proves what
the validators signed; the ``ValidatorSet`` lets a client check those
signatures without the full block.
"""

from __future__ import annotations

from dataclasses import dataclass

from cometbft_tpu_torch.types import codec
from cometbft_tpu_torch.types.block import Commit, Header
from cometbft_tpu_torch.types.validator import ValidatorSet
from cometbft_tpu_torch.utils.protoio import ProtoReader, ProtoWriter


def _codec_bz(v):
    from cometbft_tpu_torch.types.codec import as_bytes

    return as_bytes(v)


class LightBlockError(ValueError):
    pass


@dataclass(frozen=True)
class SignedHeader:
    """(types/light.go:57 SignedHeader)"""

    header: Header
    commit: Commit

    @property
    def height(self) -> int:
        return self.header.height

    def hash(self) -> bytes:
        return self.header.hash()

    def validate_basic(self, chain_id: str) -> None:
        """(types/light.go:66 ValidateBasic)"""
        if self.header is None or self.commit is None:
            raise LightBlockError("missing header or commit")
        if self.header.height <= 0:
            raise LightBlockError("non-positive header height")
        if self.header.hash() is None:
            raise LightBlockError("header is not hashable")
        if self.header.chain_id != chain_id:
            raise LightBlockError(
                f"header chain id {self.header.chain_id!r} != {chain_id!r}"
            )
        self.commit.validate_basic()
        if self.commit.height != self.header.height:
            raise LightBlockError(
                f"commit height {self.commit.height} != "
                f"header height {self.header.height}"
            )
        if self.commit.block_id.hash != self.header.hash():
            raise LightBlockError("commit signs a different header")

    def encode(self) -> bytes:
        w = ProtoWriter()
        w.message(1, codec.encode_header(self.header))
        w.message(2, codec.encode_commit(self.commit))
        return w.finish()

    @classmethod
    def decode(cls, data: bytes) -> "SignedHeader":
        f = ProtoReader(data).to_dict()
        return cls(
            header=codec.decode_header(_codec_bz(f[1][0])),
            commit=codec.decode_commit(_codec_bz(f[2][0])),
        )


@dataclass(frozen=True)
class LightBlock:
    """(types/light.go:13 LightBlock)"""

    signed_header: SignedHeader
    validator_set: ValidatorSet

    @property
    def height(self) -> int:
        return self.signed_header.height

    @property
    def header(self) -> Header:
        return self.signed_header.header

    @property
    def commit(self) -> Commit:
        return self.signed_header.commit

    @property
    def time_ns(self) -> int:
        return self.signed_header.header.time_ns

    def hash(self) -> bytes:
        return self.signed_header.hash()

    def validate_basic(self, chain_id: str) -> None:
        """(types/light.go:31 ValidateBasic)"""
        if self.validator_set is None:
            raise LightBlockError("missing validator set")
        self.signed_header.validate_basic(chain_id)
        if len(self.validator_set) == 0:
            raise LightBlockError("empty validator set")
        if self.signed_header.header.validators_hash != self.validator_set.hash():
            raise LightBlockError(
                "validator set does not match header validators_hash"
            )

    def encode(self) -> bytes:
        from cometbft_tpu_torch.state import encode_validator_set

        w = ProtoWriter()
        w.message(1, self.signed_header.encode())
        w.message(2, encode_validator_set(self.validator_set))
        return w.finish()

    @classmethod
    def decode(cls, data: bytes) -> "LightBlock":
        from cometbft_tpu_torch.state import decode_validator_set

        f = ProtoReader(data).to_dict()
        return cls(
            signed_header=SignedHeader.decode(_codec_bz(f[1][0])),
            validator_set=decode_validator_set(_codec_bz(f[2][0])),
        )


__all__ = ["LightBlock", "LightBlockError", "SignedHeader"]
