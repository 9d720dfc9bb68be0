"""BlockMeta — header + sizing info stored per height
(a copy of cometbft_tpu/types/block_meta.py; reference:
types/block_meta.go)."""

from __future__ import annotations

from dataclasses import dataclass, field

from cometbft_tpu_torch.types.block import Block, BlockID, Header
from cometbft_tpu_torch.utils.protoio import ProtoReader, ProtoWriter


def _codec_iv(v):
    from cometbft_tpu_torch.types.codec import as_int

    return as_int(v)


@dataclass(frozen=True)
class BlockMeta:
    block_id: BlockID = field(default_factory=BlockID)
    block_size: int = 0
    header: Header = field(default_factory=Header)
    num_txs: int = 0

    @classmethod
    def from_parts(cls, block: Block, part_set) -> "BlockMeta":
        return cls(
            block_id=BlockID(
                hash=block.hash(), part_set_header=part_set.header
            ),
            block_size=part_set.byte_size,
            header=block.header,
            num_txs=len(block.data.txs),
        )

    def encode(self) -> bytes:
        from cometbft_tpu_torch.types import codec

        w = ProtoWriter()
        w.message(1, self.block_id.encode())
        w.varint(2, self.block_size)
        w.message(3, codec.encode_header(self.header))
        w.varint(4, self.num_txs)
        return w.finish()

    @classmethod
    def decode(cls, data: bytes) -> "BlockMeta":
        from cometbft_tpu_torch.types import codec

        f = ProtoReader(data).to_dict()
        return cls(
            block_id=codec.decode_block_id(codec.as_bytes(f[1][0])) if 1 in f else BlockID(),
            block_size=_codec_iv(f.get(2, [0])[0]),
            header=codec.decode_header(codec.as_bytes(f[3][0])) if 3 in f else Header(),
            num_txs=_codec_iv(f.get(4, [0])[0]),
        )
