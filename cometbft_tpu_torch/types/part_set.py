"""Block part sets — chunked, merkle-proven block gossip
(a copy of cometbft_tpu/types/part_set.py; reference
types/part_set.go:162).

Blocks are split into fixed-size parts so gossip is streamed and
parallel: every part carries an inclusion proof against the PartSetHeader
hash, letting peers verify chunks independently before the whole block
arrives — the reference's answer to "long context" scaling (SURVEY.md §5).

``Part.validate_basic`` is a trust-guard validator and
``PartSet.add_part`` a sink (``utils/trustguard``), as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

from cometbft_tpu_torch.crypto import merkle
from cometbft_tpu_torch.types.block import PartSetHeader
from cometbft_tpu_torch.utils.bit_array import BitArray
from cometbft_tpu_torch.utils import trustguard

BLOCK_PART_SIZE_BYTES = 65536  # types/params.go:23

# 100MB hard cap, mirrored from types/params.py MAX_BLOCK_SIZE_BYTES
# (params imports from this module, so importing it back would cycle)
_MAX_BLOCK_SIZE_BYTES = 104857600

#: the largest part count any valid block can need
#: (types/params.go MaxBlockPartsCount) — PartSetHeader.total comes
#: off the wire, so admission must cap it before allocating
MAX_PART_SET_TOTAL = _MAX_BLOCK_SIZE_BYTES // BLOCK_PART_SIZE_BYTES + 1


class PartSetError(Exception):
    pass


@dataclass(frozen=True)
class Part:
    index: int
    bytes: bytes
    proof: merkle.Proof

    def validate_basic(self) -> None:
        if self.index < 0:
            raise PartSetError("negative part index")
        if self.proof.index != self.index:
            raise PartSetError("part proof index mismatch")
        if len(self.bytes) > BLOCK_PART_SIZE_BYTES:
            raise PartSetError("part too large")
        trustguard.note_validated("Part.validate_basic")


class PartSet:
    """A complete or in-progress set of block parts."""

    def __init__(self, header: PartSetHeader):
        # the header is wire-derived (proposal gossip): cap total before
        # the allocations below, or a byzantine proposer that signs
        # total=2**40 turns part admission into an OOM
        if not 0 <= header.total <= MAX_PART_SET_TOTAL:
            raise PartSetError(
                f"part set total {header.total} out of range "
                f"[0, {MAX_PART_SET_TOTAL}]"
            )
        self.header = header
        self.parts: list[Part | None] = [None] * header.total
        self.parts_bit_array = BitArray(header.total)
        self.count = 0
        self.byte_size = 0

    @classmethod
    def from_bytes(cls, data: bytes, part_size: int) -> "PartSet":
        """Split data into parts with proofs (part_set.go NewPartSetFromData)."""
        chunks = [
            data[i : i + part_size] for i in range(0, len(data), part_size)
        ] or [b""]
        root, proofs = merkle.proofs_from_byte_slices(chunks)
        ps = cls(PartSetHeader(total=len(chunks), hash=root))
        for i, (chunk, proof) in enumerate(zip(chunks, proofs)):
            ps.parts[i] = Part(index=i, bytes=chunk, proof=proof)
            ps.parts_bit_array.set_index(i, True)
        ps.count = len(chunks)
        ps.byte_size = len(data)
        return ps

    def add_part(self, part: Part) -> bool:
        """Verify the part's proof against the header and add it.
        Returns False for duplicates; raises on invalid proof."""
        part.validate_basic()
        if part.index >= self.header.total:
            raise PartSetError("part index out of range")
        if self.parts[part.index] is not None:
            return False
        if not part.proof.verify(self.header.hash, part.bytes):
            raise PartSetError("invalid part proof")
        if part.proof.total != self.header.total:
            raise PartSetError("part proof total mismatch")
        trustguard.check_sink("part_set.add_part")
        self.parts[part.index] = part
        self.parts_bit_array.set_index(part.index, True)
        self.count += 1
        self.byte_size += len(part.bytes)
        return True

    def get_part(self, index: int) -> Part | None:
        if 0 <= index < self.header.total:
            return self.parts[index]
        return None

    def is_complete(self) -> bool:
        return self.count == self.header.total

    def assemble(self) -> bytes:
        if not self.is_complete():
            raise PartSetError("part set incomplete")
        return b"".join(p.bytes for p in self.parts)  # type: ignore[union-attr]

    def has_header(self, header: PartSetHeader) -> bool:
        return self.header == header
