"""Block, Header, Commit, BlockID — the chain's core data structures (a
copy of cometbft_tpu/types/block.py).

Mirrors the capability surface of the reference's types/block.go: header
merkle hashing over field encodings, commit reconstruction of per-vote
sign bytes (the input to batch verification), and part-set chunking for
gossip (types/part_set.go).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from cometbft_tpu_torch.crypto import merkle, tmhash
from cometbft_tpu_torch.types import canonical
from cometbft_tpu_torch.utils.protoio import ProtoWriter
from cometbft_tpu_torch.version import BLOCK_PROTOCOL

MAX_HEADER_BYTES = 626

# CommitSig block-id flags (types/block.go BlockIDFlag)
BLOCK_ID_FLAG_ABSENT = 1
BLOCK_ID_FLAG_COMMIT = 2
BLOCK_ID_FLAG_NIL = 3


@dataclass(frozen=True)
class PartSetHeader:
    total: int = 0
    hash: bytes = b""

    def is_zero(self) -> bool:
        return self.total == 0 and not self.hash

    def encode(self) -> bytes:
        w = ProtoWriter()
        w.varint(1, self.total)
        w.bytes_(2, self.hash)
        return w.finish()


@dataclass(frozen=True)
class BlockID:
    hash: bytes = b""
    part_set_header: PartSetHeader = field(default_factory=PartSetHeader)

    def is_nil(self) -> bool:
        return not self.hash and self.part_set_header.is_zero()

    def is_complete(self) -> bool:
        return (
            len(self.hash) == tmhash.SIZE
            and self.part_set_header.total > 0
            and len(self.part_set_header.hash) == tmhash.SIZE
        )

    def encode(self) -> bytes:
        w = ProtoWriter()
        w.bytes_(1, self.hash)
        w.message(2, self.part_set_header.encode())
        return w.finish()

    def key(self) -> bytes:
        """Map key for vote tallying (types/block.go BlockID.Key): the
        full unambiguous encoding — distinct BlockIDs must never collide
        here, or vote tallies could be merged across blocks."""
        return self.encode()


NIL_BLOCK_ID = BlockID()


def _enc_bytes(b: bytes) -> bytes:
    """Field encoding for header merkleization: length-prefixed bytes
    (semantics of the reference's cdcEncode: a deterministic, typed,
    unambiguous encoding per field)."""
    w = ProtoWriter()
    w.bytes_(1, b)
    return w.finish()


def _enc_int(v: int) -> bytes:
    w = ProtoWriter()
    w.varint(1, v)
    return w.finish()


def _enc_str(s: str) -> bytes:
    w = ProtoWriter()
    w.string(1, s)
    return w.finish()


@dataclass(frozen=True)
class Header:
    """Block header (types/block.go Header). Times are unix-epoch ns."""

    chain_id: str = ""
    height: int = 0
    time_ns: int = 0
    last_block_id: BlockID = field(default_factory=BlockID)
    last_commit_hash: bytes = b""
    data_hash: bytes = b""
    validators_hash: bytes = b""
    next_validators_hash: bytes = b""
    consensus_hash: bytes = b""
    app_hash: bytes = b""
    last_results_hash: bytes = b""
    evidence_hash: bytes = b""
    proposer_address: bytes = b""
    version_block: int = BLOCK_PROTOCOL
    version_app: int = 0

    def hash(self) -> bytes | None:
        """Merkle root of the field encodings (types/block.go Header.Hash).
        None until the validators hash is populated (freshly proposed)."""
        if not self.validators_hash:
            return None
        ver = ProtoWriter()
        ver.varint(1, self.version_block)
        ver.varint(2, self.version_app)
        fields = [
            ver.finish(),
            _enc_str(self.chain_id),
            _enc_int(self.height),
            canonical.encode_timestamp(self.time_ns),
            self.last_block_id.encode(),
            _enc_bytes(self.last_commit_hash),
            _enc_bytes(self.data_hash),
            _enc_bytes(self.validators_hash),
            _enc_bytes(self.next_validators_hash),
            _enc_bytes(self.consensus_hash),
            _enc_bytes(self.app_hash),
            _enc_bytes(self.last_results_hash),
            _enc_bytes(self.evidence_hash),
            _enc_bytes(self.proposer_address),
        ]
        return merkle.hash_from_byte_slices(fields)


@dataclass(frozen=True)
class CommitSig:
    """One validator's precommit inside a Commit (types/block.go:608)."""

    block_id_flag: int = BLOCK_ID_FLAG_ABSENT
    validator_address: bytes = b""
    timestamp_ns: int = 0
    signature: bytes = b""

    def is_absent(self) -> bool:
        return self.block_id_flag == BLOCK_ID_FLAG_ABSENT

    def is_commit(self) -> bool:
        return self.block_id_flag == BLOCK_ID_FLAG_COMMIT

    def block_id(self, commit_block_id: BlockID) -> BlockID:
        """The block id this sig voted for (commit/nil/absent)."""
        if self.block_id_flag == BLOCK_ID_FLAG_COMMIT:
            return commit_block_id
        return NIL_BLOCK_ID

    def encode(self) -> bytes:
        w = ProtoWriter()
        w.varint(1, self.block_id_flag)
        w.bytes_(2, self.validator_address)
        w.message(3, canonical.encode_timestamp(self.timestamp_ns))
        w.bytes_(4, self.signature)
        return w.finish()

    def validate_basic(self, aggregated: bool = False) -> None:
        """``aggregated=True`` (set by Commit.validate_basic when the
        commit carries an aggregate signature) permits a COMMIT-flag
        entry with an EMPTY signature: its proof is the commit-level
        BLS aggregate, not a per-validator field.  Nil votes are never
        aggregated (they sign a different block id), so they keep
        their own signatures even in aggregate commits."""
        if self.block_id_flag not in (
            BLOCK_ID_FLAG_ABSENT,
            BLOCK_ID_FLAG_COMMIT,
            BLOCK_ID_FLAG_NIL,
        ):
            raise ValueError(f"unknown BlockIDFlag {self.block_id_flag}")
        if self.is_absent():
            if self.validator_address or self.signature:
                raise ValueError("absent CommitSig must be empty")
        else:
            if len(self.validator_address) != 20:
                raise ValueError("invalid validator address size")
            if not self.signature:
                if not (aggregated and self.is_commit()):
                    raise ValueError("invalid signature size")
            elif len(self.signature) > 96:
                raise ValueError("invalid signature size")


@dataclass(frozen=True)
class Commit:
    """+2/3 precommits for a block (types/block.go:715).

    ``agg_signature`` (no reference analog; arXiv:2302.00418's BLS
    committee design) carries ONE BLS12-381 aggregate over the
    BLOCK_ID_FLAG_COMMIT precommits: the covered CommitSig entries
    have EMPTY per-validator signatures, every covered validator
    signed the same canonical message (:meth:`aggregate_sign_bytes`),
    and verification is one pairing-product check instead of an
    N-signature batch (types/validation picks the path by what the
    commit actually carries).  Empty = the classic per-signature
    commit, byte-identical to before the field existed."""

    height: int = 0
    round: int = 0
    block_id: BlockID = field(default_factory=BlockID)
    signatures: tuple[CommitSig, ...] = ()
    agg_signature: bytes = b""

    def size(self) -> int:
        return len(self.signatures)

    def vote_sign_bytes(self, chain_id: str, idx: int) -> bytes:
        """Reconstruct the canonical sign-bytes of validator idx's
        precommit (types/block.go:902 — the per-signature distinct
        message consumed by batch verification)."""
        cs = self.signatures[idx]
        return canonical.vote_sign_bytes(
            chain_id,
            canonical.PRECOMMIT_TYPE,
            self.height,
            self.round,
            cs.block_id(self.block_id),
            cs.timestamp_ns,
        )

    def aggregate_sign_bytes(self, chain_id: str) -> bytes:
        """The ONE canonical message every aggregate-covered precommit
        signed: the commit's own height/round/block id with the ZERO
        timestamp.  Aggregation requires a shared message, and the
        per-validator timestamp is the only field that varies across
        honest precommits for one block — BLS validators producing
        aggregate commits therefore sign the timestamp-free canonical
        vote (the block id, height, round, and chain id still bind
        the vote to exactly one decision)."""
        return canonical.vote_sign_bytes(
            chain_id,
            canonical.PRECOMMIT_TYPE,
            self.height,
            self.round,
            self.block_id,
            0,
        )

    def is_aggregated(self, idx: int) -> bool:
        """Is signature ``idx`` covered by the commit-level aggregate
        (COMMIT flag, empty per-validator signature)?"""
        cs = self.signatures[idx]
        return bool(self.agg_signature) and cs.is_commit() and (
            not cs.signature
        )

    def hash(self) -> bytes:
        leaves = [cs.encode() for cs in self.signatures]
        if self.agg_signature:
            # the aggregate is consensus-critical content: it must be
            # bound by last_commit_hash like every per-vote signature
            leaves.append(self.agg_signature)
        return merkle.hash_from_byte_slices(leaves)

    def validate_basic(self) -> None:
        if self.height < 0 or self.round < 0:
            raise ValueError("negative height/round in commit")
        if self.agg_signature and len(self.agg_signature) != 96:
            raise ValueError("invalid aggregate signature size")
        if self.height >= 1:
            if self.block_id.is_nil():
                raise ValueError("commit cannot be for nil block")
            if not self.signatures:
                raise ValueError("no signatures in commit")
            aggregated = bool(self.agg_signature)
            for cs in self.signatures:
                cs.validate_basic(aggregated=aggregated)


@dataclass(frozen=True)
class Data:
    """Block transactions (types/block.go Data)."""

    txs: tuple[bytes, ...] = ()

    def hash(self) -> bytes:
        return merkle.hash_from_byte_slices(
            [tmhash.sum256(tx) for tx in self.txs]
        )


def tx_hash(tx: bytes) -> bytes:
    """Transaction key for mempool/index (types/tx.go Tx.Hash)."""
    return tmhash.sum256(tx)


@dataclass(frozen=True)
class Block:
    header: Header
    data: Data = field(default_factory=Data)
    evidence: tuple = ()
    last_commit: Commit | None = None

    def hash(self) -> bytes | None:
        return self.header.hash()

    def make_part_set(self, part_size: int):
        from cometbft_tpu_torch.types.part_set import PartSet

        return PartSet.from_bytes(self.encode(), part_size)

    def encode(self) -> bytes:
        """Deterministic wire encoding of the whole block."""
        from cometbft_tpu_torch.types import codec

        return codec.encode_block(self)

    def validate_basic(self) -> None:
        if self.header.height < 1:
            raise ValueError("block height must be >= 1")
        if self.last_commit is not None:
            self.last_commit.validate_basic()

    def with_hashes(self) -> "Block":
        """Fill the header's derived hashes (data, commit, evidence)."""
        from cometbft_tpu_torch.types import codec

        h = replace(
            self.header,
            data_hash=self.data.hash(),
            last_commit_hash=(
                self.last_commit.hash() if self.last_commit else b""
            ),
            evidence_hash=merkle.hash_from_byte_slices(
                [codec.encode_evidence(ev) for ev in self.evidence]
            ),
        )
        return replace(self, header=h)
