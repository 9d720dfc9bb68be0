"""RFC-6962-style Merkle tree (a copy of cometbft_tpu/crypto/merkle.py;
reference: crypto/merkle/tree.go, proof.go).

Leaf hash = SHA-256(0x00 || leaf); inner = SHA-256(0x01 || left || right);
hash of the empty list = SHA-256(""). Trees split at the largest power of
two strictly less than n, giving deterministic, proof-friendly structure.
"""

from __future__ import annotations

from dataclasses import dataclass

from cometbft_tpu_torch.crypto import tmhash

LEAF_PREFIX = b"\x00"
INNER_PREFIX = b"\x01"


def _empty_hash() -> bytes:
    return tmhash.sum256(b"")


def leaf_hash(leaf: bytes) -> bytes:
    return tmhash.sum256(LEAF_PREFIX + leaf)


def inner_hash(left: bytes, right: bytes) -> bytes:
    return tmhash.sum256(INNER_PREFIX + left + right)


def _split_point(n: int) -> int:
    """Largest power of 2 strictly less than n (tree.go getSplitPoint)."""
    if n < 1:
        raise ValueError("need at least one item")
    k = 1 << (n - 1).bit_length() - 1
    return k if k < n else k >> 1


def hash_from_byte_slices(items: list[bytes]) -> bytes:
    n = len(items)
    if n == 0:
        return _empty_hash()
    if n == 1:
        return leaf_hash(items[0])
    k = _split_point(n)
    return inner_hash(
        hash_from_byte_slices(items[:k]), hash_from_byte_slices(items[k:])
    )


@dataclass
class Proof:
    """Merkle inclusion proof (crypto/merkle/proof.go:22)."""

    total: int
    index: int
    leaf_hash: bytes
    aunts: list[bytes]

    MAX_AUNTS = 100  # proof.go:19 — bounds untrusted input

    def compute_root(self) -> bytes:
        return _root_from_aunts(self.index, self.total, self.leaf_hash, self.aunts)

    def verify(self, root: bytes, leaf: bytes) -> bool:
        if (
            self.total < 0
            or self.index < 0
            or self.index >= self.total
            or len(self.aunts) > self.MAX_AUNTS
        ):
            return False
        if leaf_hash(leaf) != self.leaf_hash:
            return False
        try:
            return self.compute_root() == root
        except ValueError:
            return False


def _root_from_aunts(
    index: int, total: int, leaf: bytes, aunts: list[bytes]
) -> bytes:
    if total == 0:
        raise ValueError("cannot prove membership in empty tree")
    if total == 1:
        if aunts:
            raise ValueError("unexpected aunts for single-leaf tree")
        return leaf
    if not aunts:
        raise ValueError("not enough aunts")
    k = _split_point(total)
    if index < k:
        left = _root_from_aunts(index, k, leaf, aunts[:-1])
        return inner_hash(left, aunts[-1])
    right = _root_from_aunts(index - k, total - k, leaf, aunts[:-1])
    return inner_hash(aunts[-1], right)


def proofs_from_byte_slices(items: list[bytes]) -> tuple[bytes, list[Proof]]:
    """Root hash + an inclusion proof per item (proof.go ProofsFromByteSlices)."""
    trails, root_node = _trails_from_byte_slices(items)
    root = root_node.hash if root_node else _empty_hash()
    proofs = [
        Proof(
            total=len(items),
            index=i,
            leaf_hash=trails[i].hash,
            aunts=trails[i].flatten_aunts(),
        )
        for i in range(len(items))
    ]
    return root, proofs


class _Node:
    __slots__ = ("hash", "parent", "left", "right")

    def __init__(self, hash_: bytes):
        self.hash = hash_
        self.parent: _Node | None = None
        self.left: _Node | None = None  # sibling to include when going up
        self.right: _Node | None = None

    def flatten_aunts(self) -> list[bytes]:
        aunts: list[bytes] = []
        node: _Node | None = self
        while node is not None:
            if node.left is not None:
                aunts.append(node.left.hash)
            if node.right is not None:
                aunts.append(node.right.hash)
            node = node.parent
        return aunts


def _trails_from_byte_slices(
    items: list[bytes],
) -> tuple[list[_Node], _Node | None]:
    n = len(items)
    if n == 0:
        return [], None
    if n == 1:
        node = _Node(leaf_hash(items[0]))
        return [node], node
    k = _split_point(n)
    lefts, left_root = _trails_from_byte_slices(items[:k])
    rights, right_root = _trails_from_byte_slices(items[k:])
    assert left_root is not None and right_root is not None
    root = _Node(inner_hash(left_root.hash, right_root.hash))
    left_root.parent = root
    left_root.right = right_root
    right_root.parent = root
    right_root.left = left_root
    return lefts + rights, root


# -- key/value state proofs (the framework's query-proof format) --------
#
# The reference chains ics23/ProofOperators through crypto/merkle/
# proof_op.go; this framework's native format is simpler: ONE ProofOp
# whose data is a serialized inclusion Proof for the canonical
# key/value leaf below, verified directly against the header app_hash.

#: ProofOp.type for a simple-merkle k/v inclusion proof.
KV_PROOF_OP_TYPE = "cmttpu:simple-merkle:v1"


def kv_leaf(key: bytes, value: bytes) -> bytes:
    """Canonical state leaf: uvarint-length-prefixed key then value.
    Apps hash sorted leaves into their app_hash; the proof-verifying
    RPC client rebuilds the leaf from the query response."""
    from cometbft_tpu_torch.utils.protoio import encode_uvarint

    return (
        encode_uvarint(len(key)) + key + encode_uvarint(len(value)) + value
    )


def proof_to_bytes(p: Proof) -> bytes:
    from cometbft_tpu_torch.utils.protoio import ProtoWriter

    w = ProtoWriter()
    w.varint(1, p.total)
    w.varint(2, p.index)
    w.bytes_(3, p.leaf_hash)
    for aunt in p.aunts:
        w.bytes_(4, aunt)
    return w.finish()


def proof_from_bytes(data: bytes) -> Proof:
    from cometbft_tpu_torch.utils.protoio import ProtoReader

    f = ProtoReader(bytes(data)).to_dict()
    total = int(f.get(1, [0])[0])
    index = int(f.get(2, [0])[0])
    leaf = bytes(f.get(3, [b""])[0])
    aunts = [bytes(a) for a in f.get(4, [])]
    if total < 0 or index < 0 or len(aunts) > Proof.MAX_AUNTS:
        raise ValueError("malformed merkle proof")
    return Proof(total=total, index=index, leaf_hash=leaf, aunts=aunts)
