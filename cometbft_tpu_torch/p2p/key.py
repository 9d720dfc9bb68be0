"""Node identity key (a copy of cometbft_tpu/p2p/key.py; reference:
p2p/key.go).

Every node has a persistent ed25519 node key; its ID is the hex of the
pubkey address (first 20 bytes of SHA-256 of the key), matching the
reference's ``PubKeyToID`` (p2p/key.go:45).  Persisted as JSON next to
the validator key, byte for byte the reference's file, so a node key
written by either package loads in the other.
"""

from __future__ import annotations

import json
import os

from cometbft_tpu_torch.crypto.ed25519 import (
    Ed25519PrivKey,
    Ed25519PubKey,
    gen_priv_key,
)

ID_BYTE_LENGTH = 20  # p2p/key.go:28 IDByteLength


def pub_key_to_id(pub_key: Ed25519PubKey) -> str:
    """(p2p/key.go:45 PubKeyToID)"""
    return pub_key.address().hex()


def validate_id(node_id: str) -> None:
    """(p2p/key.go:50 validateID)"""
    if len(node_id) != 2 * ID_BYTE_LENGTH:
        raise ValueError(
            f"invalid node ID length {len(node_id)}, expected {2 * ID_BYTE_LENGTH}"
        )
    bytes.fromhex(node_id)  # raises on non-hex


class NodeKey:
    """(p2p/key.go:34 NodeKey)"""

    def __init__(self, priv_key: Ed25519PrivKey):
        self.priv_key = priv_key

    @property
    def pub_key(self) -> Ed25519PubKey:
        return self.priv_key.pub_key()

    def id(self) -> str:
        return pub_key_to_id(self.pub_key)

    def sign(self, msg: bytes) -> bytes:
        return self.priv_key.sign(msg)

    # -- persistence (p2p/key.go:72 LoadOrGenNodeKey) -------------------

    def save_as(self, path: str) -> None:
        doc = {
            "priv_key": {
                "type": "tendermint/PrivKeyEd25519",
                "value": self.priv_key.bytes().hex(),
            }
        }
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=2)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "NodeKey":
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        return cls(Ed25519PrivKey(bytes.fromhex(doc["priv_key"]["value"])))

    @classmethod
    def load_or_generate(cls, path: str) -> "NodeKey":
        if os.path.exists(path):
            return cls.load(path)
        nk = cls(gen_priv_key())
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        nk.save_as(path)
        return nk


__all__ = ["NodeKey", "pub_key_to_id", "validate_id", "ID_BYTE_LENGTH"]
