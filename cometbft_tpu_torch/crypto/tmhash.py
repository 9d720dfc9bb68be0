"""Consensus hashing (a copy of cometbft_tpu/crypto/tmhash.py; reference:
crypto/tmhash — SHA-256 + 20-byte sums)."""

from __future__ import annotations

import hashlib

SIZE = 32
TRUNCATED_SIZE = 20


def sum256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def sum_truncated(data: bytes) -> bytes:
    """First 20 bytes of SHA-256; used for addresses (crypto/tmhash/hash.go)."""
    return hashlib.sha256(data).digest()[:TRUNCATED_SIZE]
