"""Ed25519 keys with ZIP-215 verification over the big-int oracle
and the host batch verifier (the counterpart of
cometbft_tpu/crypto/ed25519.py without its optional OpenSSL fast path;
reference: crypto/ed25519/ed25519.go).

Signing and single verification run in pure Python (about 4 ms per
operation).  Batch verification is the device path,
ops/ed25519_verify.TorchBatchVerifier, with ``CpuBatchVerifier`` (one
native RLC check per batch) as its host tier.
"""

from __future__ import annotations

import hashlib
import os
import time

from cometbft_tpu_torch.crypto import BatchVerifier, PrivKey, PubKey, edwards
from cometbft_tpu_torch.metrics import crypto_metrics as _crypto_metrics

KEY_TYPE = "ed25519"
PUB_KEY_SIZE = 32
PRIVATE_KEY_SIZE = 64  # seed || pubkey, matching the reference layout
SIGNATURE_SIZE = 64
SEED_SIZE = 32


class Ed25519PubKey(PubKey):
    __slots__ = ("_bytes", "_address")

    def __init__(self, data: bytes):
        if len(data) != PUB_KEY_SIZE:
            raise ValueError(f"ed25519 pubkey must be {PUB_KEY_SIZE} bytes")
        self._bytes = bytes(data)
        self._address: bytes | None = None

    def address(self) -> bytes:
        # computed once per key: a 1024-validator set's sort, proposer
        # step and lookups ask for every address several times a block
        if self._address is None:
            self._address = hashlib.sha256(self._bytes).digest()[:20]
        return self._address

    def bytes(self) -> bytes:
        return self._bytes

    def type(self) -> str:
        return KEY_TYPE

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        if len(sig) != SIGNATURE_SIZE:
            return False
        return edwards.verify_zip215(self._bytes, msg, sig)

    def __repr__(self) -> str:
        return f"PubKeyEd25519{{{self._bytes.hex().upper()}}}"


class Ed25519PrivKey(PrivKey):
    __slots__ = ("_seed", "_pub")

    def __init__(self, data: bytes):
        """Accepts a 32-byte seed or the 64-byte seed||pubkey layout."""
        if len(data) == PRIVATE_KEY_SIZE:
            data = data[:SEED_SIZE]
        if len(data) != SEED_SIZE:
            raise ValueError("ed25519 private key must be 32 or 64 bytes")
        self._seed = bytes(data)
        self._pub = Ed25519PubKey(edwards.public_key(self._seed))

    def bytes(self) -> bytes:
        """64-byte seed || pubkey, the reference's private-key layout."""
        return self._seed + self._pub.bytes()

    def sign(self, msg: bytes) -> bytes:
        return edwards.sign(self._seed, msg)

    def pub_key(self) -> Ed25519PubKey:
        return self._pub

    def type(self) -> str:
        return KEY_TYPE


def gen_priv_key() -> Ed25519PrivKey:
    """A fresh key from ``os.urandom`` (reference GenPrivKey)."""
    return Ed25519PrivKey(os.urandom(SEED_SIZE))


def priv_key_from_secret(secret: bytes) -> Ed25519PrivKey:
    """Deterministic key from a secret (reference GenPrivKeyFromSecret:
    seed = sha256(secret))."""
    return Ed25519PrivKey(hashlib.sha256(secret).digest())


class CpuBatchVerifier(BatchVerifier):
    """The host tier (a copy of cometbft_tpu/crypto/ed25519.py:131-200).

    A batch of NATIVE_MIN_BATCH or more signatures goes through ONE
    random-linear-combination check (csrc/host/ed25519_batch.cpp, a
    single Pippenger MSM over the batch, the reference's batch.go
    strategy on the host): an all-valid batch, the common case, costs
    one equation.  A failed check, or a smaller batch, verifies each
    signature for exact per-lane verdicts, as batch.go re-verifies on
    batch failure.  That per-signature pass is the big-int oracle
    (``edwards.verify_zip215``), where the reference uses OpenSSL.
    """

    #: from two signatures up the RLC check runs first: its fixed cost
    #: (about 3 ms on the host CPU of an H100 80GB HBM3 machine, its C
    #: bucket fold for the most part) is below that of the oracle's
    #: per-signature pass (3.4 to 6.2 ms a signature on that CPU), so
    #: the reference's 16, set against OpenSSL, would cost an evidence
    #: pair 12 ms for 3 (chip_smoke.py's host cells)
    NATIVE_MIN_BATCH = 2

    def __init__(self) -> None:
        self._entries: list[tuple[Ed25519PubKey, bytes, bytes]] = []

    def add(self, pub_key: PubKey, msg: bytes, sig: bytes) -> None:
        if not isinstance(pub_key, Ed25519PubKey):
            raise TypeError("CpuBatchVerifier requires ed25519 keys")
        if len(sig) != SIGNATURE_SIZE:
            raise ValueError("malformed signature size")
        self._entries.append((pub_key, bytes(msg), bytes(sig)))

    def __len__(self) -> int:
        return len(self._entries)

    def verify(self) -> tuple[bool, list[bool]]:
        if not self._entries:
            return False, []
        cm = _crypto_metrics()
        cm.batch_verify_batch_size.observe(len(self._entries))
        t0 = time.perf_counter()
        ok, results = self._verify_entries()
        cm.host_verify_time_seconds.observe(time.perf_counter() - t0)
        return ok, results

    def _verify_entries(self) -> tuple[bool, list[bool]]:
        if len(self._entries) >= self.NATIVE_MIN_BATCH:
            from cometbft_tpu_torch.crypto import ed25519_native as _native

            got = _native.rlc_verify(
                _native.load(), [(pk.bytes(), msg, sig) for pk, msg, sig in self._entries])
            if got:
                return True, [True] * len(self._entries)
        results = [pk.verify_signature(msg, sig) for pk, msg, sig in self._entries]
        return all(results), results
