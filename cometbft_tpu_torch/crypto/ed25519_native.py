"""ctypes binding for the host RLC batch verifier
(csrc/host/ed25519_batch.cpp; a copy of
cometbft_tpu/crypto/ed25519_native.py:54-109).

One C call checks a whole batch with a random-linear-combination
equation, the host-side analog of the reference's ed25519consensus
batch verifier (crypto/ed25519/batch.go).  Python computes every
SCALAR in big-int arithmetic (the SHA-512 challenges k_i, the random
128-bit weights z_i, the mod-L products); the C++ does only curve work
(ZIP-215 decompression, one Pippenger MSM, the cofactor-8 identity
check).

The library is built by g++ at first use (ops/_build.py); a failed
build raises with the compiler's stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os

from cometbft_tpu_torch.crypto.edwards import B_POINT, L, encode_point
from cometbft_tpu_torch.metrics import crypto_metrics as _crypto_metrics
from cometbft_tpu_torch.ops import _build

_B_ENC = encode_point(B_POINT)


def load() -> ctypes.CDLL:
    """The host library, built at first use."""
    return _build.library("ed25519_batch")


def rlc_verify(lib: ctypes.CDLL, entries: list[tuple[bytes, bytes, bytes]],
               weights=None) -> bool | None:
    """One RLC check over ``entries`` = [(pub32, msg, sig64), ...].

    Returns True (every signature valid), False (at least one invalid
    OR a malformed scalar/point: the caller re-verifies each signature)
    or None for an empty batch.  Entries must have 64-byte signatures.

    The equation (edwards.verify_zip215 batched):
      [8]([c]B + sum[z_i](-R_i) + sum[(z_i k_i) mod L](-A_i)) == id
    with c = sum z_i s_i mod L and independent random 128-bit z_i: a
    forged signature survives with probability ~2^-128, and only while
    the weights are unpredictable, so they come from ``os.urandom``.
    ``weights``, an iterable of 16-byte draws, replays a fixed draw
    (tests only; the verify path never passes it).
    """
    n = len(entries)
    if n == 0:
        return None
    draws = iter(weights) if weights is not None else None
    # unique-key table: commits verify many sigs under few keys, so the
    # C side decompresses each key once
    key_ids: dict[bytes, int] = {}
    idx = (ctypes.c_int32 * n)()
    rs = bytearray()
    za = bytearray()
    zr = bytearray()
    c_acc = 0
    for i, (pub, msg, sig) in enumerate(entries):
        s = int.from_bytes(sig[32:], "little")
        if s >= L:
            return False  # the oracle rejects; the per-signature pass reports lanes
        idx[i] = key_ids.setdefault(pub, len(key_ids))
        rs += sig[:32]
        k = int.from_bytes(hashlib.sha512(sig[:32] + pub + msg).digest(), "little") % L
        draw = next(draws) if draws is not None else os.urandom(16)
        z = int.from_bytes(draw, "little") | 1
        za += (z * k % L).to_bytes(32, "little")
        zr += z.to_bytes(32, "little")
        c_acc = (c_acc + z * s) % L
    upubs = b"".join(key_ids)  # dict preserves insertion order
    _crypto_metrics().batch_verify_launches.labels(kernel="host_rlc").inc()
    rc = lib.cmt_ed25519_rlc_verify(
        upubs, idx, bytes(rs), _B_ENC, bytes(za), bytes(zr),
        c_acc.to_bytes(32, "little"), len(key_ids), n,
    )
    # rc < 0: a point failed to decode; the oracle rejects those lanes,
    # so the batch is treated as failed
    return rc == 1
