"""The secret connection's handshake and AEAD primitives (a copy of
cometbft_tpu/p2p/conn/crypto_fallback.py, which the reference uses only
when `cryptography` is missing; in the port it is the only path, since
the port does not import `cryptography`).

- **X25519**: a pure-Python RFC 7748 Montgomery ladder.  It runs twice
  per handshake (keygen + exchange), never per frame.
- **HKDF-SHA256**: ``hkdf_sha256`` below, the stdlib ``hmac``
  construction of RFC 5869 (bit-identical to OpenSSL's).
- **ChaCha20Poly1305**: a shim over the native frame pump's raw AEAD
  (``cmt_aead_seal``/``cmt_aead_open`` in csrc/host/frame_crypto.cpp,
  the library that seals whole write bursts), built by g++ through
  ops/_build.py; a failed build raises.

Only the surface secret_connection.py touches is provided
(generate / from_public_bytes / public_bytes_raw / exchange; encrypt /
decrypt; InvalidTag).
"""

from __future__ import annotations

import ctypes
import hashlib
import hmac
import os

from cometbft_tpu_torch.p2p.conn import frame_native

P = 2**255 - 19
_A24 = 121665


class InvalidTag(Exception):
    """AEAD authentication failure (the counterpart of
    cryptography.exceptions.InvalidTag)."""


def hkdf_sha256(secret: bytes, info: bytes, length: int) -> bytes:
    """RFC 5869 HKDF-SHA256 with a zero salt (HashLen zeros — what
    ``salt=None`` means in both RFC 5869 and the OpenSSL backend)."""
    prk = hmac.new(b"\x00" * 32, secret, hashlib.sha256).digest()
    okm = b""
    t = b""
    i = 1
    while len(okm) < length:
        t = hmac.new(prk, t + info + bytes([i]), hashlib.sha256).digest()
        okm += t
        i += 1
    return okm[:length]


def _x25519(k: int, u: int) -> int:
    """RFC 7748 §5 scalar multiplication on curve25519 (Montgomery
    ladder, constant structure; constant TIME is not a goal here — the
    exchanged keys are ephemeral per connection)."""
    x1 = u
    x2, z2 = 1, 0
    x3, z3 = u, 1
    swap = 0
    for t in reversed(range(255)):
        k_t = (k >> t) & 1
        swap ^= k_t
        if swap:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        swap = k_t
        a = (x2 + z2) % P
        aa = a * a % P
        b = (x2 - z2) % P
        bb = b * b % P
        e = (aa - bb) % P
        c = (x3 + z3) % P
        d = (x3 - z3) % P
        da = d * a % P
        cb = c * b % P
        x3 = (da + cb) % P
        x3 = x3 * x3 % P
        z3 = (da - cb) % P
        z3 = z3 * z3 % P
        z3 = z3 * x1 % P
        x2 = aa * bb % P
        z2 = e * (aa + _A24 * e) % P
    if swap:
        x2, x3 = x3, x2
        z2, z3 = z3, z2
    return x2 * pow(z2, P - 2, P) % P


def _clamp(k: bytes) -> int:
    b = bytearray(k)
    b[0] &= 248
    b[31] &= 127
    b[31] |= 64
    return int.from_bytes(bytes(b), "little")


def _decode_u(u: bytes) -> int:
    b = bytearray(u)
    b[31] &= 127  # RFC 7748: the top bit of the u-coordinate is masked
    return int.from_bytes(bytes(b), "little")


class X25519PublicKey:
    def __init__(self, data: bytes):
        if len(data) != 32:
            raise ValueError("x25519 public key must be 32 bytes")
        self._bytes = bytes(data)

    @classmethod
    def from_public_bytes(cls, data: bytes) -> "X25519PublicKey":
        return cls(data)

    def public_bytes_raw(self) -> bytes:
        return self._bytes


class X25519PrivateKey:
    def __init__(self, seed: bytes):
        if len(seed) != 32:
            raise ValueError("x25519 private key must be 32 bytes")
        self._seed = bytes(seed)

    @classmethod
    def generate(cls) -> "X25519PrivateKey":
        return cls(os.urandom(32))

    def public_key(self) -> X25519PublicKey:
        u = _x25519(_clamp(self._seed), 9)
        return X25519PublicKey(u.to_bytes(32, "little"))

    def exchange(self, peer: X25519PublicKey) -> bytes:
        u = _x25519(_clamp(self._seed), _decode_u(peer.public_bytes_raw()))
        return u.to_bytes(32, "little")


class ChaCha20Poly1305:
    """RFC 8439 AEAD over the native frame pump's raw seal/open."""

    def __init__(self, key: bytes):
        if len(key) != 32:
            raise ValueError("ChaCha20Poly1305 key must be 32 bytes")
        self._key = bytes(key)
        self._lib = frame_native.load()

    def encrypt(self, nonce: bytes, data: bytes, aad: bytes | None) -> bytes:
        aad = aad or b""
        out = (ctypes.c_uint8 * (len(data) + 16))()
        rc = self._lib.cmt_aead_seal(
            self._key, bytes(nonce), aad, len(aad), bytes(data), len(data),
            out, len(out),
        )
        if rc < 0:
            raise ValueError(f"aead seal failed (rc={rc})")
        return bytes(memoryview(out)[:rc])

    def decrypt(self, nonce: bytes, data: bytes, aad: bytes | None) -> bytes:
        aad = aad or b""
        out = (ctypes.c_uint8 * max(len(data), 16))()
        rc = self._lib.cmt_aead_open(
            self._key, bytes(nonce), aad, len(aad), bytes(data), len(data),
            out, len(out),
        )
        if rc < 0:
            raise InvalidTag("aead open failed")
        return bytes(memoryview(out)[:rc])
