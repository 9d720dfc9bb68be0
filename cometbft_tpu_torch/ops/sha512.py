"""SHA-512 of per-lane padded buffers (the port of
cometbft_tpu/ops/sha512.py): k = SHA-512(R || A || M) for every lane of
a verify batch.

Arrays are feature-first: byte buffers (nbytes, *batch) uint8, word
arrays (nwords, *batch).  ``sha512_padded`` is a hand-written CUDA
kernel (csrc/sha512.cu) for a CUDA tensor; for a CPU tensor it runs the
plain PyTorch version below.

The plain version carries the 64-bit words as **int64**: torch has no
uint64 add, shift, not or compare on the CPU.  Adds wrap in two's
complement (the same bits as uint64 adds), and a logical right shift is
the arithmetic shift masked to its low 64-n bits.

Round constants and IVs are derived from first principles (fractional
parts of cube/square roots of the first primes, FIPS 180-4); the kernel
source spells them out and the tests hold both to hashlib.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cometbft_tpu_torch.ops import _build


def _primes(n: int) -> list[int]:
    out, c = [], 2
    while len(out) < n:
        if all(c % q for q in out if q * q <= c):
            out.append(c)
        c += 1
    return out


def _icbrt(n: int) -> int:
    x = 1 << ((n.bit_length() + 2) // 3 + 1)
    while True:
        y = (2 * x + n // (x * x)) // 3
        if y >= x:
            return x
        x = y


def _signed(u: int) -> int:
    return u - (1 << 64) if u >= 1 << 63 else u


# K[t] = frac(cbrt(prime_t)) * 2^64 ; IV[i] = frac(sqrt(prime_i)) * 2^64,
# stored as the int64 with the same bits
K_U64 = [_icbrt(p << 192) & ((1 << 64) - 1) for p in _primes(80)]
IV_U64 = [math.isqrt(p << 128) & ((1 << 64) - 1) for p in _primes(8)]
_K = [_signed(k) for k in K_U64]
_IV = np.array([_signed(v) for v in IV_U64], dtype=np.int64)


def _shr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int64-carried uint64 words."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return _shr(x, n) | (x << (64 - n))


def _schedule(words: torch.Tensor) -> torch.Tensor:
    """(16, *batch) block words -> (80, *batch) expanded schedule."""
    w = list(words)
    for t in range(16, 80):
        w1, w14 = w[t - 15], w[t - 2]
        s0 = _rotr(w1, 1) ^ _rotr(w1, 8) ^ _shr(w1, 7)
        s1 = _rotr(w14, 19) ^ _rotr(w14, 61) ^ _shr(w14, 6)
        w.append(w[t - 16] + s0 + w[t - 7] + s1)
    return torch.stack(w)


def _compress(state: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """One SHA-512 block: state (8, *batch), words (16, *batch)."""
    w = _schedule(words)
    a, b, c, d, e, f, g, h = state
    for t in range(80):
        ch = (e & f) ^ (~e & g)
        maj = (a & b) ^ (a & c) ^ (b & c)
        big0 = _rotr(a, 28) ^ _rotr(a, 34) ^ _rotr(a, 39)
        big1 = _rotr(e, 14) ^ _rotr(e, 18) ^ _rotr(e, 41)
        t1 = h + big1 + ch + _K[t] + w[t]
        t2 = big0 + maj
        a, b, c, d, e, f, g, h = t1 + t2, a, b, c, d + t1, e, f, g
    return state + torch.stack([a, b, c, d, e, f, g, h])


_BYTE_SHIFTS = np.arange(56, -8, -8, dtype=np.int64)


def bytes_to_words(buf: torch.Tensor) -> torch.Tensor:
    """(n*8, *batch) uint8 big-endian -> (n, *batch) int64 words."""
    b = buf.to(torch.int64).reshape(buf.shape[0] // 8, 8, *buf.shape[1:])
    out = b[:, 0] << 56
    for k in range(1, 8):
        out = out | (b[:, k] << int(_BYTE_SHIFTS[k]))
    return out


def words_to_bytes(words: torch.Tensor) -> torch.Tensor:
    """(n, *batch) int64 words -> (n*8, *batch) uint8 big-endian."""
    parts = [(words >> int(s)) & 0xFF for s in _BYTE_SHIFTS]
    b = torch.stack(parts, dim=1)  # (n, 8, *batch)
    return b.to(torch.uint8).reshape(words.shape[0] * 8, *words.shape[1:])


def sha512_padded_plain(buf: torch.Tensor, nblocks: int,
                        nblocks_lane: torch.Tensor | None = None) -> torch.Tensor:
    """The plain PyTorch version of the sha512_padded kernel (any
    device): (nblocks*128, *batch) uint8 -> (64, *batch) uint8."""
    words = bytes_to_words(buf).reshape(nblocks, 16, *buf.shape[1:])
    iv = torch.as_tensor(_IV, device=buf.device).reshape(
        (8,) + (1,) * (buf.dim() - 1)
    )
    state = iv.expand(8, *buf.shape[1:]).clone()
    for i in range(nblocks):
        new = _compress(state, words[i])
        if nblocks_lane is None:
            state = new
        else:
            state = torch.where((i < nblocks_lane)[None], new, state)
    return words_to_bytes(state)


def sha512_padded(buf: torch.Tensor, nblocks: int,
                  nblocks_lane: torch.Tensor | None = None) -> torch.Tensor:
    """Digest of a pre-padded buffer: (nblocks*128, *batch) uint8 ->
    (64, *batch) uint8.

    The caller supplies full padding (0x80 marker + big-endian bit
    length; see ed25519_verify.build_padded_input).  ``nblocks_lane``
    (*batch,) int64 says how many blocks each lane absorbs (minimal
    per-message padding under a shared bucket width); None means all.
    A CUDA tensor goes through the sha512_padded kernel."""
    if buf.dtype != torch.uint8 or buf.shape[0] != nblocks * 128:
        raise ValueError(
            f"sha512_padded: expected ({nblocks * 128}, *batch) uint8, got "
            f"{tuple(buf.shape)} {buf.dtype}"
        )
    if buf.device.type == "cpu":
        return sha512_padded_plain(buf, nblocks, nblocks_lane)
    if buf.device.type != "cuda":
        raise ValueError(f"sha512_padded: unsupported device {buf.device}")
    batch = buf.shape[1:]
    flat = buf.reshape(buf.shape[0], -1).contiguous()
    n = flat.shape[1]
    if nblocks_lane is None:
        lanes = torch.full((n,), nblocks, dtype=torch.int64, device=buf.device)
    else:
        if nblocks_lane.device != buf.device or nblocks_lane.shape != batch:
            raise ValueError("sha512_padded: nblocks_lane must be (*batch,) "
                             "on the buffer's device")
        lanes = nblocks_lane.to(torch.int64).reshape(n).contiguous()
    out = torch.empty((64, n), dtype=torch.uint8, device=buf.device)
    rc = _build.library("sha512").sha512_padded_launch(
        flat.data_ptr(), nblocks, lanes.data_ptr(), out.data_ptr(), n,
        torch.cuda.current_stream(buf.device).cuda_stream,
    )
    _build.check(rc, "sha512_padded")
    _build.LAUNCHES["sha512_padded"] += 1
    return out.reshape(64, *batch)


def pad_message(msg_bytes: bytes) -> tuple[np.ndarray, int]:
    """Host-side reference padding (tests): returns (padded, nblocks)."""
    n = len(msg_bytes)
    nblocks = (n + 1 + 16 + 127) // 128
    buf = np.zeros(nblocks * 128, dtype=np.uint8)
    buf[:n] = np.frombuffer(msg_bytes, dtype=np.uint8)
    buf[n] = 0x80
    bitlen = n * 8
    for j in range(16):
        buf[-1 - j] = (bitlen >> (8 * j)) & 0xFF
    return buf, nblocks


#: shape/dtype contracts (grammar: ops/contracts.py).  The port's
#: message words are int64 (the reference's uint64): torch's uint64
#: lacks the shifts the rounds use.
_CONTRACTS = {
    "sha512_padded": {
        "on": "cpu",
        "args": {
            "buf": ("u8", ("nblocks*128", "B")),
            "nblocks_lane": ("i64", ("B",)),
        },
        "static": ("nblocks",),
        "out": ("u8", (64, "B")),
    },
    "bytes_to_words": {
        "args": {"buf": ("u8", ("nblocks*128", "B"))},
        "static": (),
        "out": ("i64", ("nblocks*16", "B")),
    },
    "words_to_bytes": {
        "args": {"words": ("i64", (8, "B"))},
        "static": (),
        "out": ("u8", (64, "B")),
    },
}
