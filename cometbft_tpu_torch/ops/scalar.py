"""Arithmetic mod the ed25519 group order L (the port of
cometbft_tpu/ops/scalar.py): the digest reduction k = SHA-512(...) mod L,
the canonical-S check, and the comb windows of k.

L = 2^252 + c (c ~ 2^124.4).  The 512-bit digest is reduced with
2^256 = -16c (mod L): three split-multiply-subtract rounds shrink it to
~256 bits, then one approximate-quotient step and two conditional
corrections give the canonical value.  Limbs are signed int64 base 2^16,
limbs-first ``(nlimbs, *batch)``; torch's ``>>`` on int64 is arithmetic,
as jnp's is, so negative intermediates carry the same way.
"""

from __future__ import annotations

import numpy as np
import torch

from cometbft_tpu_torch.crypto.edwards import L
from cometbft_tpu_torch.ops.field import cvec

LIMB_BITS = 16
MASK = (1 << LIMB_BITS) - 1


def _limbs_const(x: int, n: int) -> np.ndarray:
    return np.array(
        [(x >> (LIMB_BITS * i)) & MASK for i in range(n)], dtype=np.int64
    )


_C16 = 16 * (L - (1 << 252))          # 2^256 = -_C16 (mod L)
K_LIMBS = _limbs_const(_C16, 9)       # < 2^130
L_LIMBS = _limbs_const(L, 16)
L_PAD = _limbs_const(L, 17)           # L with a zero 17th limb
L16_LIMBS = _limbs_const(16 * L, 17)


def _resize(a: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad or cut the limb axis to ``n`` rows."""
    if a.shape[0] >= n:
        return a[:n]
    out = torch.zeros((n, *a.shape[1:]), dtype=a.dtype, device=a.device)
    out[: a.shape[0]] = a
    return out


def _mul_const(a: torch.Tensor, const_limbs: np.ndarray) -> torch.Tensor:
    """(na, *batch) limbs x host constant (nc limbs) -> (na+nc-1, *batch)
    columns."""
    na, nc = a.shape[0], len(const_limbs)
    out = torch.zeros((na + nc - 1, *a.shape[1:]), dtype=a.dtype,
                      device=a.device)
    for j in range(nc):
        if const_limbs[j]:
            out[j : j + na] += int(const_limbs[j]) * a
    return out


def _relax(c: torch.Tensor, iters: int) -> torch.Tensor:
    """Carry relaxation without modular wrap; the top limb keeps its own
    carry (stays lazy), so no value is discarded."""
    for _ in range(iters):
        carry = c >> LIMB_BITS
        carry[-1] = 0
        out = c - (carry << LIMB_BITS)
        out[1:] += carry[:-1]
        c = out
    return c


def _propagate(c: torch.Tensor):
    """Exact sequential pass -> (limbs in [0, 2^16), signed carry out)."""
    out = torch.empty_like(c)
    carry = torch.zeros_like(c[0])
    for i in range(c.shape[0]):
        t = c[i] + carry
        out[i] = t & MASK
        carry = t >> LIMB_BITS
    return out, carry


def _fold_step(n: torch.Tensor, width: int) -> torch.Tensor:
    """n (w, *batch) -> LO(16) - HI*16c, resized to ``width`` limbs."""
    prod = _mul_const(n[16:], K_LIMBS)
    w = max(width, prod.shape[0])
    out = _resize(n[:16], w) - _resize(prod, w)
    return _relax(out, 3)[:width]


def reduce_digest(digest_le: torch.Tensor) -> torch.Tensor:
    """(64, *batch) uint8 little-endian digest -> (16, *batch) int64
    canonical limbs of the value mod L."""
    dev, nd = digest_le.device, digest_le.dim()
    b = digest_le.to(torch.int64)
    n = b[0::2] + (b[1::2] << 8)                 # (32, *batch) limbs
    n = _fold_step(n, 25)                        # |n| < 2^390
    n = _fold_step(n, 18)                        # |n| < 2^265
    n = _fold_step(n, 17)                        # (-2^135, 2^256 + 2^135)
    # make positive: one add of 16L = 2^256 + 16c always suffices
    _, carry = _propagate(n)
    n = torch.where((carry < 0)[None], n + cvec(L16_LIMBS, nd, dev), n)
    limbs, _ = _propagate(n)                     # in [0, 2^262), 17 limbs
    # approximate quotient: q = floor(n / 2^252) < 2^10
    q = (limbs[15] >> 12) + (limbs[16] << 4)
    prod = _mul_const(q[None], L_LIMBS)          # lazy columns, 16 limbs
    n = limbs - _resize(prod, 17)                # (-2^135, 2^252 + 2^135)
    l_pad = cvec(L_PAD, nd, dev)
    _, carry = _propagate(n)
    n = torch.where((carry < 0)[None], n + l_pad, n)
    d, borrow = _propagate(n - l_pad)
    n = torch.where((borrow >= 0)[None], d, _propagate(n)[0])
    return n[:16]


def bytes_lt_l(s_bytes: torch.Tensor) -> torch.Tensor:
    """(32, *batch) uint8 little-endian -> bool mask: value < L (the
    canonical-S check, RFC 8032 / ZIP-215 rule 2)."""
    b = s_bytes.to(torch.int64)
    s = b[0::2] + (b[1::2] << 8)
    _, borrow = _propagate(s - cvec(L_LIMBS, s.dim(), s.device))
    return borrow < 0


def limbs_to_windows8(limbs16: torch.Tensor) -> torch.Tensor:
    """(16, *batch) canonical limbs -> (32, *batch) little-endian 8-bit
    windows (int32), for the 8-bit per-key combs."""
    lo = limbs16 & 0xFF
    hi = (limbs16 >> 8) & 0xFF
    win = torch.stack([lo, hi], dim=1).reshape(32, *limbs16.shape[1:])
    return win.to(torch.int32)


def limbs_to_nibbles(limbs16: torch.Tensor) -> torch.Tensor:
    """(16, *batch) canonical limbs -> (64, *batch) little-endian 4-bit
    windows (int32)."""
    nib = torch.stack([(limbs16 >> s) & 0xF for s in (0, 4, 8, 12)], dim=1)
    return nib.reshape(64, *limbs16.shape[1:]).to(torch.int32)


#: shape/dtype contracts (grammar: ops/contracts.py): the reference's
#: specs
_CONTRACTS = {
    "reduce_digest": {
        "args": {"digest_le": ("u8", (64, "B"))},
        "static": (),
        "out": ("i64", (16, "B")),
    },
    "bytes_lt_l": {
        "args": {"s_bytes": ("u8", (32, "B"))},
        "static": (),
        "out": ("bool", ("B",)),
    },
    "limbs_to_windows8": {
        "args": {"limbs16": ("i64", (16, "B"))},
        "static": (),
        "out": ("i32", (32, "B")),
    },
    "limbs_to_nibbles": {
        "args": {"limbs16": ("i64", (16, "B"))},
        "static": (),
        "out": ("i32", (64, "B")),
    },
}
