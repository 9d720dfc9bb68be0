"""GF(2^255-19) arithmetic on 26 x 10-bit int32 limbs (the port of
cometbft_tpu/ops/field.py).

The number system is the reference's, so results compare limb for limb:
a field element is a limbs-first ``(26, *batch)`` int32 tensor, radix
2^10, and a carry out of limb 25 re-enters limb 0 with weight
2^260 mod p = 608.  add/sub are plain tensor adds with no carry work;
**multiply inputs may carry at most 2 chained add/subs** on a multiply
output (|limb| < 2^13, so 26 * 2^13 * 2^13 < 2^31).  Lazy limbs may be
negative; every shift is arithmetic.

The multiply and the square are hand-written CUDA: device functions in
csrc/field.cuh, which the fused kernels (verify_keyed, verify_generic,
build_tables) call, and the standalone kernels ``fe_mul`` and ``fe_sq``
(csrc/field.cu), which no path launches: on a CUDA tensor they serve the
plain versions of the fused kernels (the curve formulas).  Their
wrappers take the kernel for a CUDA tensor and the plain PyTorch
version in this module for a CPU tensor; the plain version repeats the
kernel's arithmetic exactly and is what the tests and chip_smoke.py
hold the kernel to.
"""

from __future__ import annotations

import numpy as np
import torch

from cometbft_tpu_torch.crypto.edwards import P
from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import jitguard as _jitguard
from cometbft_tpu_torch.utils.env import flag_from_env

NLIMBS = 26
LIMB_BITS = 10
MASK = (1 << LIMB_BITS) - 1
CAPACITY = NLIMBS * LIMB_BITS  # 260
DTYPE = torch.int32

WRAP = (1 << (CAPACITY - 255)) * 19  # 608
assert pow(2, CAPACITY, P) == WRAP

#: the operand budget of mul/square, checked by the plain version when
#: CMT_TPU_DEBUG_CHECKS=1 (the kernel wraps exactly as the plain
#: version does, so an out-of-budget input shows on the CPU too)
LIMB_BUDGET = 1 << 13
_DEBUG_CHECKS = flag_from_env("CMT_TPU_DEBUG_CHECKS")


# -- host-side conversions (tests, table generation) -------------------

def from_int(x: int) -> np.ndarray:
    """Python int -> (26,) limb array (host helper)."""
    if x < 0 or x >= 1 << 256:
        raise ValueError("field element out of range")
    return np.array(
        [(x >> (LIMB_BITS * i)) & MASK for i in range(NLIMBS)], dtype=np.int32
    )


def to_int(limbs) -> int:
    """(26, ...) limbs -> python int of lane 0 if batched, or of the
    single element (host helper; accepts lazy/signed limbs)."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.cpu().numpy()
    arr = np.asarray(limbs, dtype=np.int64).reshape(NLIMBS, -1)[:, 0]
    return sum(int(arr[i]) << (LIMB_BITS * i) for i in range(NLIMBS))


def batch_from_ints(xs: list[int]) -> np.ndarray:
    """ints -> (26, n) limbs-first batch."""
    return np.stack([from_int(x) for x in xs], axis=-1)


P_LIMBS = from_int(P)
ZERO = from_int(0)
ONE = from_int(1)

_const_cache: dict[tuple[int, str], tuple[np.ndarray, torch.Tensor]] = {}


def const(c: np.ndarray, device) -> torch.Tensor:
    """A host constant as a tensor on ``device``, uploaded once per
    (constant, device).  Keyed by the array's identity: callers pass
    module-level constants, which the cache also keeps alive."""
    key = (id(c), str(device))
    hit = _const_cache.get(key)
    if hit is None:
        with _jitguard.audited():
            hit = (c, torch.as_tensor(c).to(device))
        _const_cache[key] = hit
    return hit[1]


def cvec(c: np.ndarray, ndim: int, device) -> torch.Tensor:
    """A host (k,)-constant shaped (k, 1, ..., 1) to broadcast against a
    limbs-first (k, *batch) array with ``ndim`` dimensions."""
    return const(c, device).reshape((c.shape[0],) + (1,) * (ndim - 1))


# -- carry machinery (the plain versions' building blocks) -------------

def relax(c: torch.Tensor, iters: int = 4) -> torch.Tensor:
    """Vectorized carry relaxation: every limb releases its carry at
    once, the top carry folding into limb 0 as x608."""
    for _ in range(iters):
        carry = c >> LIMB_BITS
        out = c & MASK
        out[1:] += carry[:-1]
        out[0] += carry[-1] * WRAP
        c = out
    return c


def _fold_high(cols: torch.Tensor) -> torch.Tensor:
    """51 columns -> 26 lazy limbs: the 25 high columns relax as their
    own 27-row block (2 shift-only passes), then fold x608 (row 26,
    weight 2^520, x608^2)."""
    high = torch.zeros((NLIMBS + 1, *cols.shape[1:]), dtype=DTYPE,
                       device=cols.device)
    high[: NLIMBS - 1] = cols[NLIMBS:]
    for _ in range(2):
        carry = high >> LIMB_BITS
        high = high & MASK
        high[1:] += carry[:-1]
    low = cols[:NLIMBS] + high[:NLIMBS] * WRAP
    low[0] += high[NLIMBS] * (WRAP * WRAP)
    return low


def _columns(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The 51 schoolbook columns of a*b, one shifted row at a time (no
    (26, 51, batch) stack: the plain table build multiplies ~10^6 lanes)."""
    cols = torch.zeros((2 * NLIMBS - 1, *b.shape[1:]), dtype=DTYPE,
                       device=b.device)
    for i in range(NLIMBS):
        cols[i : i + NLIMBS] += a[i] * b
    return cols


def _square_columns(a: torch.Tensor) -> torch.Tensor:
    """Columns of a*a: cols[j] = sum_{i < j-i} 2a[i]a[j-i] + (j even)
    a[j/2]^2 -- 351 products instead of 676."""
    cols = torch.zeros((2 * NLIMBS - 1, *a.shape[1:]), dtype=DTYPE,
                       device=a.device)
    d = a + a
    cols[0::2] += a * a
    for i in range(NLIMBS - 1):
        cols[2 * i + 1 : i + NLIMBS] += d[i] * a[i + 1 :]
    return cols


def _budget_check(*ops: torch.Tensor) -> None:
    for op in ops:
        m = int(op.abs().max()) if op.numel() else 0
        if m >= LIMB_BUDGET:
            raise OverflowError(
                f"field operand limb overflow: max |limb| = {m} >= 2^13; "
                "an operand exceeded the 2-chained-add budget"
            )


def mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of ``fe_mul`` (any device)."""
    a, b = torch.broadcast_tensors(a, b)
    if _DEBUG_CHECKS:
        _budget_check(a, b)
    return relax(_fold_high(_columns(a, b)))


def square_plain(a: torch.Tensor, n: int = 1) -> torch.Tensor:
    """The plain PyTorch version of ``fe_sq``: a^(2^n)."""
    for _ in range(n):
        if _DEBUG_CHECKS:
            _budget_check(a)
        a = relax(_fold_high(_square_columns(a)))
    return a


# -- the kernel wrappers -----------------------------------------------

def _flat_cuda(t: torch.Tensor, shape) -> torch.Tensor:
    t = t.broadcast_to(shape)
    if t.dtype != DTYPE:
        raise TypeError(f"field limbs must be int32, got {t.dtype}")
    return t.reshape(NLIMBS, -1).contiguous()


def fe_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Field multiply of (26, *batch) int32 lazy limbs (operands
    broadcast against each other).  Output limbs < 2^11.  A CUDA tensor
    goes through the fe_mul kernel, a CPU tensor through mul_plain."""
    # torch.broadcast_shapes costs ~17 us of host time: skip it in the
    # common equal-shape case
    shape = a.shape if a.shape == b.shape else torch.broadcast_shapes(a.shape, b.shape)
    if shape[0] != NLIMBS:
        raise ValueError(f"expected (26, *batch) limbs, got {tuple(shape)}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mul_plain(a, b)
    if a.device.type != "cuda" or a.device != b.device:
        raise ValueError(f"fe_mul: operands on {a.device} and {b.device}")
    af, bf = _flat_cuda(a, shape), _flat_cuda(b, shape)
    out = torch.empty_like(af)
    n = af.shape[1]
    rc = _build.library("field").fe_mul_launch(
        af.data_ptr(), bf.data_ptr(), out.data_ptr(), n,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    _build.check(rc, "fe_mul")
    _build.LAUNCHES["fe_mul"] += 1
    return out.reshape(shape)


def fe_sq(a: torch.Tensor, n: int = 1) -> torch.Tensor:
    """a^(2^n) by n field squarings -- one launch of the fe_sq kernel
    for a CUDA tensor (the repeats stay in registers), square_plain for
    a CPU tensor."""
    if a.shape[0] != NLIMBS:
        raise ValueError(f"expected (26, *batch) limbs, got {tuple(a.shape)}")
    if n < 1:
        raise ValueError(f"fe_sq: repeat count must be >= 1, got {n}")
    if a.device.type == "cpu":
        return square_plain(a, n)
    if a.device.type != "cuda":
        raise ValueError(f"fe_sq: unsupported device {a.device}")
    af = _flat_cuda(a, a.shape)
    out = torch.empty_like(af)
    rc = _build.library("field").fe_sq_launch(
        af.data_ptr(), out.data_ptr(), af.shape[1], n,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    _build.check(rc, "fe_sq")
    _build.LAUNCHES["fe_sq"] += 1
    return out.reshape(a.shape)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return fe_mul(a, b)


def square(a: torch.Tensor) -> torch.Tensor:
    return fe_sq(a, 1)


def add(a, b):
    """Lazy add: no carries (grows the limb bound by one bit)."""
    return a + b


def sub(a, b):
    """Lazy subtract: no carries (limbs may go negative)."""
    return a - b


def neg(a):
    return -a


def mul_small(a, k: int):
    """Multiply by a small host constant; lazy."""
    return a * k


# -- canonical form, comparisons ---------------------------------------

def _propagate_seq(c: torch.Tensor):
    """Exact sequential carry pass: limbs to [0, 2^10), returning
    (limbs, signed carry out of weight 2^260)."""
    out = torch.empty_like(c)
    carry = torch.zeros_like(c[0])
    for i in range(NLIMBS):
        t = c[i] + carry
        out[i] = t & MASK
        carry = t >> LIMB_BITS
    return out, carry


def _narrow(a: torch.Tensor) -> torch.Tensor:
    """Lazy limbs -> limbs in [0, 2^10) with the value in [0, 2p)."""
    limbs, carry = _propagate_seq(relax(a.clone(), iters=2))
    limbs[0] += WRAP * carry
    limbs, carry = _propagate_seq(limbs)
    limbs[0] += WRAP * carry
    limbs, _ = _propagate_seq(limbs)
    # value < 2^260; split the top limb at bit 255: t*2^250 becomes
    # 19*(t >> 5) at limb 0 + (t & 31)*2^250
    t = limbs[NLIMBS - 1].clone()
    limbs[NLIMBS - 1] = t & 31
    limbs[0] += 19 * (t >> 5)
    limbs, _ = _propagate_seq(limbs)
    return limbs


def _cond_sub_p(limbs: torch.Tensor) -> torch.Tensor:
    """Subtract p when limbs >= p; narrow form in and out."""
    diff, borrow = _propagate_seq(limbs - cvec(P_LIMBS, limbs.dim(), limbs.device))
    return torch.where((borrow >= 0)[None], diff, limbs)


def reduce_full(a: torch.Tensor) -> torch.Tensor:
    """Lazy form -> canonical [0, p)."""
    return _cond_sub_p(_cond_sub_p(_narrow(a)))


def eq(a, b) -> torch.Tensor:
    """Canonical equality of lazy elements, per lane."""
    return (reduce_full(sub(a, b)) == 0).all(dim=0)


def is_zero(a) -> torch.Tensor:
    return (reduce_full(a) == 0).all(dim=0)


def is_odd(a) -> torch.Tensor:
    """Low bit of the canonical value."""
    return (reduce_full(a)[0] & 1).bool()


def select(mask, a, b):
    """Per-lane select: mask (*batch,), a/b (26, *batch)."""
    return torch.where(mask[None], a, b)


# -- byte conversions (bytes are feature-first (32, *batch) uint8) -----

# limb i covers bits [10i, 10i+10): three byte taps starting at 10i//8.
_FB_IDX = np.array([(10 * i) // 8 for i in range(NLIMBS)], dtype=np.int64)
_FB_IDX1 = _FB_IDX + 1
_FB_IDX2 = _FB_IDX + 2
_FB_SHIFT = np.array([(10 * i) % 8 for i in range(NLIMBS)], dtype=np.int32)
# byte j covers bits [8j, 8j+8): two limb taps starting at 8j//10.
_TB_IDX = np.array([(8 * j) // 10 for j in range(32)], dtype=np.int64)
_TB_IDX1 = _TB_IDX + 1
_TB_SHIFT = np.array([(8 * j) % 10 for j in range(32)], dtype=np.int32)


def from_bytes_le(b: torch.Tensor) -> torch.Tensor:
    """(32, *batch) uint8 -> narrow limbs (value < 2^256, unreduced)."""
    dev = b.device
    ext = torch.zeros((34, *b.shape[1:]), dtype=DTYPE, device=dev)
    ext[:32] = b
    word = (
        ext.index_select(0, const(_FB_IDX, dev))
        | (ext.index_select(0, const(_FB_IDX1, dev)) << 8)
        | (ext.index_select(0, const(_FB_IDX2, dev)) << 16)
    )
    return (word >> cvec(_FB_SHIFT, b.dim(), dev)) & MASK


def to_bytes_le(a: torch.Tensor) -> torch.Tensor:
    """Canonical little-endian bytes, shape (32, *batch) uint8."""
    dev = a.device
    r = torch.zeros((NLIMBS + 1, *a.shape[1:]), dtype=DTYPE, device=dev)
    r[:NLIMBS] = reduce_full(a)
    word = r.index_select(0, const(_TB_IDX, dev)) | (
        r.index_select(0, const(_TB_IDX1, dev)) << LIMB_BITS
    )
    return ((word >> cvec(_TB_SHIFT, a.dim(), dev)) & 0xFF).to(torch.uint8)


# -- exponentiation chains ---------------------------------------------

def _pow2k(a: torch.Tensor, k: int) -> torch.Tensor:
    """k successive squarings: one fe_sq launch on the card."""
    return fe_sq(a, k)


def pow22523(z):
    """z^((p-5)/8), the square-root chain core (ref10-style addition
    chain: 254 squarings, 11 multiplies)."""
    t0 = square(z)                      # z^2
    t1 = _pow2k(t0, 2)                  # z^8
    t1 = mul(z, t1)                     # z^9
    t0 = mul(t0, t1)                    # z^11
    t0 = square(t0)                     # z^22
    t0 = mul(t1, t0)                    # z^31 = z^(2^5-1)
    t1 = _pow2k(t0, 5)                  # z^(2^10-2^5)
    t0 = mul(t1, t0)                    # z^(2^10-1)
    t1 = _pow2k(t0, 10)
    t1 = mul(t1, t0)                    # z^(2^20-1)
    t2 = _pow2k(t1, 20)
    t1 = mul(t2, t1)                    # z^(2^40-1)
    t1 = _pow2k(t1, 10)
    t0 = mul(t1, t0)                    # z^(2^50-1)
    t1 = _pow2k(t0, 50)
    t1 = mul(t1, t0)                    # z^(2^100-1)
    t2 = _pow2k(t1, 100)
    t1 = mul(t2, t1)                    # z^(2^200-1)
    t1 = _pow2k(t1, 50)
    t0 = mul(t1, t0)                    # z^(2^250-1)
    t0 = _pow2k(t0, 2)                  # z^(2^252-4)
    return mul(t0, z)                   # z^(2^252-3) = z^((p-5)/8)


def invert(z):
    """z^(p-2) = z^(2^255-21) (ref10-style chain)."""
    t0 = square(z)                      # z^2
    t1 = _pow2k(t0, 2)                  # z^8
    t1 = mul(z, t1)                     # z^9
    t0 = mul(t0, t1)                    # z^11
    t2 = square(t0)                     # z^22
    t1 = mul(t1, t2)                    # z^31
    t2 = _pow2k(t1, 5)
    t1 = mul(t2, t1)                    # z^(2^10-1)
    t2 = _pow2k(t1, 10)
    t2 = mul(t2, t1)                    # z^(2^20-1)
    t3 = _pow2k(t2, 20)
    t2 = mul(t3, t2)                    # z^(2^40-1)
    t2 = _pow2k(t2, 10)
    t1 = mul(t2, t1)                    # z^(2^50-1)
    t2 = _pow2k(t1, 50)
    t2 = mul(t2, t1)                    # z^(2^100-1)
    t3 = _pow2k(t2, 100)
    t2 = mul(t3, t2)                    # z^(2^200-1)
    t2 = _pow2k(t2, 50)
    t1 = mul(t2, t1)                    # z^(2^250-1)
    t1 = _pow2k(t1, 5)                  # z^(2^255-32)
    return mul(t1, t0)                  # z^(2^255-21) = z^(p-2)


#: shape/dtype contracts (grammar: ops/contracts.py): the reference's
#: specs, limbs first
_CONTRACTS = {
    "from_bytes_le": {
        "args": {"b": ("u8", (32, "B"))},
        "static": (),
        "out": ("i32", ("NLIMBS", "B")),
    },
    "to_bytes_le": {
        "args": {"a": ("i32", ("NLIMBS", "B"))},
        "static": (),
        "out": ("u8", (32, "B")),
    },
    "reduce_full": {
        "args": {"a": ("i32", ("NLIMBS", "B"))},
        "static": (),
        "out": ("i32", ("NLIMBS", "B")),
    },
    "mul": {
        "on": "cpu",
        "args": {"a": ("i32", ("NLIMBS", "B")), "b": ("i32", ("NLIMBS", "B"))},
        "static": (),
        "out": ("i32", ("NLIMBS", "B")),
    },
    "square": {
        "on": "cpu",
        "args": {"a": ("i32", ("NLIMBS", "B"))},
        "static": (),
        "out": ("i32", ("NLIMBS", "B")),
    },
    "fe_mul": {
        "on": "cpu",
        "args": {"a": ("i32", ("NLIMBS", "B")), "b": ("i32", ("NLIMBS", "B"))},
        "static": (),
        "out": ("i32", ("NLIMBS", "B")),
    },
    "fe_sq": {
        "on": "cpu",
        "args": {"a": ("i32", ("NLIMBS", "B"))},
        "static": (),
        "out": ("i32", ("NLIMBS", "B")),
    },
}
