"""edwards25519 group operations (the port of cometbft_tpu/ops/curve.py):
the point formulas and ZIP-215 decompression that both verify tiers use,
and the generic tier's scalar multiplications -- [S]B over the 4-bit
comb of B (``B_COMB``, ``comb_mul_base``) and [k]P by windowed
double-and-add (``window_mul``).

Points are tuples (X, Y, Z, T) of lazy field elements, each a
limbs-first ``(26, *batch)`` int32 tensor: extended twisted Edwards
coordinates with a=-1 ("Twisted Edwards Curves Revisited", Hisil et al.
2008), whose unified formulas need no per-lane branch.  Every coordinate
produced here is a multiply output (limbs < 2^11) and the formulas
chain at most 2 add/subs before the next multiply -- the field
multiply's operand budget (ops/field.py).

Encodings are feature-first (32, *batch) uint8, scalar windows
(64, *batch) int32.
"""

from __future__ import annotations

import numpy as np
import torch

from cometbft_tpu_torch.crypto import edwards as _ref
from cometbft_tpu_torch.ops import field as F

D_LIMBS = F.from_int(_ref.D)
TWO_D_LIMBS = F.from_int(2 * _ref.D % _ref.P)
SQRT_M1_LIMBS = F.from_int(_ref.SQRT_M1)

WINDOWS = 64  # 4-bit windows over 256-bit scalars


def niels_from_affine(x: int, y: int) -> np.ndarray:
    """(y+x, y-x, 2dxy) limbs -- shape (3, 26)."""
    return np.stack(
        [
            F.from_int((y + x) % _ref.P),
            F.from_int((y - x) % _ref.P),
            F.from_int(2 * _ref.D * x * y % _ref.P),
        ]
    )


def _build_comb_table() -> np.ndarray:
    """COMB[w][j] = j * 16^w * B as affine-Niels triples, (64, 16, 3,
    26) int32, from the oracle.  j = 0 is the Niels identity (1, 1, 0),
    which the mixed add treats as a no-op projectively, so a lookup needs
    no identity branch."""
    table = np.zeros((WINDOWS, 16, 3, F.NLIMBS), dtype=np.int32)
    base = _ref.B_POINT
    for w in range(WINDOWS):
        acc = _ref.IDENTITY
        for j in range(16):
            if j == 0:
                table[w, j] = np.stack([F.ONE, F.ONE, F.ZERO])
            else:
                acc = _ref.pt_add(acc, base)
                table[w, j] = niels_from_affine(*_ref.pt_to_affine(acc))
        for _ in range(4):
            base = _ref.pt_double(base)
    return table


B_COMB = _build_comb_table()  # (64, 16, 3, 26) int32


def identity(batch_shape, device) -> tuple:
    z = torch.zeros((F.NLIMBS, *batch_shape), dtype=F.DTYPE, device=device)
    one = F.cvec(F.ONE, 1 + len(batch_shape), device).expand(
        F.NLIMBS, *batch_shape
    )
    return (z, one, one, z)


def pt_add(p, q):
    """Unified extended addition (add-2008-hwcd-3, a=-1, k=2d)."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = F.mul(F.sub(y1, x1), F.sub(y2, x2))
    b = F.mul(F.add(y1, x1), F.add(y2, x2))
    c = F.mul(F.mul(t1, F.cvec(TWO_D_LIMBS, t1.dim(), t1.device)), t2)
    dd = F.mul_small(F.mul(z1, z2), 2)
    e = F.sub(b, a)
    f = F.sub(dd, c)
    g = F.add(dd, c)
    h = F.add(b, a)
    return (F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h))


def pt_add_niels(p, n):
    """Mixed add with an affine Niels point (y+x, y-x, 2dxy, Z=1)."""
    x1, y1, z1, t1 = p
    yplus, yminus, xy2d = n
    a = F.mul(F.sub(y1, x1), yminus)
    b = F.mul(F.add(y1, x1), yplus)
    c = F.mul(t1, xy2d)
    dd = F.mul_small(z1, 2)
    e = F.sub(b, a)
    f = F.sub(dd, c)
    g = F.add(dd, c)
    h = F.add(b, a)
    return (F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h))


def pt_add_pniels(p, n):
    """Mixed add with a projective Niels point (Y2+X2, Y2-X2, 2*Z2,
    2d*T2) -- one multiply more than the affine-Niels add; the per-key
    tables (ops/precompute.py) keep their projective Z."""
    x1, y1, z1, t1 = p
    yplus, yminus, z2dbl, t2d = n
    a = F.mul(F.sub(y1, x1), yminus)
    b = F.mul(F.add(y1, x1), yplus)
    c = F.mul(t1, t2d)
    dd = F.mul(z1, z2dbl)
    e = F.sub(b, a)
    f = F.sub(dd, c)
    g = F.add(dd, c)
    h = F.add(b, a)
    return (F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h))


def pt_double(p):
    """Doubling (dbl-2008-hwcd)."""
    x1, y1, z1, _ = p
    a = F.square(x1)
    b = F.square(y1)
    c = F.mul_small(F.square(z1), 2)
    h = F.add(a, b)
    e = F.sub(h, F.square(F.add(x1, y1)))
    g = F.sub(a, b)
    f = F.add(c, g)
    return (F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h))


def pt_neg(p):
    x, y, z, t = p
    return (F.neg(x), y, z, F.neg(t))


def pt_is_identity(p) -> torch.Tensor:
    """X == 0 and Y == Z (projective identity test)."""
    x, y, z, _ = p
    return F.is_zero(x) & F.eq(y, z)


def mul8(p):
    """[8]P -- the cofactor clearing in the ZIP-215 equation."""
    return pt_double(pt_double(pt_double(p)))


def decompress(enc: torch.Tensor):
    """(32, *batch) uint8 -> (point, valid mask).

    ZIP-215 (crypto/ed25519/ed25519.go:39): the 255-bit y is reduced mod
    p implicitly (non-canonical encodings accepted), x = 0 with the sign
    bit set ("-0") is accepted, and only a non-square x^2 candidate is
    rejected.  Matches crypto/edwards.decode_point."""
    dev, nd = enc.device, enc.dim()
    sign = (enc[31] >> 7).to(F.DTYPE)
    y = F.from_bytes_le(enc)
    # clear bit 255: limb 25 covers bits [250, 260), so bit 255 is its bit 5
    y[F.NLIMBS - 1] -= sign << 5
    yy = F.square(y)
    one = F.cvec(F.ONE, nd, dev)
    u = F.sub(yy, one)
    v = F.add(F.mul(yy, F.cvec(D_LIMBS, nd, dev)), one)
    v3 = F.mul(F.square(v), v)
    v7 = F.mul(F.square(v3), v)
    x = F.mul(F.mul(u, v3), F.pow22523(F.mul(u, v7)))
    vxx = F.mul(v, F.square(x))
    ok1 = F.eq(vxx, u)
    ok2 = F.eq(vxx, F.neg(u))
    x = F.select(ok2, F.mul(x, F.cvec(SQRT_M1_LIMBS, nd, dev)), x)
    valid = ok1 | ok2
    flip = F.is_odd(x) != (sign == 1)
    x = F.select(flip, F.neg(x), x)
    z = one.expand(y.shape)
    return (x, y, z, F.mul(x, y)), valid


# -- the generic tier's scalar multiplications --------------------------

def nibbles_from_bytes_le(b: torch.Tensor) -> torch.Tensor:
    """(32, *batch) uint8 scalar -> (64, *batch) int32 4-bit windows,
    little-endian (window w has weight 16^w)."""
    b = b.to(torch.int32)
    return torch.stack([b & 0xF, b >> 4], dim=1).reshape(64, *b.shape[1:])


def comb_mul_base(s_nibbles: torch.Tensor, table: torch.Tensor | None = None):
    """[S]B via the 4-bit Niels comb: 64 table lookups and mixed adds.
    s_nibbles (64, *batch) int32; ``table`` is B_COMB on their device
    (uploaded once if None).  Returns an extended point."""
    dev, batch = s_nibbles.device, s_nibbles.shape[1:]
    if table is None:
        table = F.const(B_COMB, dev)
    acc = identity(batch, dev)
    for w in range(WINDOWS):
        idx = s_nibbles[w].reshape(-1).to(torch.int64)
        e = table[w].index_select(0, idx)                  # (B, 3, 26)
        e = e.permute(1, 2, 0).reshape(3, F.NLIMBS, *batch)
        acc = pt_add_niels(acc, (e[0], e[1], e[2]))
    return acc


def window_mul(k_nibbles: torch.Tensor, p):
    """[k]P for a per-lane point P: windowed double-and-add.  Builds the
    16-entry multiples table [identity, P, 2P, ..., 15P] (14 adds), then
    scans k's windows from the most significant: acc = 16 acc + T[nib].
    k_nibbles (64, *batch) int32."""
    batch, dev = k_nibbles.shape[1:], k_nibbles.device
    entries = [identity(batch, dev), p]
    for _ in range(14):
        entries.append(pt_add(entries[-1], p))
    # (16, 26, *batch) per coordinate
    table = tuple(
        torch.stack([e[c].expand(F.NLIMBS, *batch) for e in entries]) for c in range(4)
    )
    acc = identity(batch, dev)
    for w in range(WINDOWS - 1, -1, -1):
        for _ in range(4):
            acc = pt_double(acc)
        idx = k_nibbles[w].to(torch.int64)[None, None].expand(1, F.NLIMBS, *batch)
        acc = pt_add(acc, tuple(torch.gather(table[c], 0, idx)[0] for c in range(4)))
    return acc


#: shape/dtype contracts (grammar: ops/contracts.py): the reference's
#: specs, with the 4-bit comb of B an argument (the port's layout,
#: (64, 16, 3, 26))
_CONTRACTS = {
    "decompress": {
        "on": "cpu",
        "args": {"enc": ("u8", (32, "B"))},
        "static": (),
        "out": [
            [
                ("i32", ("NLIMBS", "B")),
                ("i32", ("NLIMBS", "B")),
                ("i32", ("NLIMBS", "B")),
                ("i32", ("NLIMBS", "B")),
            ],
            ("bool", ("B",)),
        ],
    },
    "nibbles_from_bytes_le": {
        "args": {"b": ("u8", (32, "B"))},
        "static": (),
        "out": ("i32", (64, "B")),
    },
    "comb_mul_base": {
        "on": "cpu",
        "args": {
            "s_nibbles": ("i32", (64, "B")),
            "table": ("i32", (64, 16, 3, "NLIMBS")),
        },
        "static": (),
        "out": [
            ("i32", ("NLIMBS", "B")),
            ("i32", ("NLIMBS", "B")),
            ("i32", ("NLIMBS", "B")),
            ("i32", ("NLIMBS", "B")),
        ],
    },
    "window_mul": {
        "on": "cpu",
        "args": {
            "k_nibbles": ("i32", (64, "B")),
            "p": [
                ("i32", ("NLIMBS", "B")),
                ("i32", ("NLIMBS", "B")),
                ("i32", ("NLIMBS", "B")),
                ("i32", ("NLIMBS", "B")),
            ],
        },
        "static": (),
        "out": [
            ("i32", ("NLIMBS", "B")),
            ("i32", ("NLIMBS", "B")),
            ("i32", ("NLIMBS", "B")),
            ("i32", ("NLIMBS", "B")),
        ],
    },
}
