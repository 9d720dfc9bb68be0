"""Device-resident per-validator comb tables for the keyed verify path
(the port of cometbft_tpu/ops/precompute.py, without the mesh placement
and without the pool's eviction and compaction).

Two table families:

- **Fixed base B** (shared, host-built once from the oracle): an 8-bit
  comb ``B_COMB8[w][j] = j * 256^w * B`` in affine-Niels form -- 32
  mixed adds for [S]B.
- **Per-key tables** (built on the verify device): for each key A,
  comb entries ``j * (2^wb)^w * (-A)`` in projective Niels form
  (Y+X, Y-X, 2Z, 2dT).  Sets of up to KEY8_MAX keys take 8-bit combs
  (32 adds per verify, 3.4 MB per key), larger sets 4-bit (64 adds,
  426 KB per key).

Tables live per key in a pool (``_KeyPool``), so a set lookup builds
pages only for keys not already pooled: rotating one validator of 150
costs one key's build, not the set's.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from cometbft_tpu_torch.crypto import edwards as _ref
from cometbft_tpu_torch.ops import curve as C
from cometbft_tpu_torch.ops import field as F

#: largest set that gets 8-bit per-key combs (3.4 MB/key on device)
KEY8_MAX = 256
#: largest set tables are built for at all; a larger one takes the
#: generic tier (ops/ed25519_verify.py)
TABLE_MAX_KEYS = 16384


def next_pow2(n: int) -> int:
    return 1 << max(n - 1, 1).bit_length() if n > 1 else 1


# -- fixed-base 8-bit comb (host-built, shared) ------------------------

_B8_LOCK = threading.Lock()
_B8: np.ndarray | None = None


def b_comb8() -> np.ndarray:
    """(32, 3, 26, 256) affine-Niels comb of B, entry index on the
    minor axis (a gather along it serves a whole batch).  Built lazily
    from the oracle: ~8k host EC operations."""
    global _B8
    with _B8_LOCK:
        if _B8 is None:
            table = np.zeros((32, 256, 3, F.NLIMBS), dtype=np.int32)
            base = _ref.B_POINT
            for w in range(32):
                acc = _ref.IDENTITY
                table[w, 0] = np.stack([F.ONE, F.ONE, F.ZERO])
                for j in range(1, 256):
                    acc = _ref.pt_add(acc, base)
                    table[w, j] = C.niels_from_affine(*_ref.pt_to_affine(acc))
                for _ in range(8):
                    base = _ref.pt_double(base)
            _B8 = np.ascontiguousarray(table.transpose(0, 2, 3, 1))
        return _B8


def _gather(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """tbl (..., m) gathered on its minor axis by idx (*batch,) ->
    (..., *batch).  On the CPU an index out of range raises here; on
    the card it would be a device-side assert, so callers keep indices
    in range by construction (padded lanes carry key 0, window 0)."""
    flat = idx.reshape(-1).to(torch.int64)
    if flat.device.type == "cpu" and flat.numel():
        lo, hi = int(flat.min()), int(flat.max())
        if lo < 0 or hi >= tbl.shape[-1]:
            raise IndexError(
                f"table index out of range [{lo}, {hi}] for {tbl.shape[-1]} entries"
            )
    out = tbl.index_select(tbl.dim() - 1, flat)
    return out.reshape(*tbl.shape[:-1], *idx.shape)


def comb_mul_base8(s_bytes: torch.Tensor, table: torch.Tensor | None = None):
    """[S]B via the 8-bit Niels comb: s_bytes (32, *batch) uint8 LE
    scalar encoding (the comb is exact for any 256-bit integer).
    ``table`` is b_comb8() on s_bytes' device (uploaded once if None)."""
    if table is None:
        table = F.const(b_comb8(), s_bytes.device)
    acc = C.identity(s_bytes.shape[1:], s_bytes.device)
    for w in range(32):
        e = _gather(table[w], s_bytes[w])  # (3, 26, *batch)
        acc = C.pt_add_niels(acc, (e[0], e[1], e[2]))
    return acc


# -- per-key projective-Niels comb builder -----------------------------

_BX, _BY = _ref.pt_to_affine(_ref.B_POINT)
_B_AFFINE_X = F.from_int(_BX)
_B_AFFINE_Y = F.from_int(_BY)


def build_tables_kernel(pub: torch.Tensor, window_bits: int):
    """pub (32, n) uint8 -> (table, valid).

    table: (nwin, 4, 26, n * nent) int32 -- window-major projective
    Niels entries ``j * (2^wb)^w * (-A_key)``, minor axis ordered
    (key, entry) so a verify gathers at ``key_id * nent + window``.
    valid: (n,) bool -- ZIP-215 decompression validity per key; an
    invalid key gets B's table (harmless) and callers mask it."""
    dev = pub.device
    n = pub.shape[-1]
    nwin = 256 // window_bits
    nent = 1 << window_bits
    a_pt, valid = C.decompress(pub)
    # keep the formulas on the curve for invalid encodings: substitute B
    x = F.select(valid, a_pt[0], F.cvec(_B_AFFINE_X, 2, dev).expand(F.NLIMBS, n))
    y = F.select(valid, a_pt[1], F.cvec(_B_AFFINE_Y, 2, dev).expand(F.NLIMBS, n))
    z = F.cvec(F.ONE, 2, dev).expand(F.NLIMBS, n)
    p = C.pt_neg((x, y, z, F.mul(x, y)))
    bases = []
    for w in range(nwin):
        bases.append(p)
        if w + 1 < nwin:
            for _ in range(window_bits):
                p = C.pt_double(p)
    # (nwin, 26, n) per coordinate -> windows into the batch: (26, nwin*n)
    base_flat = tuple(
        torch.stack([b[c] for b in bases], dim=1).reshape(F.NLIMBS, nwin * n)
        for c in range(4)
    )
    del bases
    acc = C.identity((nwin * n,), dev)
    entries = []
    for j in range(nent):
        entries.append(acc)
        if j + 1 < nent:
            acc = C.pt_add(acc, base_flat)
    # (26, nent, nwin*n) per coordinate
    ex, ey, ez, et = (
        torch.stack([e[c].expand(F.NLIMBS, nwin * n) for e in entries], dim=1)
        for c in range(4)
    )
    del entries, acc
    t2d = F.mul(et, F.cvec(C.TWO_D_LIMBS, 3, dev))
    del et
    pn = torch.stack([ey + ex, ey - ex, ez + ez, t2d])  # (4, 26, nent, nwin*n)
    del ex, ey, ez, t2d
    pn = pn.reshape(4, F.NLIMBS, nent, nwin, n)
    # -> (nwin, 4, 26, n, nent) -> (nwin, 4, 26, n*nent)
    table = pn.permute(3, 0, 1, 4, 2).reshape(nwin, 4, F.NLIMBS, n * nent)
    return table, valid


def comb_mul_keyed(table: torch.Tensor, key_ids: torch.Tensor,
                   windows: torch.Tensor, window_bits: int):
    """Per-key comb: table from build_tables_kernel, key_ids (*batch,),
    windows (nwin, *batch) int32 LE digits of k.  Returns [k](-A_key)
    per lane as an extended point."""
    nent = 1 << window_bits
    base_idx = key_ids.to(torch.int64) * nent
    acc = C.identity(key_ids.shape, key_ids.device)
    for w in range(table.shape[0]):
        e = _gather(table[w], base_idx + windows[w])  # (4, 26, *batch)
        acc = C.pt_add_pniels(acc, (e[0], e[1], e[2], e[3]))
    return acc


# -- per-key table pool ------------------------------------------------


@dataclass
class KeySetTables:
    """A validator set's view into the device-resident key-table pool.

    ``key_index`` maps each pubkey to its pool slot; ``table`` is the
    pool tensor at lookup time.  New keys are written into FREE slots
    of the pool tensor in place (to spare a copy of the whole pool);
    the pages of keys an entry covers are never rewritten, so an entry
    stays valid after later lookups."""

    sethash: bytes
    window_bits: int
    key_index: dict[bytes, int]  # pubkey bytes -> pool slot
    table: torch.Tensor          # (nwin, 4, 26, cap*nent) int32
    valid: np.ndarray            # (cap,) bool
    _valid_dev: torch.Tensor | None = None

    def key_ids(self, pubs: list[bytes]) -> np.ndarray:
        return np.fromiter(
            (self.key_index[p] for p in pubs), dtype=np.int32, count=len(pubs)
        )

    def valid_device(self) -> torch.Tensor:
        """The validity mask on the table's device, copied once."""
        if self._valid_dev is None:
            self._valid_dev = torch.as_tensor(self.valid).to(self.table.device)
        return self._valid_dev


_B_ENC = np.frombuffer(_ref.encode_point(_ref.B_POINT), dtype=np.uint8)


def _pool_cap(nkeys: int) -> int:
    """Pool capacities come from a fixed ladder (pow2 up to 4096, then
    2048-slot steps): bounded shape count, without pow2's up-to-2x
    memory waste at large sets."""
    if nkeys <= 4096:
        return next_pow2(max(nkeys, 1))
    return -(-nkeys // 2048) * 2048


class _KeyPool:
    """One window width's pool of per-key comb pages on one device: the
    minor axis holds ``cap`` pages of ``nent`` entries, a key's page at
    ``[slot*nent : (slot+1)*nent]``, so slot numbers are key ids."""

    def __init__(self, window_bits: int, device: torch.device) -> None:
        self.window_bits = window_bits
        self.device = device
        self.nent = 1 << window_bits
        self.nwin = 256 // window_bits
        self.cap = 0
        self.table: torch.Tensor | None = None
        self.valid = np.zeros(0, dtype=bool)
        self.slots: OrderedDict[bytes, int] = OrderedDict()
        self.free: list[int] = []
        # the latest set's view; dropped whenever the pool changes
        self.entry: KeySetTables | None = None

    def ensure_capacity(self, nkeys: int) -> None:
        """Grow to the ladder capacity for ``nkeys`` (a new zeroed pool
        tensor with the old pages copied in)."""
        if self.cap >= nkeys:
            return
        new_cap = _pool_cap(nkeys)
        grown = torch.zeros(
            (self.nwin, 4, F.NLIMBS, new_cap * self.nent),
            dtype=F.DTYPE, device=self.device,
        )
        if self.table is not None:
            grown[..., : self.cap * self.nent] = self.table
        self.table = grown
        self.valid = np.concatenate(
            [self.valid, np.zeros(new_cap - self.cap, dtype=bool)]
        )
        self.free.extend(range(self.cap, new_cap))
        self.cap = new_cap
        self.entry = None


class KeyTableCache:
    """Per-key pool of comb-table pages on one device, for both window
    widths.  A set lookup builds pages only for keys not yet pooled."""

    def __init__(self, device) -> None:
        self.device = torch.device(device)
        self._lock = threading.Lock()
        self._pools = {8: _KeyPool(8, self.device), 4: _KeyPool(4, self.device)}
        self.stats = {"keys_built": 0}

    def _set_key(self, pubs: list[bytes]):
        """(unique keys, window pool, set hash), or None when the
        unique-key count is out of table policy."""
        unique = sorted(set(pubs))
        n = len(unique)
        if n == 0 or n > TABLE_MAX_KEYS:
            return None
        pool = self._pools[8 if n <= KEY8_MAX else 4]
        return unique, pool, hashlib.sha256(b"".join(unique)).digest()

    def peek(self, pubs: list[bytes]) -> KeySetTables | None:
        """An entry iff every key is already resident; never builds."""
        sk = self._set_key(pubs)
        if sk is None:
            return None
        unique, pool, h = sk
        with self._lock:
            if any(p not in pool.slots for p in unique):
                return None
            return self._finish_lookup(h, pool, unique)

    def lookup_or_build(self, pubs: list[bytes]) -> KeySetTables | None:
        """An entry covering every key in ``pubs``, building pages only
        for keys not yet pooled; None when the unique-key count is out
        of policy.  Builds run under the cache lock: concurrent lookups
        wait rather than build a key twice."""
        sk = self._set_key(pubs)
        if sk is None:
            return None
        unique, pool, h = sk
        with self._lock:
            missing = [p for p in unique if p not in pool.slots]
            if missing:
                pages, page_valid = self._build_pages(missing, pool.window_bits)
                pool.ensure_capacity(len(pool.slots) + len(missing))
                slots = [pool.free.pop() for _ in missing]
                idx = (
                    np.array(slots, dtype=np.int64)[:, None] * pool.nent
                    + np.arange(pool.nent)
                ).ravel()
                pool.table.index_copy_(
                    3, torch.as_tensor(idx).to(self.device),
                    pages[..., : len(missing) * pool.nent],
                )
                pool.entry = None
                for i, (p, s) in enumerate(zip(missing, slots)):
                    pool.slots[p] = s
                    pool.valid[s] = page_valid[i]
                self.stats["keys_built"] += len(missing)
            return self._finish_lookup(h, pool, unique)

    def _finish_lookup(self, h: bytes, pool: _KeyPool,
                       unique: list[bytes]) -> KeySetTables:
        """Touch LRU order and return the set's entry: a repeat lookup
        of the pool's latest set returns the same object.  Lock held."""
        for p in unique:
            pool.slots.move_to_end(p)
        if pool.entry is None or pool.entry.sethash != h:
            pool.entry = KeySetTables(
                sethash=h,
                window_bits=pool.window_bits,
                key_index={p: pool.slots[p] for p in unique},
                table=pool.table,
                valid=pool.valid.copy(),
            )
        return pool.entry

    def _build_pages(self, missing: list[bytes], window_bits: int):
        """Comb pages for ``missing`` keys, built on the device
        (pow2-padded with B's encoding)."""
        n = len(missing)
        n_pad = next_pow2(n)
        pub = np.zeros((32, n_pad), dtype=np.uint8)
        for i, p in enumerate(missing):
            pub[:, i] = np.frombuffer(p, dtype=np.uint8)
        if n_pad > n:
            pub[:, n:] = _B_ENC[:, None]
        table, valid = build_tables_kernel(
            torch.from_numpy(pub).to(self.device), window_bits
        )
        return table, valid.cpu().numpy()[:n]

    def clear(self) -> None:
        with self._lock:
            self._pools = {8: _KeyPool(8, self.device), 4: _KeyPool(4, self.device)}


_caches: dict[str, KeyTableCache] = {}
_caches_lock = threading.Lock()


def table_cache(device) -> KeyTableCache:
    """The process's key-table cache for ``device`` (one per device:
    the tables live where the verify runs)."""
    key = str(torch.device(device))
    with _caches_lock:
        cache = _caches.get(key)
        if cache is None:
            cache = _caches[key] = KeyTableCache(device)
        return cache


def tables_from_jax(table: np.ndarray, valid: np.ndarray,
                    key_index: dict[bytes, int], window_bits: int,
                    device) -> KeySetTables:
    """A port ``KeySetTables`` from a JAX ``KeySetTables``' arrays,
    passed as numpy: table (nwin, 4, 26, cap*nent) int32, valid (cap,)
    bool, and its pubkey -> slot map.  The layout is the same, so the
    port's keyed path runs on a table the reference built."""
    nwin, nent = 256 // window_bits, 1 << window_bits
    table = np.asarray(table, dtype=np.int32)
    valid = np.asarray(valid, dtype=bool)
    if table.shape != (nwin, 4, F.NLIMBS, len(valid) * nent):
        raise ValueError(
            f"table shape {table.shape} does not match window_bits="
            f"{window_bits} and {len(valid)} slots"
        )
    unique = sorted(key_index)
    return KeySetTables(
        sethash=hashlib.sha256(b"".join(unique)).digest(),
        window_bits=window_bits,
        key_index=dict(key_index),
        table=torch.tensor(table, device=device),
        valid=valid.copy(),
    )
