"""Device-resident per-validator comb tables for the keyed verify path
(the port of cometbft_tpu/ops/precompute.py).

Two table families:

- **Fixed base B** (shared, host-built once from the oracle): an 8-bit
  comb ``B_COMB8[w][j] = j * 256^w * B`` in affine-Niels form -- 32
  mixed adds for [S]B.
- **Per-key tables** (built on the verify device): for each key A,
  comb entries ``j * (2^wb)^w * (-A)`` in projective Niels form
  (Y+X, Y-X, 2Z, 2dT).  Sets of up to KEY8_MAX keys take 8-bit combs
  (32 adds per verify, 3.25 MiB per key), larger sets 4-bit (64 adds,
  416 KiB per key).  On the card the build is the build_tables kernel
  (csrc/build_tables.cu); ``build_tables_plain`` is its plain version.

Tables live per key in a pool (``_KeyPool``), so a set lookup builds
pages only for keys not already pooled: rotating one validator of 150
costs one key's build, not the set's.  Both pools together are bounded
by a byte budget (``TABLE_CACHE_MB`` by default): over it, the least
recently used keys outside the active set are evicted and the pools
compacted.  Builds run outside the cache lock, one latch per key.

An entry (``KeySetTables``) is a snapshot: it maps its keys to slots of
the pool tensor as it was at lookup, and stays correct after later
lookups grow, compact or evict the pool.  The reference gets that from
immutable arrays; here the pool is a mutable tensor, so a page that an
entry may still read is never rewritten in place.  A new key's page is
written in place only into a slot that has held no key since the pool
tensor was made (no entry can map a key to it); a slot freed by
eviction is written by copy-on-write, a new pool tensor.  Growth and
compaction make new tensors too.  An entry held by a caller keeps its
tensor alive, as a JAX array would.

A mesh verify (parallel/mesh.py) reads an entry's tables sharded over
its devices: ``KeySetTables.sharded_tables`` places them once per
(entry, mesh), and the budget counts those placements beside the pools.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import threading
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np
import torch

from cometbft_tpu_torch.crypto import edwards as _ref
from cometbft_tpu_torch.metrics import crypto_metrics as _crypto_metrics
from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import curve as C
from cometbft_tpu_torch.ops import field as F
from cometbft_tpu_torch.ops import jitguard as _jitguard
from cometbft_tpu_torch.utils import sync as cmtsync

#: largest set that gets 8-bit per-key combs (3.25 MiB/key on device)
KEY8_MAX = 256
#: largest set tables are built for at all; a larger one takes the
#: generic tier (ops/ed25519_verify.py)
TABLE_MAX_KEYS = 16384
#: device MiB of both pools before LRU eviction: the default budget of
#: a KeyTableCache (its ``cap_bytes``)
TABLE_CACHE_MB = 6144


def next_pow2(n: int) -> int:
    return 1 << max(n - 1, 1).bit_length() if n > 1 else 1


# -- fixed-base 8-bit comb (host-built, shared) ------------------------

_B8_LOCK = cmtsync.Mutex()
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


def build_tables_plain(pub: torch.Tensor, window_bits: int):
    """The plain PyTorch version of the build_tables kernel: pub (32, n)
    uint8 -> (table, valid), as :func:`build_tables_kernel`, composed
    from the curve formulas (whose field products are the fe_mul /
    fe_sq kernels on a CUDA tensor)."""
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


#: launch shapes (quarters, threads per quarter) that each launch of the
#: build_tables kernel is compiled for: a lane on Q groups of G threads,
#: a point formula's independent products side by side when Q = 4
#: (csrc/build_tables.cu; build_tables_shape chooses among them)
BUILD_SHAPES = ((1, 1), (1, 8), (1, 32), (4, 1), (4, 8), (4, 32))


def build_tables_kernel(pub: torch.Tensor, window_bits: int, shapes=((0, 0), (0, 0))):
    """pub (32, n) uint8 -> (table, valid).

    table: (nwin, 4, 26, n * nent) int32 -- window-major projective
    Niels entries ``j * (2^wb)^w * (-A_key)``, minor axis ordered
    (key, entry) so a verify gathers at ``key_id * nent + window``.
    valid: (n,) bool -- ZIP-215 decompression validity per key; an
    invalid key gets B's table (harmless) and callers mask it.

    A CUDA tensor goes through the build_tables kernel (two launches, a
    lane per key then a lane per (key, window), counted as one;
    ``shapes`` sets each launch's shape, one of BUILD_SHAPES, or (0, 0)
    for the launcher's choice by lane count), a CPU tensor through
    :func:`build_tables_plain`."""
    if window_bits not in (8, 4):
        raise ValueError(f"build_tables: window_bits must be 8 or 4, got {window_bits}")
    if pub.dim() != 2 or pub.shape[0] != 32 or pub.dtype != torch.uint8:
        raise ValueError(f"build_tables: expected (32, n) uint8 keys, got "
                         f"{tuple(pub.shape)} {pub.dtype}")
    shapes = tuple(tuple(s) for s in shapes)
    if len(shapes) != 2 or any(s != (0, 0) and s not in BUILD_SHAPES for s in shapes):
        raise ValueError(f"build_tables: shapes must be two of (0, 0) or {BUILD_SHAPES}, "
                         f"got {shapes}")
    if pub.device.type == "cpu":
        return build_tables_plain(pub, window_bits)
    if pub.device.type != "cuda":
        raise ValueError(f"build_tables: unsupported device {pub.device}")
    n = pub.shape[1]
    nwin, nent = 256 // window_bits, 1 << window_bits
    pub = pub.contiguous()
    table = torch.empty((nwin, 4, F.NLIMBS, n * nent), dtype=F.DTYPE, device=pub.device)
    valid = torch.empty(n, dtype=torch.bool, device=pub.device)
    if n == 0:
        return table, valid
    bases = torch.empty((nwin, 4, F.NLIMBS, n), dtype=F.DTYPE, device=pub.device)
    rc = _build.library("build_tables").build_tables_launch(
        pub.data_ptr(), n, window_bits, bases.data_ptr(), table.data_ptr(),
        valid.data_ptr(), *shapes[0], *shapes[1],
        torch.cuda.current_stream(pub.device).cuda_stream,
    )
    _build.check(rc, "build_tables")
    _build.LAUNCHES["build_tables"] += 1
    return table, valid


def build_shapes(n: int, window_bits: int, device) -> tuple:
    """The (Q, G) shapes of the build's two launches for ``n`` keys on
    ``device`` (a lane per key, then a lane per (key, window)): the
    launcher's picks on a card, ((0, 0), (0, 0)) where the plain version
    runs."""
    if torch.device(device).type != "cuda":
        return ((0, 0), (0, 0))
    return _build_shape_pick(n, 1), _build_shape_pick(n * (256 // window_bits), 2)


@functools.lru_cache(maxsize=None)
def _build_shape_pick(lanes: int, launch: int) -> tuple[int, int]:
    q, g = ctypes.c_int(), ctypes.c_int()
    _build.library("build_tables").build_tables_shape(lanes, launch, ctypes.byref(q),
                                                      ctypes.byref(g))
    return q.value, g.value


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

    ``key_index`` maps each pubkey to its pool slot; ``table`` and
    ``valid`` are the pool as it was at lookup.  The pool never rewrites
    a page that an entry can read (module docstring), so an entry stays
    correct after later rotations grow, compact or evict the pool."""

    sethash: bytes
    window_bits: int
    key_index: dict[bytes, int]  # pubkey bytes -> pool slot
    table: torch.Tensor          # (nwin, 4, 26, cap*nent) int32
    valid: np.ndarray            # (cap,) bool
    nbytes: int                  # bytes of ``table`` (the whole pool)
    set_nbytes: int = 0          # bytes of this set's keys' pages
    _valid_dev: torch.Tensor | None = None
    #: a verify has run on this entry (its first one also waits for the
    #: pool copies the lookup queued)
    launched: bool = False
    #: mesh placements of this entry's tables: key -> (value, device
    #: bytes).  Extra device copies beyond the pool tensor, so the
    #: cache's budget counts them (``placement_bytes``).  Guarded by
    #: ``_mtx``, which is always taken last (never around a cache call).
    placements: dict = field(default_factory=dict)
    _mtx: object = field(default_factory=cmtsync.Mutex, repr=False)

    def key_ids(self, pubs: list[bytes]) -> np.ndarray:
        return np.fromiter(
            (self.key_index[p] for p in pubs), dtype=np.int32, count=len(pubs)
        )

    def valid_device(self) -> torch.Tensor:
        """The validity mask on the table's device, copied once."""
        if self._valid_dev is None:
            with _jitguard.audited():
                self._valid_dev = torch.as_tensor(self.valid).to(self.table.device)
        return self._valid_dev

    def placement_bytes(self) -> int:
        """Device bytes held by this entry's mesh placements."""
        with self._mtx:
            return sum(n for _, n in self.placements.values())

    def sharded_tables(self, mesh):
        """This set's tables sharded over ``mesh``'s devices (any object
        with a ``flat`` tuple of devices, one shard each), placed once
        per (entry, mesh) -> (per-shard tables, per-shard validity
        masks, per_cap).

        Ownership is strided: shard ``d`` owns slots ``d, d + ndev, ...``
        (live slots cluster at one end of the pool, so contiguous blocks
        would leave some shards without keys).  One gather puts the
        pages in per-shard contiguous order: shard ``d``'s block holds
        its slots at local positions ``slot // ndev``, each shard's
        table is (nwin, 4, 26, per_cap * nent) and its mask (per_cap,).
        When every shard's device is the pool's, the blocks stay views
        of the permuted table (rows strided by the whole width, which
        the keyed kernel takes); otherwise each block is copied to its
        device.  The placement's bytes are the permuted table and mask.

        The pool-sized work runs outside ``_mtx``; only the dict's swap
        is locked.  Two threads racing a cold placement may both build
        it; the loser's copy is dropped."""
        key = ("sharded", mesh)
        with self._mtx:
            placed = self.placements.get(key)
        if placed is None:
            devices = tuple(torch.device(d) for d in mesh.flat)
            ndev = len(devices)
            nent = 1 << self.window_bits
            cap = len(self.valid)
            per_cap = -(-cap // ndev)
            shard_cap = per_cap * ndev
            # position d * per_cap + j <- slot j * ndev + d
            slot_perm = np.arange(shard_cap).reshape(per_cap, ndev).T.ravel()
            pad = slot_perm >= cap
            idx = (np.where(pad, 0, slot_perm)[:, None] * nent + np.arange(nent)).ravel()
            valid = np.concatenate([self.valid, np.zeros(shard_cap - cap, dtype=bool)])[slot_perm]
            with _jitguard.audited():
                table = self.table.index_select(3, torch.as_tensor(idx).to(self.table.device))
                if pad.any():
                    cols = (np.flatnonzero(pad)[:, None] * nent + np.arange(nent)).ravel()
                    table[..., torch.as_tensor(cols).to(self.table.device)] = 0
                local = all(d == self.table.device for d in devices)
                width = per_cap * nent
                tables, valids = [], []
                for d, dev in enumerate(devices):
                    block = table[..., d * width:(d + 1) * width]
                    tables.append(block if local else block.to(dev, copy=True))
                    valids.append(torch.as_tensor(valid[d * per_cap:(d + 1) * per_cap]).to(dev))
            del table, block
            nbytes = shard_cap * nent * (256 // self.window_bits) * 4 * F.NLIMBS * 4 + shard_cap
            built = ((tuple(tables), tuple(valids), per_cap), nbytes)
            with self._mtx:
                placed = self.placements.setdefault(key, built)
        return placed[0]


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
    ``[slot*nent : (slot+1)*nent]``, so slot numbers are key ids.
    ``version`` changes with every change of the pool (the entry memo's
    key).  ``held`` is the set of slots that have held a key since
    ``table`` was made: an entry may read them, so they are written only
    by copy-on-write."""

    def __init__(self, window_bits: int, device: torch.device) -> None:
        self.window_bits = window_bits
        self.device = device
        self.nent = 1 << window_bits
        self.nwin = 256 // window_bits
        self.key_bytes = self.nwin * 4 * F.NLIMBS * self.nent * 4
        self.cap = 0
        self.table: torch.Tensor | None = None
        self.valid = np.zeros(0, dtype=bool)
        self.slots: OrderedDict[bytes, int] = OrderedDict()  # LRU order
        self.free: list[int] = []
        self.version = 0
        self.held: set[int] = set()

    def nbytes(self) -> int:
        return self.cap * self.key_bytes

    def _zeros(self, cap: int) -> torch.Tensor:
        return torch.zeros((self.nwin, 4, F.NLIMBS, cap * self.nent),
                           dtype=F.DTYPE, device=self.device)

    def stage_growth(self, version: int, table, cap: int, nkeys: int):
        """The grown pool tensor from a (version, table, cap) snapshot,
        made WITHOUT the cache lock held (it copies the whole pool), or
        None when the snapshot needs no growth.  Returns (snapshot
        version, new cap, grown table); ``ensure_capacity(...,
        staged=...)`` takes it only if the pool's version is still the
        snapshot's."""
        if cap >= nkeys:
            return None
        new_cap = _pool_cap(nkeys)
        grown = self._zeros(new_cap)
        if table is not None:
            grown[..., : cap * self.nent] = table
        return (version, new_cap, grown)

    def ensure_capacity(self, nkeys: int, staged=None) -> None:
        """Grow to the ladder capacity for ``nkeys``.  Lock held.  A
        staged tensor (stage_growth) is taken when its snapshot version
        still matches and it is large enough; otherwise (a concurrent
        build or compaction moved the pool) the copy runs here."""
        if self.cap >= nkeys:
            return
        new_cap = _pool_cap(nkeys)
        if staged is not None and staged[0] == self.version and staged[1] >= new_cap:
            new_cap, grown = staged[1], staged[2]
        else:
            _, new_cap, grown = self.stage_growth(self.version, self.table, self.cap, nkeys)
        self.table = grown
        self.valid = np.concatenate([self.valid, np.zeros(new_cap - self.cap, dtype=bool)])
        self.free.extend(range(self.cap, new_cap))
        self.cap = new_cap
        self.version += 1
        self.held = set(self.slots.values())

    def add_keys(self, keys: list[bytes], pages: torch.Tensor,
                 page_valid: np.ndarray) -> None:
        """Give ``keys`` free slots (highest free slot first) and write
        their pages (nwin, 4, 26, len(keys)*nent).  Lock held; capacity
        already ensured.  In place when no slot has held a key since the
        tensor was made, else into a copy of the pool."""
        slots = [self.free.pop() for _ in keys]
        idx = (np.array(slots, dtype=np.int64)[:, None] * self.nent
               + np.arange(self.nent)).ravel()
        with _jitguard.audited():
            idx = torch.as_tensor(idx).to(self.device)
        if self.held.isdisjoint(slots):
            self.table.index_copy_(3, idx, pages)
        else:
            self.table = self.table.index_copy(3, idx, pages)
            self.held = set(self.slots.values())
        self.held.update(slots)
        for i, (p, s) in enumerate(zip(keys, slots)):
            self.slots[p] = s
            self.valid[s] = page_valid[i]
        self.version += 1

    def compact(self) -> None:
        """Gather live pages into a fresh ladder-capacity tensor (a
        device gather, no EC recompute), LRU order kept -- run after
        eviction freed enough slots that the pool is mostly dead pages."""
        n_live = len(self.slots)
        new_cap = _pool_cap(n_live)
        if new_cap >= self.cap:
            return
        order = list(self.slots.items())
        table = self._zeros(new_cap)
        if order:
            gather = (np.array([s for _, s in order], dtype=np.int64)[:, None] * self.nent
                      + np.arange(self.nent)).ravel()
            with _jitguard.audited():
                gather = torch.as_tensor(gather).to(self.device)
            table[..., : gather.numel()] = self.table.index_select(3, gather)
        valid = np.zeros(new_cap, dtype=bool)
        slots: OrderedDict[bytes, int] = OrderedDict()
        for i, (p, s) in enumerate(order):
            slots[p] = i
            valid[i] = self.valid[s]
        self.table, self.valid, self.slots = table, valid, slots
        self.free = list(range(n_live, new_cap))
        self.cap = new_cap
        self.version += 1
        self.held = set(range(n_live))


class KeyTableCache:
    """Per-key LRU of comb-table pages on one device, for both window
    widths, bounded by ``cap_bytes`` of pool tensors.  A set lookup
    builds pages only for keys not yet pooled (rotating 1 of 150 or of
    10,000 validators builds one key)."""

    def __init__(self, device, cap_bytes: int = TABLE_CACHE_MB << 20) -> None:
        self.device = torch.device(device)
        self._cap = cap_bytes
        self._lock = cmtsync.Mutex()
        self._pools = {8: _KeyPool(8, self.device), 4: _KeyPool(4, self.device)}
        # per-key build latches: concurrent misses on overlapping keys
        # build each key once -- losers wait on the winner's latch
        self._pending: dict[tuple[int, bytes], threading.Event] = {}
        # set hash -> (pool version, entry): a repeat lookup of an
        # unchanged set returns the same entry object
        self._entries: OrderedDict[bytes, tuple[int, KeySetTables]] = OrderedDict()
        self.stats = {"keys_built": 0, "keys_evicted": 0}

    def _set_key(self, pubs: list[bytes]):
        """(unique keys, window pool, set hash), or None when the
        unique-key count is out of table policy: one implementation for
        peek and lookup_or_build, so the warm probe and the build path
        never look at different pools."""
        unique = sorted(set(pubs))
        n = len(unique)
        if n == 0 or n > TABLE_MAX_KEYS:
            return None
        pool = self._pools[8 if n <= KEY8_MAX else 4]
        return unique, pool, hashlib.sha256(b"".join(unique)).digest()

    def peek(self, pubs: list[bytes]) -> KeySetTables | None:
        """An entry iff every key is already resident: never builds and
        never waits on an in-flight build (builds run outside the
        lock)."""
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
        of policy.  The build runs outside the lock under per-key
        latches; a build fault propagates to the caller."""
        sk = self._set_key(pubs)
        if sk is None:
            return None
        unique, pool, h = sk
        wb = pool.window_bits
        while True:
            with self._lock:
                waits = [self._pending[k] for p in unique if (k := (wb, p)) in self._pending]
                if not waits:
                    missing = [p for p in unique if p not in pool.slots]
                    if not missing:
                        return self._finish_lookup(h, pool, unique)
                    for p in missing:
                        self._pending[(wb, p)] = threading.Event()
            if waits:
                for ev in waits:
                    ev.wait()
                continue
            try:
                pages, page_valid = self._build_pages(missing, wb)
                # stage any growth outside the lock: it copies the whole
                # pool, and warm lookups must not queue behind it
                with self._lock:
                    snap = (pool.version, pool.table, pool.cap)
                    need = len(pool.slots) + len(missing)
                staged = pool.stage_growth(*snap, need)
                with self._lock:
                    pool.ensure_capacity(len(pool.slots) + len(missing), staged=staged)
                    pool.add_keys(missing, pages, page_valid)
                    self.stats["keys_built"] += len(missing)
                    _crypto_metrics().key_pool_builds.inc(len(missing))
                    self._evict_over_budget(keep=set(unique))
                    self._update_pool_gauges()
                    # another lookup's eviction may have dropped keys of
                    # ours that were resident before this build: loop
                    if all(p in pool.slots for p in unique):
                        return self._finish_lookup(h, pool, unique)
            finally:
                with self._lock:
                    for p in missing:
                        self._pending.pop((wb, p)).set()

    def _finish_lookup(self, h: bytes, pool: _KeyPool,
                       unique: list[bytes]) -> KeySetTables:
        """Touch LRU order and return the set's (memoized) entry.  Lock
        held."""
        for p in unique:
            pool.slots.move_to_end(p)
        memo = self._entries.get(h)
        if memo is not None and memo[0] == pool.version:
            self._entries.move_to_end(h)
            return memo[1]
        # a memoized entry pins its version's pool tensor: drop stale
        # ones so the memo holds no tensor beyond the live pools
        self._sweep_stale_entries()
        entry = KeySetTables(
            sethash=h,
            window_bits=pool.window_bits,
            key_index={p: pool.slots[p] for p in unique},
            table=pool.table,
            valid=pool.valid.copy(),
            nbytes=pool.nbytes(),
            set_nbytes=len(unique) * pool.key_bytes,
        )
        self._entries[h] = (pool.version, entry)
        while len(self._entries) > 64:
            self._entries.popitem(last=False)
        return entry

    def _build_pages(self, missing: list[bytes], window_bits: int):
        """Comb pages (nwin, 4, 26, len(missing)*nent) and validity for
        ``missing`` keys, built on the cache's device into a tensor of
        their own (the pool is not touched).  Runs outside the lock.
        The ``table_build`` seam (ops/jitguard.py) notes each new (keys,
        window bits, launch shapes)."""
        n = len(missing)
        _jitguard.note_key("table_build",
                           (n, window_bits, build_shapes(n, window_bits, self.device)))
        pub = np.stack([np.frombuffer(p, dtype=np.uint8) for p in missing], axis=-1)
        with _jitguard.audited():
            table, valid = build_tables_kernel(torch.from_numpy(pub).to(self.device), window_bits)
            return table, valid.cpu().numpy()

    def _sweep_stale_entries(self) -> None:
        """Drop memoized entries whose pool version moved on, and with
        them the mesh placements they hold.  Lock held."""
        for k in [k for k, (v, e) in self._entries.items()
                  if v != self._pools[e.window_bits].version]:
            del self._entries[k]

    def placement_bytes(self) -> int:
        """Device bytes of the live memoized entries' mesh placements,
        beyond the pool tensors.  Lock held."""
        return sum(e.placement_bytes() for _, e in self._entries.values())

    def _evict_over_budget(self, keep: set[bytes]) -> None:
        """Drop LRU keys (never ones in ``keep``, the active set) until
        compaction brings the pools under budget, then compact.  Lock
        held.  Minimal: eviction stops as soon as the compacted
        footprint fits.  A set larger than the budget stays resident.

        The trigger counts the pools plus the live entries' mesh
        placements; the stop condition only the compacted pools: the
        compaction stales every memoized entry, and the sweep after it
        releases their placements, which no key eviction could shrink."""

        def compacted_bytes(p: _KeyPool) -> int:
            return min(p.cap, _pool_cap(len(p.slots))) * p.key_bytes

        # placements of entries already stale are garbage: dropping them
        # often brings the cache under budget with no eviction
        self._sweep_stale_entries()
        if sum(p.nbytes() for p in self._pools.values()) + self.placement_bytes() <= self._cap:
            return
        changed = False
        for pool in self._pools.values():
            for p in [p for p in pool.slots if p not in keep]:  # LRU order
                if sum(compacted_bytes(q) for q in self._pools.values()) <= self._cap:
                    break
                # the page stays until compaction or a copy-on-write
                s = pool.slots.pop(p)
                pool.valid[s] = False
                pool.free.append(s)
                self.stats["keys_evicted"] += 1
                _crypto_metrics().key_pool_evictions.inc()
                changed = True
        if changed:
            for pool in self._pools.values():
                pool.compact()
            self._sweep_stale_entries()

    def _update_pool_gauges(self) -> None:
        """The pools' occupancy and capacity gauges.  Lock held."""
        cm = _crypto_metrics()
        for wb, pool in self._pools.items():
            cm.key_pool_keys.labels(window_bits=str(wb)).set(len(pool.slots))
            cm.key_pool_capacity.labels(window_bits=str(wb)).set(pool.cap)

    def clear(self) -> None:
        with self._lock:
            self._pools = {8: _KeyPool(8, self.device), 4: _KeyPool(4, self.device)}
            self._entries.clear()
            self._update_pool_gauges()


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
        nbytes=table.nbytes,
        set_nbytes=len(unique) * (table.nbytes // max(len(valid), 1)),
    )


#: shape/dtype contracts (grammar: ops/contracts.py): the reference's
#: specs, with the comb of B an argument of comb_mul_base8 (the port's
#: layout, entry index minor)
_CONTRACTS = {
    "build_tables_kernel": {
        "on": "cpu",
        "args": {"pub": ("u8", (32, "B"))},
        "static": ("window_bits",),
        "out": [
            ("i32", ("nwin", 4, "NLIMBS", "B*nent")),
            ("bool", ("B",)),
        ],
    },
    "comb_mul_base8": {
        "on": "cpu",
        "args": {
            "s_bytes": ("u8", (32, "B")),
            "table": ("i32", (32, 3, "NLIMBS", 256)),
        },
        "static": (),
        "out": [
            ("i32", ("NLIMBS", "B")),
            ("i32", ("NLIMBS", "B")),
            ("i32", ("NLIMBS", "B")),
            ("i32", ("NLIMBS", "B")),
        ],
    },
    "comb_mul_keyed": {
        "on": "cpu",
        "args": {
            "table": ("i32", ("nwin", 4, "NLIMBS", "cap*nent")),
            "key_ids": ("i32", ("B",)),
            "windows": ("i32", ("nwin", "B")),
        },
        "static": ("window_bits",),
        "out": [
            ("i32", ("NLIMBS", "B")),
            ("i32", ("NLIMBS", "B")),
            ("i32", ("NLIMBS", "B")),
            ("i32", ("NLIMBS", "B")),
        ],
    },
}
