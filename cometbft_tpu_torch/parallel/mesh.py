"""Device meshes and sharded batch verification (the port of
cometbft_tpu/parallel/mesh.py).

A mesh is an ordered grid of torch devices with the reference's axis
names.  A device may appear more than once: each entry is one shard,
so ``flat_mesh(["cpu"] * 8)`` is an 8-shard mesh on the CPU (the
counterpart of the reference's tests on one CPU made to look like 8
devices) and ``flat_mesh(["cuda:0"] * 4)`` four shards on one card.
There is no SPMD program here: a sharded verify is the existing
kernels launched once per shard on that shard's device, every shard
launched before any result is fetched, and the one reduction
(:func:`all_valid`) done on the host.

**The keyed mesh** (``ShardedTorchBatchVerifier._run_keyed_mesh``)
shards the validator set's comb tables, not only the batch: shard ``d``
holds the pages of pool slots ``d, d + ndev, ...``
(``KeySetTables.sharded_tables``), each lane goes to the shard that owns
its key's slot with its key id rebased to the shard's local slot
(:func:`route_lanes`), and each shard runs sha512_keyed then
verify_keyed on its own lanes against its own table
(:func:`verify_keyed_shard`), in MAX_LAUNCH-lane slices.  The verdicts
come back to the lanes' original order on the host.  Unlike the
reference, whose SPMD program pads every shard to one width, each shard
is padded as the single-device path pads a batch, and a shard with no
lanes launches nothing.

**The generic mesh** (``_run_generic_mesh``) packs the batch once, pads
it to a multiple of the shard count, and verifies contiguous column
blocks, one per shard (a block of padding only launches nothing).

``sharded_verify_fn`` is the same split for ``commit_verify_step``'s
feature-first (nbytes, H, V) arrays over a 2-D ("blocks", "sigs") mesh.

The ladder offers the mesh tiers only on a mesh of more than one shard
(``_mesh_capable``); the batch-verifier factory builds this verifier
only when more than one card is visible.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import numpy as np
import torch

from cometbft_tpu_torch.crypto import health as _health
from cometbft_tpu_torch.metrics import crypto_metrics as _crypto_metrics
from cometbft_tpu_torch.models.commit import pack_feature_first
from cometbft_tpu_torch.ops import ed25519_verify as EV
from cometbft_tpu_torch.ops import field as F
from cometbft_tpu_torch.ops import jitguard as _jitguard
from cometbft_tpu_torch.ops import precompute as PR
from cometbft_tpu_torch.utils.env import resolve_device
from cometbft_tpu_torch.utils.trace import TRACER as _tracer

BLOCK_AXIS = "blocks"
SIG_AXIS = "sigs"
DATA_AXIS = "d"


def _factor2(n: int) -> tuple[int, int]:
    """Most-square 2-D factorization of the device count."""
    best = (n, 1)
    for a in range(1, int(n**0.5) + 1):
        if n % a == 0:
            best = (n // a, a)
    return best


class Mesh:
    """An ordered grid of torch devices with named axes.  ``flat`` is
    the devices in row-major order, one shard each, ``grid`` the grid's
    shape, and ``shape`` maps axis name -> size.  Two
    meshes over the same devices, grid and axis names are equal (the
    placements and seams key on it)."""

    __slots__ = ("flat", "grid", "axis_names")

    def __init__(self, devices, grid: tuple[int, ...], axis_names: tuple[str, ...]) -> None:
        self.flat = tuple(torch.device(d) for d in devices)
        self.grid = tuple(int(g) for g in grid)
        self.axis_names = tuple(axis_names)
        if len(self.grid) != len(self.axis_names):
            raise ValueError(f"mesh grid {self.grid} does not match axes {self.axis_names}")
        if math.prod(self.grid) != len(self.flat) or not self.flat:
            raise ValueError(f"mesh shape {self.grid} != {len(self.flat)} devices")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.grid))

    @property
    def size(self) -> int:
        return len(self.flat)

    def coords(self):
        """(grid coordinate, device) per shard, row-major."""
        return zip(np.ndindex(*self.grid), self.flat)

    def _key(self) -> tuple:
        return tuple(str(d) for d in self.flat), self.grid, self.axis_names

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.flat]}, {self.shape})"


def _devices(devices) -> list[torch.device]:
    """The given devices, resolved (``cuda`` names the current card);
    None: every visible card.  No card and no devices raises: there is
    no silent CPU mesh."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass devices=['cpu'] * n to "
                               "run a mesh on the CPU")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [resolve_device(d) for d in devices]


def make_mesh(devices=None, shape: tuple[int, int] | None = None) -> Mesh:
    """A 2-D ("blocks", "sigs") mesh over the given (or all visible)
    devices."""
    devs = _devices(devices)
    if shape is None:
        shape = _factor2(len(devs))
    if shape[0] * shape[1] != len(devs):
        raise ValueError(f"mesh shape {shape} != {len(devs)} devices")
    return Mesh(devs, shape, (BLOCK_AXIS, SIG_AXIS))


_FLAT_MESH: Mesh | None = None


def flat_mesh(devices=None) -> Mesh:
    """1-D data mesh over the given devices, or over every visible card
    (that one cached: verifiers are made per batch, and the table
    placements key on the mesh)."""
    global _FLAT_MESH
    if devices is not None:
        devs = _devices(devices)
        return Mesh(devs, (len(devs),), (DATA_AXIS,))
    if _FLAT_MESH is None:
        devs = _devices(None)
        _FLAT_MESH = Mesh(devs, (len(devs),), (DATA_AXIS,))
    return _FLAT_MESH


def _on(device: torch.device):
    """Launches for ``device`` go to its card (the C launchers launch on
    the current device)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class ShardedArray:
    """A global array split into blocks over a mesh: ``spec`` names,
    per dimension, the mesh axis it is split over (None: not split), and
    ``blocks`` maps each grid coordinate to its block on that
    coordinate's device."""

    def __init__(self, mesh: Mesh, spec: tuple, shape: tuple, blocks: dict) -> None:
        self.mesh, self.spec, self.shape, self.blocks = mesh, tuple(spec), tuple(shape), blocks

    def numpy(self) -> np.ndarray:
        """The global array on the host (one fetch per block)."""
        with _jitguard.audited():
            host = {c: b.cpu().numpy() for c, b in self.blocks.items()}
        out = np.empty(self.shape, dtype=next(iter(host.values())).dtype)
        for coord, block in host.items():
            out[_block_slices(self.mesh, self.spec, self.shape, coord)] = block
        return out


def _block_slices(mesh: Mesh, spec: tuple, shape: tuple, coord: tuple) -> tuple:
    """The global slices of the block at grid coordinate ``coord``."""
    out = []
    for dim, axis in zip(shape, spec):
        if axis is None:
            out.append(slice(None))
            continue
        a = mesh.axis_names.index(axis)
        parts = mesh.grid[a]
        if dim % parts:
            raise ValueError(f"dimension {dim} does not split evenly over axis {axis!r} "
                             f"({parts} devices)")
        size = dim // parts
        out.append(slice(coord[a] * size, (coord[a] + 1) * size))
    return tuple(out)


def shard_batch(mesh: Mesh, arr, axes: tuple[str | None, ...]) -> ShardedArray:
    """Place an array (numpy or tensor) on ``mesh`` with the given axis
    name (or None) per dimension: each coordinate's block on its
    device."""
    t = torch.as_tensor(arr)
    if len(axes) != t.dim():
        raise ValueError(f"{len(axes)} axis names for a {t.dim()}-d array")
    blocks = {}
    with _jitguard.audited():
        for coord, dev in mesh.coords():
            blocks[coord] = t[_block_slices(mesh, axes, tuple(t.shape), coord)].contiguous().to(dev)
    return ShardedArray(mesh, axes, tuple(t.shape), blocks)


_sharded_cache: dict[tuple, object] = {}

_DATA_SPEC = (None, BLOCK_AXIS, SIG_AXIS)


def sharded_verify_fn(mesh: Mesh, nblocks: int = 2):
    """The batch verify over feature-first arrays with a (blocks, sigs)
    trailing batch: pub (32, H, V), sig (64, H, V), msg (M, H, V) uint8
    with H split over the ``blocks`` axis and V over ``sigs``, msglen
    (H, V) -> per-signature verdicts (H, V) as a ShardedArray with the
    same split.  Each block runs the generic tier (sha512_keyed then
    verify_generic per MAX_LAUNCH slice) on its device, every block
    launched before the call returns; nothing is fetched.  Arguments
    may be ShardedArrays (``shard_batch``) or arrays, which are placed
    here.  ``nblocks`` must be the SHA-512 block count of the bucket M.
    Memoized on (mesh, nblocks); notes the ``sharded`` seam per new
    global shape (ops/jitguard.py)."""
    key = (mesh, nblocks)
    fn = _sharded_cache.get(key)
    if fn is not None:
        return fn

    def step(pub, sig, msg, msglen) -> ShardedArray:
        specs = (_DATA_SPEC, _DATA_SPEC, _DATA_SPEC, (BLOCK_AXIS, SIG_AXIS))
        args = []
        for a, spec in zip((pub, sig, msg, msglen), specs):
            if not isinstance(a, ShardedArray):
                a = shard_batch(mesh, a, spec)
            elif a.mesh != mesh or a.spec != spec:
                raise ValueError(f"sharded_verify_fn: an argument split as {a.spec} over "
                                 f"{a.mesh}, not {spec} over {mesh}")
            args.append(a)
        bucket = args[2].shape[0]
        if nblocks != EV.nblocks_for_bucket(bucket):
            raise ValueError(f"sharded_verify_fn: a {bucket}-byte message bucket takes "
                             f"{EV.nblocks_for_bucket(bucket)} SHA-512 blocks, not {nblocks}")
        _jitguard.note_key("sharded", (tuple(mesh.shape.items()), nblocks, args[3].shape, bucket))
        outs = {}
        for coord, dev in mesh.coords():
            with _on(dev):
                packed, blk = pack_feature_first(*(a.blocks[coord] for a in args), bucket)
                outs[coord] = EV.verify_generic_rows(packed, bucket).reshape(blk)
        return ShardedArray(mesh, (BLOCK_AXIS, SIG_AXIS), args[3].shape, outs)

    _sharded_cache[key] = step
    return step


def all_valid(results) -> bool:
    """The one reduction: the AND of every verdict, on the host (one
    fetch of one flag per block)."""
    if isinstance(results, ShardedArray):
        flags = [b.all() for b in results.blocks.values()]
        with _jitguard.audited():
            return all(bool(f) for f in flags)
    if isinstance(results, torch.Tensor):
        with _jitguard.audited():
            return bool(results.all())
    return bool(np.all(results))


# -- the keyed mesh ---------------------------------------------------


def verify_keyed_shard(buf, table, key_valid, b_table, bucket: int, nblocks: int,
                       window_bits: int):
    """One shard's keyed verify against its own table shard: ``buf``
    (104 + bucket, B) uint8 packed rows with key ids rebased to the
    shard's local slots (:func:`route_lanes`), ``table`` (nwin, 4, 26,
    per_cap * nent) and ``key_valid`` (per_cap,) from
    ``KeySetTables.sharded_tables``, ``b_table`` the comb of B on the
    shard's device -> (B,) bool verdicts, on that device."""
    if nblocks != EV.nblocks_for_bucket(bucket):
        raise ValueError(f"verify_keyed_shard: bucket {bucket} takes "
                         f"{EV.nblocks_for_bucket(bucket)} blocks, not {nblocks}")
    return EV.keyed_rows(buf, bucket, table, key_valid, b_table, window_bits)


class Routing(NamedTuple):
    """Where each lane of a keyed mesh batch goes: ``owner`` the shard
    that owns its key's slot (slot % ndev), ``local`` its rebased key id
    (slot // ndev), ``counts`` the lanes per shard, ``order`` the lanes
    in shard-major order (stable within a shard), ``dest`` each lane's
    position in that order: verdicts in shard-major order, indexed by
    ``dest``, come back in the lanes' order."""

    owner: np.ndarray
    local: np.ndarray
    counts: np.ndarray
    order: np.ndarray
    dest: np.ndarray


def route_lanes(key_ids: np.ndarray, ndev: int) -> Routing:
    """The keyed mesh's lane routing (strided slot ownership)."""
    key_ids = np.asarray(key_ids, dtype=np.int64)
    owner = key_ids % ndev
    local = (key_ids // ndev).astype(np.int32)
    counts = np.bincount(owner, minlength=ndev)
    order = np.argsort(owner, kind="stable")
    dest = np.empty(len(key_ids), dtype=np.int64)
    dest[order] = np.arange(len(key_ids))
    return Routing(owner, local, counts, order, dest)


class ShardedTorchBatchVerifier(EV.TorchBatchVerifier):
    """The batch verifier over a mesh (the counterpart of the
    reference's ShardedTpuBatchVerifier): the keyed_mesh and
    generic_mesh tiers above their single-device rungs on the dispatch
    ladder, which run on the mesh's first device.  ``mesh`` (default:
    ``flat_mesh(devices)``, every visible card when ``devices`` is None)
    is a 1-D mesh; its devices may repeat.

    ``last_shards`` describes the last mesh run: per shard its device,
    its real lanes, its padded width and its launches of each kernel."""

    def __init__(self, mesh: Mesh | None = None, devices=None, **kwargs) -> None:
        if mesh is None:
            mesh = flat_mesh(devices)
        elif devices is not None:
            raise ValueError("pass a mesh or devices, not both")
        kwargs.setdefault("device", mesh.flat[0])
        super().__init__(**kwargs)
        self._mesh = mesh
        self._ndev = mesh.size
        self._usage_ndev = self._ndev
        self.last_shards: list[dict] = []

    # -- ladder eligibility ----------------------------------------------

    def _mesh_capable(self) -> bool:
        """Can the mesh tiers run at all?  The ladder reads this as
        eligibility (capability), not admissibility (health)."""
        return self._ndev > 1

    def _keyed_tiers(self) -> list[str]:
        return ["keyed_mesh", "keyed"] if self._mesh_capable() else ["keyed"]

    def _generic_tiers(self) -> list[str]:
        return ["generic_mesh", "generic"] if self._mesh_capable() else ["generic"]

    def _run_tier(self, tier, plan):
        if tier == "keyed_mesh":
            return self._run_keyed_mesh(plan.entry, plan.key_ids, plan.pub, plan.sig, plan.msgs)
        if tier == "generic_mesh":
            return self._run_generic_mesh(plan.pub, plan.sig, plan.msgs)
        return super()._run_tier(tier, plan)

    # -- the runners --------------------------------------------------------

    def keyed_shards(self, key_ids, pub, sig, msgs) -> tuple[Routing, int, list]:
        """The keyed mesh's host work: the lanes' routing, the batch's
        bucket, and per shard its packed rows (104 + bucket, width)
        uint8 with rebased key ids, padded as the single-device path
        pads a batch, or None for a shard with no lanes."""
        routing = route_lanes(key_ids, self._ndev)
        bucket = EV.bucket_for(max(len(m) for m in msgs))
        order = routing.order
        pub_p, sig_p, ids_p = pub[order], sig[order], routing.local[order]
        msgs_p = [msgs[i] for i in order]
        offs = np.concatenate([[0], np.cumsum(routing.counts)])
        packed = []
        for d in range(self._ndev):
            if routing.counts[d] == 0:
                packed.append(None)
                continue
            rows, _ = EV.pack_inputs(pub_p, sig_p, msgs_p, int(offs[d]), int(offs[d + 1]),
                                     key_ids=ids_p, bucket=bucket)
            packed.append(rows)
        return routing, bucket, packed

    def _run_keyed_mesh(self, entry, key_ids, pub, sig, msgs) -> np.ndarray:
        """The keyed verify sharded over the mesh: tables placed once per
        (entry, mesh), lanes routed to their key's shard, every shard's
        rows copied in, then every shard launched (sha512_keyed and
        verify_keyed per MAX_LAUNCH slice), then the verdicts fetched and
        put back in the lanes' order -> bool[n]."""
        mesh, wb = self._mesh, entry.window_bits
        tables, valids, _ = entry.sharded_tables(mesh)
        routing, bucket, packed = self.keyed_shards(key_ids, pub, sig, msgs)
        widths = tuple(0 if p is None else p.shape[1] for p in packed)
        _jitguard.note_key("keyed_mesh", (
            tuple(mesh.shape.items()), bucket, wb, EV.MAX_LAUNCH, widths,
            tuple(EV.slice_picks(dev, w, EV.keyed_group) for dev, w in zip(mesh.flat, widths))))
        nblocks = EV.nblocks_for_bucket(bucket)
        cm = _crypto_metrics()
        cm.batch_verify_launches.child("keyed_mesh").inc()
        cm.bytes_transferred.child("h2d").inc(sum(p.nbytes for p in packed if p is not None))
        with _tracer.span("device_launch", cat="device", kernel="keyed_mesh", batch=sum(widths),
                          bucket=bucket, ndev=mesh.size, window_bits=wb):
            bufs = self._copy_in(packed)
            outs = [None] * mesh.size
            for d, dev in enumerate(mesh.flat):
                if bufs[d] is not None:
                    with _on(dev):
                        outs[d] = verify_keyed_shard(bufs[d], tables[d], valids[d],
                                                     F.const(PR.b_comb8(), dev), bucket, nblocks,
                                                     wb)
        host = self._fetch(outs, routing.counts)
        self._note_shards(widths, routing.counts, "verify_keyed")
        return np.concatenate(host)[routing.dest]

    def _pad_cols(self, packed: np.ndarray, chunk: int | None = None) -> np.ndarray:
        """Pad the batch axis to a multiple of the shard count, or of
        ``chunk`` when the batch is wider than it: a shard count that is
        not a power of two makes a chunk the pow2 batch does not
        divide."""
        b = packed.shape[-1]
        mult = chunk if chunk is not None and b > chunk else self._ndev
        if b % mult:
            packed = np.pad(packed, [(0, 0), (0, mult - b % mult)])
        return packed

    def generic_shards(self, pub, sig, msgs) -> tuple[int, list, np.ndarray]:
        """The generic mesh's host work: the batch packed once, padded
        (``_pad_cols``, chunk MAX_LAUNCH x shards) and split into
        contiguous column blocks, one per shard -> (bucket, per shard
        its (100 + bucket, width) rows or None for a block of padding
        only, the real lanes per shard)."""
        packed, bucket = EV.pack_inputs(pub, sig, msgs)
        packed = self._pad_cols(packed, chunk=EV.MAX_LAUNCH * self._ndev)
        w = packed.shape[1] // self._ndev
        lanes = np.clip(len(msgs) - w * np.arange(self._ndev), 0, w)
        return bucket, [np.ascontiguousarray(packed[:, d * w:(d + 1) * w]) if lanes[d] else None
                        for d in range(self._ndev)], lanes

    def _run_generic_mesh(self, pub, sig, msgs) -> np.ndarray:
        """The generic verify sharded over the mesh: each block copied in,
        then launched (sha512_keyed and verify_generic per MAX_LAUNCH
        slice), then fetched -> bool[n]."""
        mesh = self._mesh
        bucket, packed, lanes = self.generic_shards(pub, sig, msgs)
        widths = tuple(0 if p is None else p.shape[1] for p in packed)
        cm = _crypto_metrics()
        cm.batch_verify_launches.child("generic_mesh").inc()
        cm.bytes_transferred.child("h2d").inc(sum(p.nbytes for p in packed if p is not None))
        with _tracer.span("device_launch", cat="device", kernel="generic_mesh",
                          batch=sum(widths), bucket=bucket, ndev=mesh.size):
            bufs = self._copy_in(packed)
            outs = [None] * mesh.size
            for d, dev in enumerate(mesh.flat):
                if bufs[d] is not None:
                    with _on(dev):
                        outs[d] = EV.verify_generic_rows(bufs[d], bucket)
        host = self._fetch(outs, lanes)
        self._note_shards(widths, lanes, "verify_generic")
        return np.concatenate(host)

    def _copy_in(self, packed: list) -> list:
        """Each shard's rows to its device, all before any launch (a
        blocking copy waits for the work already on its stream)."""
        bufs = []
        with _jitguard.audited():
            for rows, dev in zip(packed, self._mesh.flat):
                bufs.append(None if rows is None else torch.from_numpy(rows).to(dev))
        return bufs

    def _fetch(self, outs: list, keep) -> list[np.ndarray]:
        """The shards' verdicts on the host, the first ``keep[d]`` of
        each (timed as the fetch wait)."""
        with _health.USAGE.timed_fetch(), _jitguard.audited():
            host = [o.cpu().numpy()[: int(k)] for o, k in zip(outs, keep) if o is not None]
        _crypto_metrics().bytes_transferred.child("d2h").inc(
            sum(o.numel() for o in outs if o is not None))
        return host

    def _note_shards(self, widths, lanes, kernel: str) -> None:
        self.last_shards = [
            {"device": str(dev), "lanes": int(n), "width": int(w),
             "launches": {"sha512_keyed": -(-w // EV.MAX_LAUNCH),
                          kernel: -(-w // EV.MAX_LAUNCH)}}
            for dev, w, n in zip(self._mesh.flat, widths, lanes)]


#: shape/dtype contract of the shard-local keyed body (grammar:
#: ops/contracts.py).  Dims are the shard's: the batch B and pool
#: capacity ``cap`` divide over the shard count ``ndev``.
_CONTRACTS = {
    "verify_keyed_shard": {
        "on": "cpu",
        "args": {
            "buf": ("u8", ("104+bucket", "B//ndev")),
            "table": ("i32", ("nwin", 4, "NLIMBS", "cap*nent//ndev")),
            "key_valid": ("bool", ("cap//ndev",)),
            "b_table": ("i32", (32, 3, "NLIMBS", 256)),
        },
        "static": ("bucket", "nblocks", "window_bits"),
        "out": ("bool", ("B//ndev",)),
    },
}
