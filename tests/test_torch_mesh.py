"""The port's multi-device plane (cometbft_tpu_torch/parallel/mesh.py,
the mesh rungs of crypto/dispatch.py, the placements of
ops/precompute.py) against the reference's (cometbft_tpu/parallel/mesh.py)
on the CPU.  Tolerance: exact (verdict vectors, placement pages and
masks, routing, ladder snapshots).

The reference runs its keyed mesh once, on ``flat_mesh(jax.devices()[:8])``
(conftest makes the CPU look like 8 devices), with the batch, keys and
pool of tests/test_parallel.py's keyed-mesh section (53 lanes over 12
keys, 8-bit pages, 9 planted invalids), so its program is the one that
section compiles.  The port's mesh is ``["cpu"] * 8``: one shard per
entry, on one CPU.  Both caches take their pages from one plain build
(``build_tables_plain``, whose parity with the reference's build is
tests/test_torch_precompute.py's), so the reference's build program is
not compiled here."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from cometbft_tpu.crypto import dispatch as jdispatch
from cometbft_tpu.crypto import ed25519 as jed
from cometbft_tpu.ops import precompute as JPR
from cometbft_tpu.parallel import mesh as JM
from cometbft_tpu_torch import metrics as M
from cometbft_tpu_torch.crypto import batch as B
from cometbft_tpu_torch.crypto import dispatch as D
from cometbft_tpu_torch.crypto import ed25519 as ed
from cometbft_tpu_torch.crypto import edwards as E
from cometbft_tpu_torch.ops import ed25519_verify as EV
from cometbft_tpu_torch.ops import precompute as PR
from cometbft_tpu_torch.parallel import mesh as MM
from cometbft_tpu_torch.utils import metrics as um

NKEYS = 12
N = 53


def _triples(privs, n, bad, nkeys, tag=b"keyed-mesh-%d"):
    out = []
    for i in range(n):
        p = privs[i % nkeys]
        m = tag % i
        s = p.sign(m)
        if i in bad:
            s = s[:-1] + bytes([s[-1] ^ 1])
        out.append((p.pub_key().bytes(), m, s))
    return out


class _Pages:
    """One plain build of the keys' 8-bit pages, served to a cache as its
    ``_build_pages`` (as torch or jnp)."""

    def __init__(self, pubs: list[bytes]) -> None:
        pub = np.stack([np.frombuffer(p, dtype=np.uint8) for p in pubs], axis=-1)
        table, valid = PR.build_tables_plain(torch.from_numpy(pub), 8)
        self.page = {p: table[..., 256 * i: 256 * (i + 1)] for i, p in enumerate(pubs)}
        self.valid = {p: bool(valid[i]) for i, p in enumerate(pubs)}

    def serve(self, as_jax: bool):
        def build(missing, window_bits):
            assert window_bits == 8
            table = torch.cat([self.page[p] for p in missing], dim=3)
            valid = np.array([self.valid[p] for p in missing])
            return (jnp.asarray(table.numpy()) if as_jax else table), valid
        return build


@pytest.fixture(scope="module")
def world():
    """The keys, the triples, one plain build of the pages, and the
    reference's ShardedTpuBatchVerifier run once on its 8-device mesh."""
    jdispatch.reset_for_tests()
    D.reset_for_tests()
    privs = [ed.priv_key_from_secret(b"km%03d" % i) for i in range(14)]
    pubs = sorted(p.pub_key().bytes() for p in privs[:NKEYS])
    rng = np.random.RandomState(6)
    bad = set(int(i) for i in rng.choice(N, 9, replace=False))
    triples = _triples(privs, N, bad, NKEYS)
    expected = [E.verify_zip215(*t) for t in triples]
    assert expected == [i not in bad for i in range(N)]
    pages = _Pages(pubs)
    jcache = JPR.KeyTableCache()
    jcache._build_pages = pages.serve(as_jax=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JPR, "TABLE_CACHE", jcache)
        jmesh = JM.flat_mesh(jax.devices()[:8])
        jbv = JM.ShardedTpuBatchVerifier(mesh=jmesh, device_min_batch=0)
        for p, m, s in triples:
            jbv.add(jed.Ed25519PubKey(p), m, s)
        ref_ok, ref_results = jbv.verify()
        assert jbv._last_tier == "keyed_mesh"
    jdispatch.reset_for_tests()
    yield dict(privs=privs, pubs=pubs, triples=triples, expected=expected, pages=pages,
               jcache=jcache, jmesh=jmesh, ref=(ref_ok, ref_results))
    D.reset_for_tests()


@pytest.fixture
def fresh():
    D.reset_for_tests()
    cm = M.CryptoMetrics(um.Registry())
    hm = M.HealthMetrics(um.Registry())
    M.install_crypto_metrics(cm)
    M.install_health_metrics(hm)
    yield cm, hm
    D.reset_for_tests()
    M.install_crypto_metrics(None)
    M.install_health_metrics(None)


def _port_cache(world):
    cache = PR.KeyTableCache("cpu")
    cache._build_pages = world["pages"].serve(as_jax=False)
    return cache


def _fill(bv, triples):
    for p, m, s in triples:
        bv.add(ed.Ed25519PubKey(p), m, s)
    return bv


def test_keyed_mesh_on_8_shards_matches_reference(world, fresh):
    """(a) The port's keyed_mesh on ["cpu"] * 8 gives the reference
    ShardedTpuBatchVerifier's verdict vector, bit for bit, planted
    invalids included, with one keyed_mesh launch counted."""
    cm, hm = fresh
    bv = _fill(MM.ShardedTorchBatchVerifier(devices=["cpu"] * 8, device_min_batch=0,
                                            cache=_port_cache(world)), world["triples"])
    plan = bv.plan()
    assert plan.tiers == ["keyed_mesh", "keyed", "generic_mesh", "generic", "host", "python"]
    ok, results = bv.execute(plan)
    assert bv.last_tier == "keyed_mesh"
    assert (ok, results) == world["ref"]
    assert results == world["expected"]
    assert cm.batch_verify_launches.labels(kernel="keyed_mesh").get() == 1
    assert cm.dispatch_tier.labels(tier="keyed_mesh").get() == 1
    assert cm.bytes_transferred.labels(direction="h2d").get() > 0
    assert cm.bytes_transferred.labels(direction="d2h").get() == sum(
        s["width"] for s in bv.last_shards)
    # every shard owns some of the 12 keys' slots: all 8 launched
    assert [s["lanes"] for s in bv.last_shards] == list(
        np.bincount(plan.key_ids % 8, minlength=8))
    assert all(s["launches"] == {"sha512_keyed": 1, "verify_keyed": 1} for s in bv.last_shards)
    # busy/idle accounted on each of the 8 shards
    for d in range(8):
        assert hm.device_busy_seconds_total.labels(device=str(d)).get() > 0


def test_sharded_tables_equal_reference_placement(world):
    """(b) The port's placement of the reference's pool pages (carried
    across with tables_from_jax): pages, mask and per_cap bit for bit,
    bytes as the reference counts them, cached per (entry, mesh)."""
    jentry = world["jcache"].lookup_or_build(world["pubs"])
    jmesh = world["jmesh"]
    jt, jv, jpc = jentry.sharded_tables(
        jmesh, NamedSharding(jmesh, P(None, None, None, JM.DATA_AXIS)),
        NamedSharding(jmesh, P(JM.DATA_AXIS)), 8)
    entry = PR.tables_from_jax(np.asarray(jentry.table), jentry.valid, jentry.key_index, 8,
                               "cpu")
    mesh = MM.flat_mesh(["cpu"] * 8)
    tables, valids, per_cap = entry.sharded_tables(mesh)
    assert per_cap == jpc == 2
    assert torch.equal(torch.cat(tables, dim=3), torch.from_numpy(np.array(jt)))
    assert torch.equal(torch.cat(valids), torch.from_numpy(np.array(jv)))
    assert entry.placement_bytes() == jentry.placement_bytes() == int(jt.nbytes) + int(jv.nbytes)
    # the shards on the pool's device are views of one permuted table,
    # rows as wide as the whole placement
    assert all(t.stride(2) == 8 * per_cap * 256 for t in tables)
    assert len({t.untyped_storage().data_ptr() for t in tables}) == 1
    assert entry.sharded_tables(mesh)[0] is tables
    assert entry.sharded_tables(MM.flat_mesh(["cpu"] * 8))[0] is tables   # equal mesh
    # a shard count that does not divide the pool: padded slots are zero
    # pages with a false mask, as in the reference
    t3, v3, pc3 = entry.sharded_tables(MM.flat_mesh(["cpu"] * 3))
    jt3, jv3, jpc3 = jentry.sharded_tables(
        JM.flat_mesh(jax.devices()[:3]),
        NamedSharding(JM.flat_mesh(jax.devices()[:3]), P(None, None, None, JM.DATA_AXIS)),
        NamedSharding(JM.flat_mesh(jax.devices()[:3]), P(JM.DATA_AXIS)), 3)
    assert pc3 == jpc3 == 6
    assert torch.equal(torch.cat(t3, dim=3), torch.from_numpy(np.array(jt3)))
    assert torch.equal(torch.cat(v3), torch.from_numpy(np.array(jv3)))


def test_meshes_and_shard_batch_match_reference():
    """make_mesh's (blocks, sigs) grid is the reference's; shard_batch
    splits a feature-first array over it and gathers back exactly."""
    for n in (1, 2, 3, 6, 8, 12):
        assert MM._factor2(n) == JM._factor2(n)
    mesh = MM.make_mesh(["cpu"] * 8)
    ref = JM.make_mesh(jax.devices()[:8])
    assert mesh.shape == dict(ref.shape) and mesh.axis_names == ref.axis_names
    assert MM.make_mesh(["cpu"] * 8, shape=(2, 4)).grid == (2, 4)
    with pytest.raises(ValueError):
        MM.make_mesh(["cpu"] * 8, shape=(3, 2))
    assert MM.flat_mesh(["cpu"] * 3) == MM.flat_mesh(["cpu"] * 3)
    assert MM.flat_mesh(["cpu"] * 3) != MM.flat_mesh(["cpu"] * 2)
    arr = np.arange(3 * 4 * 6).reshape(3, 4, 6)
    sharded = MM.shard_batch(mesh, arr, (None, MM.BLOCK_AXIS, MM.SIG_AXIS))
    assert len(sharded.blocks) == 8 and sharded.blocks[(1, 1)].shape == (3, 1, 3)
    assert np.array_equal(sharded.numpy(), arr)
    with pytest.raises(ValueError, match="split evenly"):
        MM.shard_batch(mesh, np.zeros((3, 3, 6)), (None, MM.BLOCK_AXIS, MM.SIG_AXIS))


def test_sharded_verify_fn_splits_and_reassembles(monkeypatch):
    """sharded_verify_fn over a (2, 2) mesh: each block's rows go to the
    generic tier on its shard (here a stand-in whose verdict is the
    parity of a lane's first signature byte; the real tier is the gpu
    test's), and the verdicts come back in their (H, V) places;
    all_valid ANDs them."""
    mesh = MM.make_mesh(["cpu"] * 4, shape=(2, 2))
    blocks = []

    def rows_verdicts(rows, bucket):
        blocks.append((tuple(rows.shape), bucket))
        return (rows[32] & 1).bool()

    monkeypatch.setattr(EV, "verify_generic_rows", rows_verdicts)
    rs = np.random.RandomState(11)
    pub, sig, msg = (rs.randint(0, 256, (k, 4, 6)).astype(np.uint8) for k in (32, 64, 128))
    msglen = np.full((4, 6), 120, dtype=np.int32)
    fn = MM.sharded_verify_fn(mesh, nblocks=2)
    assert MM.sharded_verify_fn(mesh, 2) is fn
    out = fn(pub, sig, MM.shard_batch(mesh, msg, (None, MM.BLOCK_AXIS, MM.SIG_AXIS)), msglen)
    want = (sig[0] & 1) == 1
    assert out.spec == (MM.BLOCK_AXIS, MM.SIG_AXIS) and np.array_equal(out.numpy(), want)
    assert blocks == [((228, 6), 128)] * 4
    assert MM.all_valid(out) == bool(want.all()) is False
    assert MM.all_valid(np.ones(3, dtype=bool))
    with pytest.raises(ValueError, match="SHA-512 blocks"):
        MM.sharded_verify_fn(mesh, nblocks=3)(pub, sig, msg, msglen)


def _reference_routing(key_ids, ndev):
    """The reference's lane routing (parallel/mesh.py:361-373), with its
    common shard width."""
    n = len(key_ids)
    owner = key_ids % ndev
    local_ids = (key_ids // ndev).astype(np.int32)
    counts = np.bincount(owner, minlength=ndev)
    w = PR.next_pow2(int(counts.max()))
    order = np.argsort(owner, kind="stable")
    offs = np.concatenate([[0], np.cumsum(counts)])[:-1]
    dest = np.empty(n, dtype=np.int64)
    dest[order] = owner[order] * w + (np.arange(n) - offs[owner[order]])
    return owner, local_ids, counts, dest, w


@pytest.mark.parametrize("ndev", [3, 8])
def test_lane_routing_matches_reference(ndev):
    """(c) Owners, local ids, destinations and the unscatter, with shards
    that get no lanes."""
    rng = np.random.RandomState(ndev)
    # slots on shards 0 and 2 only (mod ndev): the others get no lanes
    key_ids = (rng.randint(0, 40, 37) * ndev + rng.choice([0, 2], 37)).astype(np.int32)
    r = MM.route_lanes(key_ids, ndev)
    owner, local, counts, dest, w = _reference_routing(key_ids, ndev)
    assert np.array_equal(r.owner, owner) and np.array_equal(r.local, local)
    assert np.array_equal(r.counts, counts) and (counts == 0).sum() == ndev - 2
    offs = np.concatenate([[0], np.cumsum(counts)])[:-1]
    # each lane's rank inside its shard is the reference's
    assert np.array_equal(r.dest - offs[r.owner], dest - owner * w)
    # the unscatter: shard-major verdicts indexed by dest are lane order
    lanes = np.arange(len(key_ids))
    assert np.array_equal(lanes[r.order][r.dest], lanes)
    # the reference's padded stream unscatters to the same lanes
    stream = np.full(ndev * w, -1)
    stream[dest] = lanes
    assert np.array_equal(stream[dest], lanes[r.order][r.dest])


def test_keyed_shards_pack_rebased_ids(world):
    """(c) The packed rows per shard: its lanes with their local ids, the
    batch's one bucket, the single-device padding; no rows for a shard
    with no lanes."""
    bv = MM.ShardedTorchBatchVerifier(devices=["cpu"] * 3, device_min_batch=0)
    key_ids = np.array([0, 3, 6, 2, 5, 9, 3], dtype=np.int32)
    triples = world["triples"][:7]
    pub = np.stack([np.frombuffer(p, dtype=np.uint8) for p, _, _ in triples])
    sig = np.stack([np.frombuffer(s, dtype=np.uint8) for _, _, s in triples])
    msgs = [m for _, m, _ in triples]
    msgs[4] = bytes(200)                         # the batch's bucket: 256
    routing, bucket, packed = bv.keyed_shards(key_ids, pub, sig, msgs)
    assert bucket == 256 and packed[1] is None
    for d, lanes in ((0, [0, 1, 2, 5, 6]), (2, [3, 4])):
        rows = packed[d]
        assert rows.shape == (104 + 256, max(PR.next_pow2(len(lanes)), 8))
        ids = rows[100 + 256:104 + 256, :len(lanes)].T.copy().view("<u4").ravel()
        assert list(ids) == [key_ids[i] // 3 for i in lanes]
        assert np.array_equal(rows[:32, :len(lanes)].T, pub[lanes])
        assert not rows[:, len(lanes):].any()


def test_generic_mesh_uneven_width(world, fresh, monkeypatch):
    """(d) generic_mesh at an uneven width on ["cpu"] * 3 equals the
    port's generic tier and the oracle; the block of padding only
    launches nothing."""
    triples = [list(t) for t in world["triples"][:19]]
    triples[4][1] += b"!"
    expected = [E.verify_zip215(*t) for t in triples]
    assert expected.count(False) >= 2
    monkeypatch.setattr(PR, "TABLE_MAX_KEYS", 0)
    bv = _fill(MM.ShardedTorchBatchVerifier(devices=["cpu"] * 3, device_min_batch=0), triples)
    plan = bv.plan()
    assert plan.entry is None and plan.tiers[:2] == ["generic_mesh", "generic"]
    ok, results = bv.execute(plan)
    assert bv.last_tier == "generic_mesh" and results == expected and not ok
    # 19 lanes pad to 32, then to 33: blocks of 11, 11 and 11 (8 real: 0)
    assert [(s["lanes"], s["width"]) for s in bv.last_shards] == [(11, 11), (8, 11), (0, 0)]
    single = EV.verify_arrays(plan.pub, plan.sig, plan.msgs, "cpu")
    assert list(single) == results


def _pool_pages(missing, window_bits):
    nwin, nent = 256 // window_bits, 1 << window_bits
    return (torch.zeros((nwin, 4, 26, len(missing) * nent), dtype=torch.int32),
            np.ones(len(missing), dtype=bool))


def test_placement_bytes_counted_and_released():
    """(e) Placements hung off live entries count against the budget; the
    sweep after a stale entry releases them without evicting a key
    (reference test_parallel.py:468-499)."""
    pubs_a = [ed.priv_key_from_secret(b"pa%d" % i).pub_key().bytes() for i in range(2)]
    pubs_b = [ed.priv_key_from_secret(b"pb%d" % i).pub_key().bytes() for i in range(2)]
    pool_bytes = PR._pool_cap(2) * PR._KeyPool(8, "cpu").key_bytes
    cache = PR.KeyTableCache("cpu", cap_bytes=8 * pool_bytes)
    cache._build_pages = _pool_pages
    ea = cache.lookup_or_build(pubs_a)
    with cache._lock:
        assert cache.placement_bytes() == 0
    ea.placements[("replicated", "meshX")] = (object(), 9 * pool_bytes)
    with cache._lock:
        assert cache.placement_bytes() == 9 * pool_bytes
    cache.lookup_or_build(pubs_b)
    with cache._lock:
        assert cache.placement_bytes() == 0
    assert cache.stats["keys_evicted"] == 0
    assert cache.lookup_or_build(pubs_a) is not ea
    assert cache.stats["keys_built"] == 4


def test_live_placement_counts_but_is_never_paid_for_by_eviction(monkeypatch):
    """(e) A live entry's placement counts in the over-budget trigger,
    but no key is evicted to pay for it (the stop condition compares
    the compacted pools only), as in the reference: the same sequence on
    both caches, a 2-key set on the 8-bit pool with a placement, then a
    3-key set on the 4-bit pool."""
    monkeypatch.setattr(PR, "KEY8_MAX", 2)
    monkeypatch.setattr(JPR, "KEY8_MAX", 2)
    keys = [ed.priv_key_from_secret(b"pc%d" % i).pub_key().bytes() for i in range(5)]
    kb8, kb4 = PR._KeyPool(8, "cpu").key_bytes, PR._KeyPool(4, "cpu").key_bytes
    budget = 3 * kb8 + 4 * kb4
    port = PR.KeyTableCache("cpu", cap_bytes=budget)
    port._build_pages = _pool_pages
    ref = JPR.KeyTableCache(cap_bytes=budget)
    ref._build_pages = lambda missing, wb: (jnp.asarray(_pool_pages(missing, wb)[0].numpy()),
                                            _pool_pages(missing, wb)[1])
    ea = port.lookup_or_build(keys[:2])
    ra = ref.lookup_or_build(keys[:2])
    tables, _, per_cap = ea.sharded_tables(MM.flat_mesh(["cpu"] * 2))
    assert per_cap == 1 and ea.placement_bytes() == 2 * kb8 + 2
    ra.placements[("sharded", "mesh")] = (object(), 2 * kb8 + 2)
    port.lookup_or_build(keys[2:])
    ref.lookup_or_build(keys[2:])
    assert port.stats == ref.stats == {"keys_built": 5, "keys_evicted": 0}
    with port._lock, ref._lock:
        assert port.placement_bytes() == ref.placement_bytes() == 2 * kb8 + 2
    assert port.lookup_or_build(keys[:2]) is ea


def test_shard_loss_demotes_only_the_mesh_tiers(world, fresh):
    """(f) A shard_loss window faults keyed_mesh; the ladder demotes it
    alone and keyed answers the batch exactly."""
    cm, _ = fresh
    triples = world["triples"][:8]
    expected = world["expected"][:8]
    D.CHAOS.load(D.ChaosPlan.parse("shard_loss@0-3600"))
    bv = _fill(MM.ShardedTorchBatchVerifier(devices=["cpu"] * 2, device_min_batch=0,
                                            cache=_port_cache(world)), triples)
    plan = bv.plan()
    assert plan.tiers[:2] == ["keyed_mesh", "keyed"]
    assert bv.execute(plan) == (all(expected), expected)
    assert bv.last_tier == "keyed"
    snap = D.LADDER.snapshot()
    assert [(e["kind"], e["from"], e["to"], e["reason"]) for e in snap["transitions"]] == [
        ("demote", "keyed_mesh", "keyed", "chaos:shard_loss")]
    assert [t for t, st in snap["tiers"].items() if st["demoted"]] == ["keyed_mesh"]
    for tier in ("keyed", "generic", "host"):
        D.CHAOS.inject(tier)                 # not in the window's scope
    with pytest.raises(D.ChaosFault):
        D.CHAOS.inject("generic_mesh")
    assert cm.dispatch_demotions_total.labels(
        **{"from": "keyed_mesh", "to": "keyed", "reason": "chaos:shard_loss"}).get() == 1


class _Made:
    def __init__(self, kind):
        self.kind = kind
        self.calls = []

    def __call__(self, **kw):
        self.calls.append(kw)
        return (self.kind, kw)


@pytest.mark.parametrize("ndev", [1, 2])
def test_factory_picks_the_mesh_only_with_more_than_one_card(ndev, monkeypatch):
    """(g) With ``device_status()`` at two cards a ``cuda`` caller gets the
    mesh verifier over every card; at one card, or on a named card or the
    CPU, the single-device verifier.  Nothing is launched."""
    single, sharded = _Made("single"), _Made("sharded")
    monkeypatch.setattr(EV, "TorchBatchVerifier", single)
    monkeypatch.setattr(MM, "ShardedTorchBatchVerifier", sharded)
    monkeypatch.setattr(MM, "flat_mesh", lambda devices=None: "every card")
    monkeypatch.setitem(B._device_state, "ndev", ndev)
    monkeypatch.setitem(B._device_state, "status", "ready")
    pk = ed.Ed25519PubKey(world_key())
    got = B.create_batch_verifier(pk)
    if ndev > 1:
        assert got == ("sharded", {"mesh": "every card"})
        assert B.create_batch_verifier(pk, device="cuda")[0] == "sharded"
    else:
        assert got == ("single", {"device": None})
    assert B.create_batch_verifier(pk, device="cpu") == ("single", {"device": "cpu"})
    assert B.create_batch_verifier(pk, device="cuda:1") == ("single", {"device": "cuda:1"})


def world_key() -> bytes:
    return ed.priv_key_from_secret(b"factory").pub_key().bytes()


SPECS = [
    "shard_loss@0-2.5",
    "device_loss@0-1;shard_loss@1-3;mislaunch@4-5",
    "seed=5,on=2,off=3,n=6,kinds=shard_loss|device_loss|mislaunch",
]


@pytest.mark.parametrize("spec", SPECS)
def test_chaos_plan_with_shard_loss_matches_reference(spec):
    """(h) ChaosPlan.parse and every tier's faults over time."""
    port, ref = D.ChaosPlan.parse(spec), jdispatch.ChaosPlan.parse(spec)
    assert port.windows == ref.windows
    for tier in D.TIER_ORDER:
        fired_p, fired_r = set(), set()
        for t in np.arange(0.0, 30.0, 0.25):
            assert port.fault_at(tier, t, fired_p) == ref.fault_at(tier, t, fired_r)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _norm(snap: dict) -> dict:
    snap = dict(snap)
    snap["order"] = [t for t in snap["order"] if t in D.TIER_ORDER]
    snap["tiers"] = {t: v for t, v in snap["tiers"].items() if t in D.TIER_ORDER}
    snap["transitions"] = [{k: v for k, v in e.items() if k != "at"}
                           for e in snap["transitions"]]
    return snap


def _call(name, *args, **kw):
    return lambda ladder, clock: getattr(ladder, name)(*args, **kw)


def _tick(dt):
    def step(ladder, clock):
        clock.t += dt
    return step


MESH = ["keyed_mesh", "keyed", "generic_mesh", "generic"]

#: a shard lost (keyed_mesh then generic_mesh demoted to their
#: single-device rungs), canaries, a half-open trial of keyed_mesh and
#: its promotion, the current tier and the cost model on mesh tiers
SCRIPT = [
    _call("admissible", MESH),
    _call("current_tier"),
    _call("route", MESH, 150),
    _call("note_batch", "keyed_mesh", 150, 0.004),
    _call("tier_fault", "keyed_mesh", "chaos:shard_loss", 150),
    _call("current_tier"),
    _call("admissible", MESH),
    _call("tier_fault", "generic_mesh", "chaos:shard_loss", 150),
    _call("admissible", MESH),
    _call("note_probe", "generic_mesh", False),
    _tick(1.5),
    _call("active", "keyed_mesh"),
    _call("note_batch", "keyed_mesh", 150, 0.003),
    _call("current_tier"),
    _call("note_probe", "generic_mesh", True),
    _call("note_probe", "generic_mesh", True),
    _call("watchdog_fault", "keyed_mesh"),
    _call("route", ["keyed", "generic_mesh", "generic"], 1024),
    _call("note_batch", "keyed", 1024, 0.002),
    _call("note_batch", "keyed", 1024, 0.002),
    _call("note_batch", "generic_mesh", 1024, 0.02),
    _call("route", ["keyed", "generic_mesh", "generic"], 1024),
    _tick(10.0),
    _call("admissible", MESH),
    _call("current_tier"),
]


def test_ladder_replays_reference_with_mesh_tiers():
    """(h) One scripted sequence over the mesh tiers through both
    ladders, each on an injected clock: equal return values and
    snapshots after every step."""
    clock = _Clock()
    policy = dict(demote_after=2, promote_after=2, cooldown_s=1.0, cooldown_max_s=4.0)
    cost = dict(enabled=True, min_samples=2, margin=0.2, cooldown_s=5.0)
    port = D.DispatchLadder(clock=clock, cost_model=D.TierCostModel(**cost), **policy)
    ref = jdispatch.DispatchLadder(clock=clock, cost_model=jdispatch.TierCostModel(**cost),
                                   **policy)
    port._cost.seeded = ref._cost.seeded = True
    for i, step in enumerate(SCRIPT):
        assert step(port, clock) == step(ref, clock), f"step {i}"
        assert _norm(port.snapshot()) == _norm(ref.snapshot()), f"step {i}"
    trail = [(e["kind"], e["from"], e["to"], e["reason"])
             for e in port.snapshot()["transitions"]]
    assert trail[:2] == [("demote", "keyed_mesh", "keyed", "chaos:shard_loss"),
                         ("demote", "generic_mesh", "generic", "chaos:shard_loss")]
    assert ("promote", "keyed_mesh", "keyed_mesh", "trial_success") in trail
