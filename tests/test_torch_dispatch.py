"""The port's dispatch ladder, chaos plan, cost model, launch watchdog,
crypto metrics and ``TorchBatchVerifier``'s routing and tier walk,
against the reference's (cometbft_tpu/crypto/dispatch.py,
crypto/health.py, metrics, ops/ed25519_verify.py).  Tolerance: exact
(equal snapshots, routes, reasons, tier lists, exposition samples and
verdict vectors).

The reference's snapshots carry its BLS rung, its mesh tiers and its
cost model's ledger seeding, none of which the port has; the
comparison drops those keys (``_norm_ladder``, ``_norm_cost``) and
nothing else.  Where the port departs on purpose -- only typed tier
faults walk down, cold samples stay out of the cost model, a learned
order re-samples the tier it displaced -- the tests say so."""

import json
import time
import types

import numpy as np
import pytest

from cometbft_tpu.crypto import dispatch as jdispatch
from cometbft_tpu.crypto import ed25519 as jed
from cometbft_tpu import metrics as jmetrics
from cometbft_tpu.ops import ed25519_verify as JEV
from cometbft_tpu.utils import metrics as jum
from cometbft_tpu_torch import metrics as M
from cometbft_tpu_torch.crypto import dispatch as D
from cometbft_tpu_torch.crypto import ed25519 as ed
from cometbft_tpu_torch.crypto import edwards as E
from cometbft_tpu_torch.crypto import health as H
from cometbft_tpu_torch.ops import ed25519_verify as EV
from cometbft_tpu_torch.ops import precompute as PR
from cometbft_tpu_torch.utils import metrics as um
from cometbft_tpu_torch.utils.flight import FLIGHT

SEED = 0xD15


class Clock:
    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


@pytest.fixture(autouse=True)
def clean_ladder():
    """Every test starts and ends with fresh ladders, no chaos and no-op
    metrics, in both packages."""
    D.reset_for_tests()
    jdispatch.reset_for_tests()
    yield
    D.reset_for_tests()
    jdispatch.reset_for_tests()
    M.install_crypto_metrics(None)
    M.install_health_metrics(None)


@pytest.fixture
def metrics():
    cm, hm = M.CryptoMetrics(um.Registry()), M.HealthMetrics(um.Registry())
    M.install_crypto_metrics(cm)
    M.install_health_metrics(hm)
    return cm, hm


def _norm_ladder(snap: dict) -> dict:
    snap = dict(snap)
    snap["order"] = [t for t in snap["order"] if t in D.TIER_ORDER]
    snap["tiers"] = {t: v for t, v in snap["tiers"].items() if t in D.TIER_ORDER}
    snap["transitions"] = [{k: v for k, v in e.items() if k != "at"}
                           for e in snap["transitions"]]
    return snap


def _norm_cost(snap: dict) -> dict:
    snap = {k: v for k, v in snap.items() if k != "seeded"}
    snap["table"] = [{k: v for k, v in row.items() if k not in ("family", "config")}
                     for row in snap["table"]]
    snap["orders"] = [{k: v for k, v in row.items() if k != "family"}
                      for row in snap["orders"]]
    return snap


def _ladders(**policy):
    clock = Clock()
    cost = dict(enabled=True, min_samples=2, margin=0.2, cooldown_s=5.0)
    port = D.DispatchLadder(clock=clock, cost_model=D.TierCostModel(**cost), **policy)
    ref = jdispatch.DispatchLadder(clock=clock, cost_model=jdispatch.TierCostModel(**cost),
                                   **policy)
    # no ledger seeding: both models learn online only
    port._cost.seeded = ref._cost.seeded = True
    return clock, port, ref


def _tick(dt):
    def step(ladder, clock):
        clock.t += dt
    return step


def _call(name, *args, **kw):
    return lambda ladder, clock: getattr(ladder, name)(*args, **kw)


#: one scripted sequence: demotion, a duplicate fault inside the
#: cool-down, half-open re-admission and trial promotion, the watchdog,
#: canary promotion and demotion, a probe spending the half-open trial,
#: and the cost model learning, reordering and holding an order
SCRIPT = [
    _call("admissible", ["keyed", "generic"]),
    _call("route", ["keyed", "generic"], 150),
    _call("note_batch", "keyed", 150, 0.002),
    _call("tier_fault", "keyed", "chaos:device_loss", 150),
    _call("current_tier"),
    _tick(0.5),
    _call("admissible", ["keyed", "generic"]),
    _call("tier_fault", "keyed", "launch:RuntimeError", 150),
    _tick(1.0),
    _call("active", "keyed"),
    _call("note_batch", "keyed", 150, 0.001),
    _call("watchdog_fault", "generic"),
    _call("note_probe", "generic", True),
    _tick(1.5),
    _call("note_probe", "generic", True),
    _call("note_probe", "keyed", False),
    _call("note_probe", "keyed", False),
    _call("note_probe", "keyed", False),
    _tick(10.0),
    _call("note_probe", "keyed", False),
    _call("active", "keyed"),
    _call("note_probe", "python", False),
    _call("tier_fault", "python", "never"),
    _call("note_batch", "generic", 200, 0.010),
    _call("note_batch", "host", 200, 0.001),
    _call("note_batch", "generic", 200, 0.010),
    _call("route", ["generic"], 200),
    _call("note_batch", "host", 200, 0.001),
    _call("route", ["generic"], 200),
    _call("note_batch", "generic", 200, 0.0001),
    _call("note_batch", "generic", 200, 0.0001),
    _call("note_batch", "generic", 200, 0.0001),
    _call("note_batch", "generic", 200, 0.0001),
    _call("route", ["generic"], 200),
    _tick(6.0),
    _call("route", ["generic"], 200),
    _call("note_batch", "python", 2, 0.01),
    _call("note_route", "host", 2),
    _call("route", [], 1, add_host=False),
    _call("current_tier"),
]


def test_ladder_and_cost_model_replay_reference():
    """One scripted sequence through both ladders, each with an injected
    clock: equal return values and snapshots after every step."""
    clock, port, ref = _ladders(demote_after=3, promote_after=2, cooldown_s=1.0,
                                cooldown_max_s=4.0)
    for i, step in enumerate(SCRIPT):
        assert step(port, clock) == step(ref, clock), f"step {i}"
        assert _norm_ladder(port.snapshot()) == _norm_ladder(ref.snapshot()), f"step {i}"
        assert _norm_cost(port.cost_snapshot()) == _norm_cost(ref.cost_snapshot()), \
            f"step {i}"
    snap = port.snapshot()
    assert [e["reason"] for e in snap["transitions"]] == [
        "chaos:device_loss", "launch:RuntimeError", "trial_success", "watchdog", "probes",
        "probe_failures", "probe_failures"]
    assert snap["tiers"]["keyed"]["next_cooldown_s"] == 4.0
    assert [o["order"] for o in port.cost_snapshot()["orders"]] == [["host", "generic"]]


SPECS = [
    "device_loss@0-2.5; mislaunch@4-5 ;launch_hang@6-7",
    "seed=7,on=2,off=5,n=6,kinds=device_loss|mislaunch",
    "seed=0,on=2,off=8,n=8,kinds=device_loss|mislaunch",
    "launch_hang@1-2;seed=3",
]
BAD_SPECS = ["device_loss@5-2", "device_loss@-1-2", "device_loss", "", " ; ",
             "bogus@0-1", "seed=1,foo=2", "device_loss@a-b"]


@pytest.mark.parametrize("spec", SPECS)
def test_chaos_plan_matches_reference(spec):
    port, ref = D.ChaosPlan.parse(spec), jdispatch.ChaosPlan.parse(spec)
    assert port.windows == ref.windows
    for tier in D.TIER_ORDER:
        for t in np.arange(0.0, 40.0, 0.25):
            fired_p, fired_r = set(), set()
            assert port.fault_at(tier, t, fired_p) == ref.fault_at(tier, t, fired_r)


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_chaos_plan_rejects_what_reference_rejects(spec):
    with pytest.raises(ValueError):
        jdispatch.ChaosPlan.parse(spec)
    with pytest.raises(ValueError):
        D.ChaosPlan.parse(spec)


def test_chaos_scope_and_one_shot():
    D.CHAOS.load(D.ChaosPlan.parse("mislaunch@0-3600"), tiers=("keyed",))
    D.CHAOS.inject("generic")            # out of scope
    D.CHAOS.inject("host")               # the floor is never faulted
    with pytest.raises(D.ChaosFault) as err:
        D.CHAOS.inject("keyed")
    assert D.fault_reason(err.value) == "chaos:mislaunch"
    D.CHAOS.inject("keyed")              # the window's one shot is spent
    assert D.CHAOS.snapshot()["hits"] == {"mislaunch": 1}
    D.CHAOS.load(None)
    assert not D.CHAOS.enabled()
    assert D.fault_reason(ValueError()) == "launch:ValueError"
    assert D.fault_reason(D.TierUnavailable("x", "")) == "TierUnavailable"
    # the reference's mesh kind faults the mesh tiers and nothing else
    port = D.ChaosPlan.parse("shard_loss@0-1")
    assert port.windows == jdispatch.ChaosPlan.parse("shard_loss@0-1").windows
    assert [t for t in D.TIER_ORDER if port.fault_at(t, 0.5, set())] == [
        "keyed_mesh", "generic_mesh"]


@pytest.mark.parametrize("rtt", [1e-6, 2e-5, 6.4e-4, 6.5e-4, 3e-3, 1.0])
def test_crossover_matches_reference(rtt, monkeypatch, tmp_path):
    """The calibrated threshold from a round trip: the reference's
    formula, with the reference's per-signature defaults on both sides
    (the port's own are measured on its card's machine), on a stand-in
    for the reference's device probe."""
    monkeypatch.delenv("CMT_TPU_DEVICE_MIN_BATCH", raising=False)
    monkeypatch.setattr(JEV, "_runtime_threshold", None)
    monkeypatch.setattr(JEV, "CALIBRATION_PATH", str(tmp_path / "none.json"))
    monkeypatch.setattr(JEV, "_measure_link_rtt", lambda: rtt)
    monkeypatch.setattr(JEV.jax, "devices", lambda: [types.SimpleNamespace(platform="gpu")])
    assert EV.crossover_batch(rtt, JEV._DEFAULT_T_CPU_SIG, JEV._DEFAULT_T_DEV_SIG) == \
        JEV.runtime_device_min_batch()


def test_cpu_sentinel_matches_reference(monkeypatch):
    monkeypatch.delenv("CMT_TPU_DEVICE_MIN_BATCH", raising=False)
    monkeypatch.setattr(JEV, "_runtime_threshold", None)
    assert EV.runtime_device_min_batch("cpu") == JEV.runtime_device_min_batch() == 1 << 30
    assert EV.TorchBatchVerifier(device="cpu")._device_min_batch == EV.CPU_SENTINEL


@pytest.fixture(scope="module")
def votes():
    """8 votes under two keys, lane 5 altered; the oracle's verdicts."""
    rs = np.random.RandomState(SEED)
    privs = [ed.priv_key_from_secret(b"dispatch-%d" % i) for i in range(2)]
    triples = []
    for i in range(8):
        msg = rs.bytes(100)
        triples.append((privs[i % 2].pub_key().bytes(), msg, privs[i % 2].sign(msg)))
    triples[5] = (triples[5][0], triples[5][1] + b"!", triples[5][2])
    return triples, [E.verify_zip215(*t) for t in triples]


def _port(triples, **kw):
    bv = EV.TorchBatchVerifier(device="cpu", **kw)
    for p, m, s in triples:
        bv.add(ed.Ed25519PubKey(p), m, s)
    return bv


def _ref(triples, **kw):
    bv = JEV.TpuBatchVerifier(**kw)
    for p, m, s in triples:
        bv.add(jed.Ed25519PubKey(p), m, s)
    return bv


def _demote_devices(ladder):
    ladder.admissible(["keyed", "generic"])
    ladder.tier_fault("keyed", reason="watchdog")
    ladder.tier_fault("generic", reason="watchdog")


@pytest.mark.parametrize("case", ["under_threshold", "msg_too_large", "msg_too_large_small",
                                  "demoted", "calibration"])
def test_host_route_matches_reference(case, votes):
    """plan() on batches that need no compile: the route, reason and
    tier list equal the reference's."""
    triples = list(votes[0][:3])
    kw = {"under_threshold": 64, "msg_too_large": 0, "msg_too_large_small": 64,
          "demoted": 0, "calibration": EV.CPU_SENTINEL}[case]
    if case.startswith("msg_too_large"):
        triples[1] = (triples[1][0], bytes(5000), triples[1][2])
    if case == "demoted":
        _demote_devices(D.LADDER)
        _demote_devices(jdispatch.LADDER)
    port = _port(triples, device_min_batch=kw).plan()
    ref = _ref(triples, device_min_batch=kw).plan()
    assert (port.route, port.reason, port.tiers) == (ref.route, ref.reason, ref.tiers)
    want = {"under_threshold": "batch_size", "msg_too_large": "msg_too_large",
            "msg_too_large_small": "msg_too_large", "demoted": "ladder_demoted",
            "calibration": "calibration"}[case]
    assert (port.route, port.reason, port.tiers) == ("host", want, ["host", "python"])


def test_host_route_answers_exactly(votes, metrics):
    triples, expected = votes
    bv = _port(triples, device_min_batch=64)
    assert bv.verify() == (False, expected) and bv.last_tier == "host"
    cm = metrics[0]
    assert cm.dispatch_decisions.labels(route="host", reason="batch_size").get() == 1
    assert cm.dispatch_tier.labels(tier="host").get() == 1
    assert cm.dispatch_route.labels(tier="host", bucket="8", source="static").get() == 1
    assert _port([], device_min_batch=0).verify() == (False, [])


@pytest.fixture
def stand_in_cache(monkeypatch):
    """A cache whose page build is a stand-in (zero pages, every key
    valid): the keyed tier is faulted before it reads a page, so no EC
    build runs."""
    import torch

    def pages(missing, window_bits):
        nwin, nent = 256 // window_bits, 1 << window_bits
        return (torch.zeros((nwin, 4, 26, len(missing) * nent), dtype=torch.int32),
                np.ones(len(missing), dtype=bool))

    cache = PR.KeyTableCache("cpu")
    monkeypatch.setattr(cache, "_build_pages", pages)
    return cache


def test_walk_down_on_planted_faults_answers_exactly(votes, stand_in_cache, metrics):
    """A device loss on the keyed tier: generic answers (its plain
    version on the CPU), exactly; with generic lost too, host answers.
    Each demotion is recorded with its reason in the ladder's ring,
    FLIGHT and dispatch_demotions_total."""
    triples, expected = votes
    cm = metrics[0]
    mark = FLIGHT.recorded_total
    D.CHAOS.load(D.ChaosPlan.parse("device_loss@0-3600"), tiers=("keyed",))
    bv = _port(triples, device_min_batch=0, cache=stand_in_cache)
    plan = bv.plan()
    assert (plan.route, plan.tiers) == ("device", ["keyed", "generic", "host", "python"])
    assert bv.execute(plan) == (False, expected) and bv.last_tier == "generic"
    D.CHAOS.load(D.ChaosPlan.parse("device_loss@0-3600"), tiers=("keyed", "generic"))
    bv = _port(triples, device_min_batch=0, cache=stand_in_cache)
    plan = bv.plan()
    assert plan.tiers == ["generic", "host", "python"]   # keyed demoted: no lookup
    assert bv.execute(plan) == (False, expected) and bv.last_tier == "host"
    snap = D.LADDER.snapshot()
    assert [(e["from"], e["to"], e["reason"]) for e in snap["transitions"]] == [
        ("keyed", "generic", "chaos:device_loss"), ("generic", "host", "chaos:device_loss")]
    flight = [e for e in FLIGHT.events()[-(FLIGHT.recorded_total - mark):]
              if e["kind"] == "crypto/dispatch_transition"]
    assert [(e["tier"], e["reason"]) for e in flight] == [
        ("keyed", "chaos:device_loss"), ("generic", "chaos:device_loss")]
    assert cm.dispatch_demotions_total.labels(
        **{"from": "keyed", "to": "generic", "reason": "chaos:device_loss"}).get() == 1
    assert cm.dispatch_current_tier.labels(tier="host").get() == 1


def test_launch_fault_and_table_fault_are_recorded(votes, stand_in_cache, monkeypatch):
    """A launch that raises a typed fault demotes its tier with the
    fault's reason; a table lookup that raises one demotes keyed in
    plan() (table_lookup:<type>) and the batch is planned from the
    generic tier.  The runner is a stand-in so no device path runs."""
    triples, _ = votes
    ran = []

    def runner(tier, plan):
        ran.append(tier)
        if tier == "keyed":
            raise D.TierFault("keyed", "launch:lost")
        return np.ones(plan.n, dtype=bool)

    bv = _port(triples, device_min_batch=0, cache=stand_in_cache)
    monkeypatch.setattr(bv, "_run_tier", runner)
    assert bv.verify() == (True, [True] * 8) and ran == ["keyed", "generic"]
    assert D.LADDER.snapshot()["tiers"]["keyed"]["last_reason"] == "launch:lost"
    D.reset_for_tests()

    def broken(pubs):
        raise D.TierFault("keyed", "pool lost")

    monkeypatch.setattr(stand_in_cache, "lookup_or_build", broken)
    plan = _port(triples, device_min_batch=0, cache=stand_in_cache).plan()
    assert (plan.route, plan.entry, plan.tiers) == ("device", None,
                                                    ["generic", "host", "python"])
    assert [(e["from"], e["reason"]) for e in D.LADDER.snapshot()["transitions"]] == [
        ("keyed", "table_lookup:TierFault")]


@pytest.mark.parametrize("where", ["launch", "lookup", "host"])
def test_untyped_tier_errors_reach_the_caller(where, votes, stand_in_cache, monkeypatch):
    """A kernel that fails to build or to launch, a table build that
    fails, or a host library that fails to build is not a route: the
    error reaches the caller and the ladder records nothing (the
    reference would walk down on each)."""
    triples, _ = votes
    bv = _port(triples, device_min_batch=64 if where == "host" else 0,
               cache=stand_in_cache)
    err = RuntimeError(f"{where}: failed")

    def boom(*args, **kw):
        raise err

    if where == "launch":
        monkeypatch.setattr(bv, "_run_tier", boom)
    elif where == "lookup":
        monkeypatch.setattr(stand_in_cache, "lookup_or_build", boom)
    else:
        monkeypatch.setattr(ed.CpuBatchVerifier, "verify", boom)
    with pytest.raises(RuntimeError) as got:
        bv.verify()
    assert got.value is err and bv.last_tier is None
    snap = D.LADDER.snapshot()
    assert snap["transitions"] == [] and not any(t["demoted"] for t in snap["tiers"].values())


def test_demoted_between_plan_and_execute_is_skipped(votes, monkeypatch):
    triples, _ = votes
    bv = _port(triples, device_min_batch=0, cache=PR.KeyTableCache("cpu"))
    monkeypatch.setattr(PR.KeyTableCache, "lookup_or_build", lambda self, pubs: None)
    launched = []
    monkeypatch.setattr(bv, "_run_tier",
                        lambda tier, plan: launched.append(tier) or np.ones(plan.n, bool))
    plan = bv.plan()
    assert plan.tiers == ["generic", "host", "python"]
    D.LADDER.tier_fault("generic", reason="watchdog")
    assert bv.execute(plan)[0] is False and launched == []
    assert bv.last_tier == "host"
    assert len(D.LADDER.snapshot()["transitions"]) == 1


def test_half_open_trial_promotes_through_execute(votes, stand_in_cache, monkeypatch):
    """After the cool-down (an injected clock) the demoted keyed tier
    runs the next batch on trial, and its success promotes it."""
    triples, _ = votes
    clock = Clock()
    D.LADDER.reset(cooldown_s=1.0, clock=clock)
    D.CHAOS.load(D.ChaosPlan.parse("device_loss@0-3600"), tiers=("keyed",))

    def verifier():
        bv = _port(triples, device_min_batch=0, cache=stand_in_cache)
        monkeypatch.setattr(bv, "_run_tier", lambda tier, plan: np.ones(plan.n, bool))
        return bv

    bv = verifier()
    assert bv.verify()[0] and bv.last_tier == "generic"
    bv = verifier()
    assert bv.plan().tiers[0] == "generic"       # still cooling down
    clock.t = 1.5
    D.CHAOS.load(None)
    bv = verifier()
    assert bv.verify()[0] and bv.last_tier == "keyed"
    snap = D.LADDER.snapshot()
    assert snap["tiers"]["keyed"]["demoted"] is False
    assert [e["reason"] for e in snap["transitions"]] == ["chaos:device_loss",
                                                          "trial_success"]
    bv = verifier()
    assert bv.verify()[0] and bv.last_tier == "keyed"


def test_cost_model_orders_the_walk(votes, monkeypatch):
    """Once learned, a faster host rung leads a device batch's walk."""
    triples, _ = votes
    D.LADDER.reset(cost_model=D.TierCostModel(min_samples=1))
    monkeypatch.setattr(PR.KeyTableCache, "lookup_or_build", lambda self, pubs: None)
    D.LADDER.note_batch("generic", 8, 1.0)
    D.LADDER.note_batch("host", 8, 0.001)
    bv = _port(triples, device_min_batch=0, cache=PR.KeyTableCache("cpu"))
    assert bv.plan().tiers == ["host", "generic", "python"]


def test_launch_hang_trips_watchdog_then_walks_down(votes, metrics, monkeypatch):
    """A launch_hang on generic under a 0.15 s budget: the watchdog
    fires (device_hangs_total 1, a watchdog demotion), the chaos fault
    is recorded once more without a second back-off step, and the
    host tier answers exactly."""
    triples, expected = votes
    hm = metrics[1]
    monkeypatch.setattr(H.WATCHDOG, "budget_s", 0.15)
    monkeypatch.setattr(PR.KeyTableCache, "lookup_or_build", lambda self, pubs: None)
    D.CHAOS.load(D.ChaosPlan.parse("launch_hang@0-3600"))
    bv = _port(triples, device_min_batch=0, cache=PR.KeyTableCache("cpu"))
    t0 = time.perf_counter()
    assert bv.verify() == (False, expected) and bv.last_tier == "host"
    assert time.perf_counter() - t0 < 5.0
    assert hm.device_hangs_total.labels().get() == 1
    snap = D.LADDER.snapshot()
    assert [e["reason"] for e in snap["transitions"]] == ["watchdog", "chaos:launch_hang"]
    assert snap["tiers"]["generic"]["next_cooldown_s"] == 60.0
    assert hm.launch_queue_wait_seconds.labels()._count == 1


def test_hung_launch_that_raises_walks_down(votes, metrics, monkeypatch):
    """A launch the watchdog declared hung (0.1 s budget) that then
    raises an untyped error becomes a typed fault of its tier: the
    batch walks down and the back-off advances once."""
    triples, expected = votes
    monkeypatch.setattr(H.WATCHDOG, "budget_s", 0.1)
    monkeypatch.setattr(PR.KeyTableCache, "lookup_or_build", lambda self, pubs: None)
    bv = _port(triples, device_min_batch=0, cache=PR.KeyTableCache("cpu"))

    def wedged(tier, plan):
        time.sleep(0.3)
        raise RuntimeError("CUDA error: unspecified launch failure")

    monkeypatch.setattr(bv, "_run_tier", wedged)
    assert bv.verify() == (False, expected) and bv.last_tier == "host"
    assert metrics[1].device_hangs_total.labels().get() == 1
    snap = D.LADDER.snapshot()
    assert [e["reason"] for e in snap["transitions"]] == ["watchdog", "launch:RuntimeError"]
    assert snap["tiers"]["generic"]["next_cooldown_s"] == 60.0


def test_cold_runs_stay_out_of_the_cost_model(votes, stand_in_cache, monkeypatch):
    """A device tier's first run in the process, and the keyed tier's
    first run on a table entry, answer and are counted, but give the
    cost model no sample; the next run on the same entry does."""
    triples, _ = votes
    monkeypatch.setattr(EV, "_RAN_TIERS", set())

    def verify():
        bv = _port(triples, device_min_batch=0, cache=stand_in_cache)
        monkeypatch.setattr(bv, "_run_tier", lambda tier, plan: np.ones(plan.n, bool))
        plan = bv.plan()
        assert bv.execute(plan)[0] and bv.last_tier == "keyed"
        return plan.entry, [(r["tier"], r["samples"]) for r in D.LADDER.cost_snapshot()["table"]]

    entry, table = verify()
    assert entry.launched and table == []           # the tier's first run
    entry.launched = False
    assert verify() == (entry, [])                  # the entry's first run
    assert verify() == (entry, [("keyed", 1)])


class _FakeEvent:
    """A stand-in for a CUDA event: ``elapsed_time`` is 1 ms."""

    def __init__(self, handle: int) -> None:
        self.cuda_event = handle

    def synchronize(self) -> None:
        pass

    def elapsed_time(self, end) -> float:
        return 1.0


def test_device_timing_hands_out_events_only_inside_its_block(monkeypatch):
    """``_launch_events`` gives a launcher (None, None) outside a
    device_timing block and a (start, end) pair of handles inside it,
    from the thread's pool; ``seconds()`` sums the pairs' intervals and
    the block's end returns the events to the pool."""
    dev = types.SimpleNamespace(index=0)
    pool = [_FakeEvent(k) for k in range(1, 5)]
    monkeypatch.setattr(EV._TIMING, "pool", {0: list(pool)}, raising=False)
    assert EV._launch_events(dev) == (None, None)
    with EV.device_timing() as t:
        assert EV._launch_events(dev) == (4, 3)
        assert EV._launch_events(dev) == (2, 1)
    assert t.seconds() == pytest.approx(0.002)
    assert sorted(e.cuda_event for e in EV._TIMING.pool[0]) == [1, 2, 3, 4]
    assert EV._launch_events(dev) == (None, None)
    with EV.device_timing() as t:
        pass
    assert t.seconds() is None


def test_a_device_tiers_sample_is_its_kernels_time(votes, stand_in_cache, monkeypatch):
    """On a card a device tier's cost-model sample is its kernels' time
    from the launchers' events (the reference takes the batch's wall): a
    run that waits -- here a sleep, in a node the interpreter lock held
    by its other threads -- adds nothing to it.  Where no kernel timed
    itself (the plain versions on the CPU) the sample is the wall."""
    triples, _ = votes
    monkeypatch.setattr(EV, "_RAN_TIERS", {"keyed"})
    dev = types.SimpleNamespace(index=0)
    monkeypatch.setattr(EV._TIMING, "pool", {0: [_FakeEvent(k) for k in range(4)]},
                        raising=False)

    def run(launch_events):
        def waits(tier, plan):
            if launch_events:
                EV._launch_events(dev)      # a kernel's pair: 1 ms
            time.sleep(0.2)
            return np.ones(plan.n, bool)

        D.reset_for_tests()
        bv = _port(triples, device_min_batch=0, cache=stand_in_cache)
        monkeypatch.setattr(bv, "_run_tier", waits)
        plan = bv.plan()
        plan.entry.launched = True
        t0 = time.perf_counter()
        assert bv.execute(plan)[0] and bv.last_tier == "keyed"
        assert time.perf_counter() - t0 >= 0.2
        [row] = D.LADDER.cost_snapshot()["table"]
        assert (row["tier"], row["samples"]) == ("keyed", 1)
        return row["sigs_per_sec"] * 1e-3 / plan.n

    assert run(True) == pytest.approx(1.0)           # n signatures in 1 ms
    assert run(False) < 1.0 / 200                     # the wall: over 0.2 s


def test_a_card_ledger_in_the_checkout_changes_no_test(votes, stand_in_cache, monkeypatch,
                                                       tmp_path):
    """chip_smoke.py appends its tier rows to the port's perf ledger in
    the checkout.  With such a ledger in place (generic ranked above
    keyed at buckets 256 and 1024, host above both at 8), the tests'
    ladders read none of it: the replay and the cold-run tests hold."""
    rows = [{"config": f"{tier}{batch}", "dispatch_tier": tier, "batch": batch,
             "sigs_per_sec": rate, "route_seed": True, "platform": "gpu"}
            for tier, batch, rate in (("generic", 150, 9e5), ("keyed", 150, 1e5),
                                      ("generic", 1024, 9e5), ("keyed", 1024, 1e5),
                                      ("host", 8, 1e7), ("generic", 8, 1e3))]
    path = tmp_path / "perf_ledger.json"
    path.write_text(json.dumps({"entries": rows}))
    monkeypatch.setattr(H, "PERF_LEDGER", str(path))
    assert sorted(H.measured_tier_throughput()) == ["generic", "host", "keyed"]
    D.reset_for_tests()
    assert D.LADDER.cost_snapshot()["table"] == []
    test_ladder_and_cost_model_replay_reference()
    test_cold_runs_stay_out_of_the_cost_model(votes, stand_in_cache, monkeypatch)
    # the switch that lets a test seed from the file it names
    D.reset_for_tests(ledger=True)
    assert D.LADDER.route(["keyed", "generic"], 150) == ["generic", "keyed", "host"]


def test_learned_order_resamples_the_displaced_tier(monkeypatch):
    """Under a learned order every ROUTE_RESAMPLE_EVERY-th batch of the
    bucket takes the static order; until then the walk is the
    reference's."""
    monkeypatch.setattr(D, "ROUTE_RESAMPLE_EVERY", 4)
    clock, port, ref = _ladders()
    for ladder in (port, ref):
        for _ in range(2):
            ladder.note_batch("generic", 200, 0.010)
            ladder.note_batch("host", 200, 0.001)
    walks = [port.route(["generic"], 200) for _ in range(8)]
    assert walks[:3] == [ref.route(["generic"], 200) for _ in range(3)] == [
        ["host", "generic"]] * 3
    assert walks[3] == walks[7] == ["generic", "host"]
    assert walks[4:7] == [["host", "generic"]] * 3
    # the displaced tier, measured again and now faster, takes its place
    # back once the adopted order's cool-down has passed
    for _ in range(16):   # the EWMA's clamp lets an estimate rise 1.2x a sample
        port.note_batch("generic", 200, 0.0001)
    clock.t += 5.0
    assert port.route(["generic"], 200) == ["generic", "host"]
    assert port.cost_snapshot()["orders"][0]["reorders"] == 2


def test_floor_reraises(votes, monkeypatch):
    """A typed fault of the host tier walks down to the floor; an
    exception of the floor reaches the caller."""
    triples, _ = votes
    bv = _port(triples, device_min_batch=64)

    def host(plan):
        raise D.TierFault("host", "library lost")

    def boom(plan):
        raise ValueError("a bug")

    monkeypatch.setattr(bv, "_run_host", host)
    monkeypatch.setattr(bv, "_run_python", boom)
    with pytest.raises(ValueError, match="a bug"):
        bv.verify()
    assert D.LADDER.snapshot()["tiers"]["host"]["last_reason"] == "library lost"


def test_watchdog_thread_stops():
    wd = H.LaunchWatchdog(budget_s=0.05)
    token = wd.arm("generic", batch=3)
    time.sleep(0.2)
    assert wd.disarm(token) is True
    assert D.LADDER.snapshot()["tiers"]["generic"]["last_reason"] == "watchdog"
    thread = wd._thread
    wd.stop()
    assert not thread.is_alive()
    assert wd.snapshot() == {"budget_s": 0.05, "active_launches": []}


def test_device_usage_accounts_busy_and_idle(metrics):
    usage = H.DeviceUsage()
    t0 = time.perf_counter()
    time.sleep(0.01)
    usage.launch_end(t0)
    time.sleep(0.02)
    usage.launch_end(time.perf_counter())
    snap = usage.snapshot()
    assert snap["launches"] == 2
    assert snap["busy_seconds"] >= 0.01 and snap["idle_seconds"] >= 0.02
    assert 0 < snap["occupancy"] < 1
    hm = metrics[1]
    assert hm.device_busy_seconds_total.labels(device="0").get() == pytest.approx(
        snap["busy_seconds"], abs=1e-6)
    assert hm.device_idle_seconds_total.labels(device="0").get() == pytest.approx(
        snap["idle_seconds"], abs=1e-6)


def _update(cm, hm):
    cm.batch_verify_launches.labels(kernel="host_rlc").inc()
    cm.batch_verify_batch_size.observe(150)
    cm.dispatch_decisions.labels(route="host", reason="msg_too_large").inc()
    cm.dispatch_tier.labels(tier="keyed").inc(3)
    cm.dispatch_route.labels(tier="keyed", bucket="256", source="static").inc()
    cm.route_reorders_total.labels(bucket="8").inc()
    cm.dispatch_demotions_total.labels(**{"from": "keyed", "to": "generic",
                                          "reason": "watchdog"}).inc()
    cm.dispatch_promotions_total.labels(tier="keyed").inc()
    cm.dispatch_current_tier.labels(tier="generic").set(1.0)
    cm.kernel_time_seconds.observe(0.0008)
    cm.host_verify_time_seconds.observe(0.3)
    cm.key_pool_keys.labels(window_bits="8").set(150)
    cm.key_pool_capacity.labels(window_bits="8").set(256)
    cm.key_pool_builds.inc(150)
    cm.key_pool_evictions.inc()
    hm.device_hangs_total.inc()
    hm.device_busy_seconds_total.labels(device="0").inc(0.5)
    hm.device_idle_seconds_total.labels(device="0").inc(0.25)
    hm.launch_queue_wait_seconds.observe(0.002)


def test_metrics_exposition_matches_reference():
    """The same updates on both packages' structs expose the same
    samples (names, labels, values) for every series the port has."""
    preg, rreg = um.Registry(), jum.Registry()
    _update(M.CryptoMetrics(preg), M.HealthMetrics(preg))
    _update(jmetrics.CryptoMetrics(rreg), jmetrics.HealthMetrics(rreg))
    port = [line for line in preg.expose().splitlines() if not line.startswith("#")]
    names = {line.split("{")[0].split(" ")[0] for line in port}
    ref = [line for line in rreg.expose().splitlines()
           if not line.startswith("#") and line.split("{")[0].split(" ")[0] in names]
    assert port == ref and len(port) > 40


def test_pool_metrics(monkeypatch, metrics):
    """key_pool_builds / key_pool_evictions / key_pool_keys /
    key_pool_capacity follow the pool, as the reference's pool writes
    them (stand-in pages; a budget of 3 8-bit pages forces eviction)."""
    import hashlib

    import torch

    kb8 = 32 * 4 * 26 * 256 * 4
    cache = PR.KeyTableCache("cpu", cap_bytes=3 * kb8)

    def pages(missing, window_bits):
        nwin, nent = 256 // window_bits, 1 << window_bits
        return (torch.zeros((nwin, 4, 26, len(missing) * nent), dtype=torch.int32),
                np.ones(len(missing), dtype=bool))

    monkeypatch.setattr(cache, "_build_pages", pages)
    keys = [hashlib.sha256(b"m%d" % i).digest() for i in range(4)]
    cache.lookup_or_build(keys[:2])
    cache.lookup_or_build(keys[2:])
    cm = metrics[0]
    assert cm.key_pool_builds.labels().get() == 4 == cache.stats["keys_built"]
    assert cm.key_pool_evictions.labels().get() == cache.stats["keys_evicted"] > 0
    pool = cache._pools[8]
    assert cm.key_pool_keys.labels(window_bits="8").get() == len(pool.slots)
    assert cm.key_pool_capacity.labels(window_bits="8").get() == pool.cap
    cache.clear()
    assert cm.key_pool_keys.labels(window_bits="8").get() == 0


def test_flight_recorder_ring():
    from cometbft_tpu_torch.utils.flight import FlightRecorder

    fr = FlightRecorder(depth=2)
    for i in range(3):
        fr.record("k", i=i)
    assert [e["i"] for e in fr.events()] == [1, 2]
    assert fr.export()["dropped"] == 1 and "k i=2" in fr.format_tail()
    with pytest.raises(ValueError):
        FlightRecorder(depth=0)
