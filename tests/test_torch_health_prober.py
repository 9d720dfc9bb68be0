"""The port's health plane (cometbft_tpu_torch/crypto/health.py: the
canary prober, the overlap accounting, the perf ledger and its seeding
of the cost model, the debug payloads) against the reference's
(cometbft_tpu/crypto/health.py and dispatch.py), which import no jax.

One probe script goes through both ``HealthProber`` + ``DispatchLadder``
pairs, round by round: the same ladder snapshots and transitions.  One
ledger file in ``tmp_path`` gives both packages the same measured
throughput, the same seeded cost tables, the same routes and the same
order contradictions.  Tolerance: exact.  Where the port departs on
purpose -- a canary's untyped exception is a fault of the port, not
evidence about a tier -- the test says so.  Every wait is bounded and
every prober stopped in a finally."""

import json
import threading
import time

import pytest

from cometbft_tpu.crypto import dispatch as jdispatch
from cometbft_tpu.crypto import health as jhealth
from cometbft_tpu_torch import metrics as M
from cometbft_tpu_torch.crypto import batch as B
from cometbft_tpu_torch.crypto import dispatch as D
from cometbft_tpu_torch.crypto import health as H
from cometbft_tpu_torch.utils import metrics as um
from cometbft_tpu_torch.utils import service as S

WAIT = 10.0


class Clock:
    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


@pytest.fixture(autouse=True)
def clean():
    D.reset_for_tests()
    jdispatch.reset_for_tests()
    yield
    D.reset_for_tests()
    jdispatch.reset_for_tests()
    M.install_health_metrics(None)


@pytest.fixture
def hm():
    metrics = M.HealthMetrics(um.Registry())
    M.install_health_metrics(metrics)
    return metrics


def _norm_ladder(snap: dict) -> dict:
    snap = dict(snap)
    snap["order"] = [t for t in snap["order"] if t in D.TIER_ORDER]
    snap["tiers"] = {t: v for t, v in snap["tiers"].items() if t in D.TIER_ORDER}
    snap["transitions"] = [{k: v for k, v in e.items() if k != "at"}
                           for e in snap["transitions"]]
    return snap


def _norm_prober(snap: dict) -> dict:
    return {t: {k: v for k, v in st.items() if k not in ("last_probe_s", "last_probe_at")}
            for t, st in snap["tiers"].items()}


def _pair(clock):
    D.LADDER.reset(cooldown_s=1.0, clock=clock)
    jdispatch.LADDER.reset()
    jdispatch.LADDER._clock = clock
    jdispatch.LADDER.cooldown_s = 1.0


#: per round: tier -> canary outcome (True, False, or a typed fault),
#: then the clock's step after the round
SCRIPT = [
    ({"keyed": False, "generic": True, "host": True}, 0.1),
    ({"keyed": False, "generic": True, "host": True}, 0.1),
    ({"keyed": False, "generic": True, "host": True}, 0.1),     # keyed demoted
    ({"keyed": True, "generic": "fault", "host": True}, 0.5),
    ({"keyed": True, "generic": "fault", "host": True}, 0.6),   # keyed: cool-down not over
    ({"keyed": True, "generic": "fault", "host": True}, 0.1),   # keyed promoted; generic demoted
    ({"keyed": True, "generic": False, "host": False}, 2.0),
    ({"keyed": True, "generic": False, "host": True}, 0.1),     # generic: the trial spent
    ({"keyed": True, "generic": True, "host": True}, 3.0),
    ({"keyed": True, "generic": True, "host": True}, 0.1),      # generic promoted
]


def _prober(mod, fault_cls, outcome):
    def canary(tier):
        def run():
            v = outcome[tier]
            if v == "fault":
                raise fault_cls(tier, "canary")
            return v
        return run
    return mod.HealthProber(interval_s=60, tiers={t: canary(t) for t in ("keyed", "generic",
                                                                          "host")})


def test_probe_script_matches_reference(hm):
    clock = Clock()
    _pair(clock)
    p_out, r_out = {}, {}
    port = _prober(H, D.TierFault, p_out)
    ref = _prober(jhealth, jdispatch.TierFault, r_out)
    for i, (outcome, step) in enumerate(SCRIPT):
        p_out.update(outcome)
        r_out.update(outcome)
        got = port.probe_once()
        assert got == ref.probe_once(), f"round {i}"
        assert got == {t: v is True for t, v in outcome.items()}
        assert _norm_ladder(D.LADDER.snapshot()) == _norm_ladder(
            jdispatch.LADDER.snapshot()), f"round {i}"
        assert _norm_prober(port.snapshot()) == _norm_prober(ref.snapshot()), f"round {i}"
        clock.t += step
    trail = [(e["kind"], e["from"], e["reason"]) for e in D.LADDER.snapshot()["transitions"]]
    assert trail == [("demote", "keyed", "probe_failures"), ("promote", "keyed", "probes"),
                     ("demote", "generic", "probe_failures"),
                     ("demote", "generic", "probe_failures"),
                     ("promote", "generic", "probes")]
    assert hm.tier_probe_failures_total.labels(tier="keyed").get() == 3
    assert hm.tier_healthy.labels(tier="generic").get() == 1.0
    assert port.snapshot()["probes_total"] == 3 * len(SCRIPT)


def test_untyped_canary_error_is_a_port_fault():
    """The reference counts any exception as a failed canary; the port
    records an untyped one, tells the ladder nothing and re-raises it
    once the round is done."""
    def broken():
        raise RuntimeError("kernel failed to build")

    port = H.HealthProber(interval_s=60, tiers={"keyed": broken, "host": lambda: True})
    for _ in range(3):
        with pytest.raises(RuntimeError, match="failed to build"):
            port.probe_once()
    keyed = D.LADDER.snapshot()["tiers"]["keyed"]
    assert not keyed["demoted"]
    snap = port.snapshot()
    assert snap["tiers"]["keyed"]["healthy"] is False and snap["tiers"]["host"]["healthy"]
    assert "failed to build" in snap["last_error"]
    ref = jhealth.HealthProber(interval_s=60, tiers={"keyed": broken})
    for _ in range(3):
        ref.probe_once()
    assert jdispatch.LADDER.snapshot()["tiers"]["keyed"]["demoted"]


def test_hung_canary_times_out_and_fails_fast():
    release = threading.Event()
    port = H.HealthProber(interval_s=60, tiers={"keyed": lambda: release.wait(WAIT)},
                          probe_timeout_s=0.1)
    try:
        assert port.probe_once() == {"keyed": False}
        assert "timeout" in port.snapshot()["tiers"]["keyed"]["error"]
        t0 = time.perf_counter()
        assert port.probe_once() == {"keyed": False}
        assert time.perf_counter() - t0 < 0.1
        assert port.snapshot()["hung_probes"] == ["keyed"]
    finally:
        release.set()
        worker = port._inflight.get("keyed")
        if worker is not None:
            worker.join(WAIT)
    assert D.LADDER.snapshot()["tiers"]["keyed"]["fail_streak"] == 2


def test_chaos_faults_the_canary_of_its_tiers_only():
    D.CHAOS.load(D.ChaosPlan.parse("device_loss@0-3600"), tiers=("keyed",))
    port = H.HealthProber(interval_s=60, tiers={"keyed": lambda: True,
                                                "generic": lambda: True})
    assert port.probe_once() == {"keyed": False, "generic": True}
    assert "ChaosFault" in port.snapshot()["tiers"]["keyed"]["error"]
    # on the probe seam a launch hang does not sleep: the timeout plays it
    D.CHAOS.load(D.ChaosPlan.parse("launch_hang@0-3600"), tiers=("keyed",))
    t0 = time.perf_counter()
    assert port.probe_once()["keyed"] is False
    assert time.perf_counter() - t0 < H.WATCHDOG.budget_s


def test_prober_lifecycle_and_payload(hm):
    prober = H.HealthProber(interval_s=0.02, tiers={"host": lambda: True})
    with pytest.raises(S.NotStartedError):
        prober.stop()
    prober.start()
    try:
        with pytest.raises(S.AlreadyStartedError):
            prober.start()
        deadline = time.monotonic() + WAIT
        while prober.snapshot()["probes_total"] < 2 and time.monotonic() < deadline:
            time.sleep(0.005)
        payload = H.debug_perf_payload()
        assert payload["prober"]["probes_total"] >= 2
        assert payload["device"] == B.device_status()
        assert set(payload) == set(jhealth.debug_perf_payload().keys())
    finally:
        prober.stop()
    assert H._ACTIVE_PROBER is None and not prober.is_running()
    assert not any(t.name == "health-prober" for t in threading.enumerate())
    with pytest.raises(S.AlreadyStartedError):   # the reference's order of checks
        prober.start()
    with pytest.raises(ValueError):
        H.HealthProber(interval_s=0)
    assert H.debug_perf_payload()["prober"] == {"running": False, "tiers": {}}
    assert hm.tier_probe_seconds.labels(tier="host")._count >= 2


def test_default_probes_without_cuda_are_host_only():
    """The device canaries appear only once CUDA is initialised in the
    process; the host canary verifies the two canary signatures."""
    assert set(H.default_tier_probes()) == {"host"}
    assert H._probe_host() is True
    assert [(p.bytes(), m, s) for p, m, s in H._canary_fixture()] == [
        (p.bytes(), m, s) for p, m, s in jhealth._canary_fixture()]


def test_overlap_from_the_fetch_wait(hm):
    usage = H.DeviceUsage()
    t0 = time.perf_counter()
    with usage.timed_fetch():
        time.sleep(0.02)
    assert usage.fetch_wait() >= 0.02
    other = []
    t = threading.Thread(target=lambda: other.append(usage.fetch_wait()))
    t.start()
    t.join(WAIT)
    assert other == [0.0]                                 # per thread
    time.sleep(0.02)
    usage.launch_end(t0, fetch_wait=usage.fetch_wait())
    snap = usage.snapshot()
    assert 0.0 < snap["overlap_ratio"] < 0.8
    assert snap["last_fetch_wait_s"] == usage.fetch_wait()
    assert hm.host_device_overlap_ratio.labels().get() == snap["overlap_ratio"]
    usage.note_queue_wait(0.003)
    assert usage.snapshot()["last_queue_wait_s"] == 0.003


LEDGER = [
    {"config": "micro_64sig", "dispatch_tier": "host", "value": 30000.0, "unit": "sigs/sec"},
    {"config": "verify_commit_150_device", "dispatch_tier": "keyed", "unit": "ms",
     "value": 1.0, "sigs_per_sec": 150000.0},
    {"config": "verify_commit_8", "dispatch_tier": "keyed", "unit": "ms", "value": 0.1,
     "sigs_per_sec": 80000.0},
    {"config": "stream150", "dispatch_tier": "keyed", "value": 400000.0, "unit": "sigs/sec",
     "batch": 150, "route_seed": False},
    {"config": "keyed_1024", "dispatch_tier": "keyed", "value": 300000.0,
     "unit": "sigs/sec", "batch": 1024, "route_seed": True, "platform": "gpu"},
    {"config": "generic_150", "dispatch_tier": "generic", "value": 120000.0,
     "unit": "sigs/sec", "batch": 150, "route_seed": True},
    {"config": "down", "dispatch_tier": "generic", "value": 0, "unit": "sigs/sec",
     "batch": 256, "route_seed": True},
    {"config": "no_batch", "dispatch_tier": "python", "value": 300.0, "unit": "sigs/sec"},
    {"config": "micro_8sig", "dispatch_tier": "host", "value": 500000.0, "unit": "sigs/sec"},
    {"config": "untagged", "value": 1.0},
]


@pytest.fixture
def ledger(tmp_path, monkeypatch):
    path = tmp_path / "perf_ledger.json"
    path.write_text(json.dumps({"entries": LEDGER}))
    monkeypatch.setattr(H, "PERF_LEDGER", str(path))
    monkeypatch.setenv("CMT_TPU_PERF_LEDGER", str(path))
    monkeypatch.setenv("CMT_TPU_ROUTE", "1")   # tests/conftest.py turns it off
    D.reset_for_tests(ledger=True)
    jdispatch.reset_for_tests()
    return path


def _norm_cost(snap: dict) -> dict:
    snap = dict(snap)
    snap["table"] = [{k: v for k, v in row.items() if k != "family"} for row in snap["table"]]
    snap["orders"] = [{k: v for k, v in row.items() if k not in ("family", "last_reorder_age_s")}
                      for row in snap["orders"]]
    return snap


def test_measured_throughput_and_seed_match_reference(ledger):
    measured = H.measured_tier_throughput()
    assert measured == jhealth.measured_tier_throughput()
    assert H.perf_ledger_tail(2) == jhealth.perf_ledger_tail(2)
    assert sorted(measured["keyed"]["buckets"]) == [8, 256, 1024]
    port = D.TierCostModel(min_samples=3)
    ref = jdispatch.TierCostModel(enabled=True, min_samples=3, margin=0.2, cooldown_s=30.0)
    assert port.seed_locked(measured) == ref.seed_locked(jhealth.measured_tier_throughput()) == 6
    assert _norm_cost(port.snapshot_locked(0.0)) == _norm_cost(ref.snapshot_locked(0.0))
    # online evidence is never overwritten by a seed
    port.observe_locked("generic", 150, 0.001)
    assert port.seed_locked(measured) == 5


def test_route_seeds_once_and_matches_reference(ledger):
    for batch, admissible in ((8, ["keyed"]), (150, ["keyed", "generic"]),
                              (1000, ["keyed", "generic"]), (60, ["generic"])):
        got = D.LADDER.route(admissible, batch)
        assert got == jdispatch.LADDER.route(admissible, batch), batch
    assert D.LADDER.route(["keyed"], 8) == ["host", "keyed"]       # the seeded order
    assert _norm_cost(D.LADDER.cost_snapshot()) == _norm_cost(jdispatch.LADDER.cost_snapshot())
    assert D.LADDER.cost_snapshot()["seeded"] is True
    payload = D.debug_dispatch_payload()
    want = jdispatch.debug_dispatch_payload()
    assert payload["order_contradictions"] == want["order_contradictions"]
    assert [(c["preferred"], c["faster"], c["bucket"], c["resolved_by_router"])
            for c in payload["order_contradictions"]] == [
        ("keyed", "host", 8, True), ("generic", "host", 8, True)]
    assert payload["measured_tier_throughput"] == want["measured_tier_throughput"]
    for pair in (("host", "keyed", 8), ("generic", "keyed", 256), ("host", "python", 8),
                 ("host", "keyed", None)):
        assert D.LADDER.router_prefers(*pair) == jdispatch.LADDER.router_prefers(*pair), pair


def test_ledger_append_and_missing(tmp_path, monkeypatch):
    monkeypatch.setattr(H, "PERF_LEDGER", str(tmp_path / "sub" / "ledger.json"))
    assert H.perf_ledger_tail() == [] and H.measured_tier_throughput() == {}
    H.append_perf_ledger([{"config": "a", "dispatch_tier": "keyed", "batch": 150,
                           "sigs_per_sec": 1e5, "route_seed": True}])
    H.append_perf_ledger([{"config": "b"}])
    assert [e["config"] for e in H.perf_ledger_tail(0)] == ["a", "b"]
    assert H.measured_tier_throughput()["keyed"]["buckets"][256]["sigs_per_sec"] == 1e5
    (tmp_path / "sub" / "ledger.json").write_text("not json")
    assert H.perf_ledger_tail() == []


def test_supports_batch_verifier_and_device_status():
    from cometbft_tpu.crypto import batch as jbatch
    from cometbft_tpu.crypto import ed25519 as jed
    from cometbft_tpu_torch.crypto import ed25519 as ed

    pk = ed.priv_key_from_secret(b"status").pub_key()
    assert B.supports_batch_verifier(pk) is jbatch.supports_batch_verifier(
        jed.Ed25519PubKey(pk.bytes())) is True
    assert B.supports_batch_verifier(None) is False
    assert set(B.device_status()) == {"status", "ndev"}
