"""utils/critpath: the port's critical-path decomposition against the
reference's on one seeded event list — local and stitched
decompositions, stage budgets and the live hook's metrics."""

import numpy as np
import pytest

from cometbft_tpu.utils import critpath as ref_cp
from cometbft_tpu.utils import fleetobs as ref_fo
from cometbft_tpu_torch.utils import critpath as port_cp
from cometbft_tpu_torch.utils import fleetobs as port_fo

ORIGIN = "ab" * 20


def height_events(rs, height: int, t0_us: float, epoch: float, drop=()):
    """One committed height's spans on a tracer's axis (µs), in the shape
    consensus records them; ``drop`` leaves span names out."""
    ev = []

    def add(name, ts, dur, **args):
        if name not in drop:
            ev.append({"name": name, "ph": "X", "ts": round(ts, 3), "dur": round(dur, 3),
                       "pid": 1, "tid": 7, "cat": "height", "args": args})

    wall = float(rs.uniform(2e5, 9e5))
    prop = t0_us + float(rs.uniform(0.05, 0.3)) * wall
    send_wall = epoch + (prop - float(rs.uniform(2e3, 4e4))) / 1e6
    qpc = prop + float(rs.uniform(0.2, 0.5)) * wall
    add("height/proposal_received", prop, 0.0, height=height, send_wall=send_wall,
        origin=ORIGIN[:16])
    add("height/proposal_origin_wall", prop, 0.0, height=height,
        origin_send_wall=send_wall, origin=ORIGIN[:16])
    add("p2p/recv_hop", prop - 50, 40, height=height, send_wall=send_wall,
        origin=ORIGIN[:16])
    add("height/quorum_prevote", (prop + qpc) / 2, 0.0, height=height)
    add("height/quorum_precommit", qpc, 0.0, height=height)
    for k in range(int(rs.randint(1, 4))):
        s = prop + float(rs.uniform(0, qpc - prop))
        add("verify_queue/prepare", s, float(rs.uniform(1e3, 3e4)))
        add("verify_queue/launch", s + 500, float(rs.uniform(1e3, 5e4)))
    c = qpc + 1e3
    for name in ("exec/apply_block", "store/save_block", "wal/write_end_height"):
        d = float(rs.uniform(1e3, 3e4))
        add(name, c, d, height=height)
        c += d
    add("indexer/index_block", c, float(rs.uniform(1e3, 5e5)), height=height)
    add("height/pipeline", t0_us, wall, height=height, round=0)
    return ev, t0_us + wall


def event_list(seed: int, heights: int = 12, drop_at=None):
    rs = np.random.RandomState(seed)
    epoch = 1.76e9 + seed
    events, t = [], 1e4
    for h in range(1, heights + 1):
        drop = ()
        if drop_at and h in drop_at:
            drop = drop_at[h]
        ev, t = height_events(rs, h, t, epoch, drop)
        events += ev
        t += float(rs.uniform(1e3, 2e5))
    return events, epoch


DROPS = {3: ("height/proposal_origin_wall", "p2p/recv_hop", "height/proposal_received"),
         5: ("height/quorum_precommit",), 7: ("exec/apply_block", "indexer/index_block"),
         9: ("verify_queue/prepare",)}


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_local_decompositions_are_the_references(seed):
    events, epoch = event_list(seed, drop_at=DROPS)
    assert port_cp.committed_heights(events) == ref_cp.committed_heights(events) == \
        list(range(1, 13))
    for h in range(0, 14):
        for wall_epoch in (epoch, None):
            ref = ref_cp.decompose_local(events, h, wall_epoch=wall_epoch)
            port = port_cp.decompose_local(events, h, wall_epoch=wall_epoch)
            assert port == ref
            if ref is not None:
                assert abs(sum(ref["stages"].values()) - ref["wall_s"]) <= 1e-5
                assert port_cp.dominant_stage(port["stages"]) == \
                    ref_cp.dominant_stage(ref["stages"])
    assert port_cp.STAGES == ref_cp.STAGES


def _scrapes(fo, seed: int):
    out = []
    for k in range(3):
        events, epoch = event_list(seed * 10 + k, heights=6)
        out.append(fo.NodeScrape(
            name=f"n{k}", target=None,
            metrics=[("cometbft_p2p_peer_clock_offset_seconds",
                      {"peer_id": f"{j:02x}" * 20}, 0.001 * (j - k))
                     for j in range(3) if j != k],
            trace={"traceEvents": events, "otherData": {"wall_epoch": epoch - 0.01 * k}}))
    return out


@pytest.mark.parametrize("seed", [4, 5])
def test_stitched_budgets_are_the_references(seed):
    ref_s, port_s = _scrapes(ref_fo, seed), _scrapes(port_fo, seed)
    ref_b, port_b = ref_cp.stage_budgets(ref_s), port_cp.stage_budgets(port_s)
    assert port_b == ref_b and len(ref_b) == 6
    for h, d in ref_b.items():
        assert abs(sum(d["stages"].values()) - d["wall_s"]) <= 1e-5
        assert port_cp.decompose_stitched(port_s, h) == ref_cp.decompose_stitched(ref_s, h)
    for p in (50.0, 95.0, 100.0):
        assert port_cp.budget_at_percentile(port_b, p) == ref_cp.budget_at_percentile(ref_b, p)
    assert port_cp.budget_at_percentile({}, 95) is None


def test_observe_height_feeds_the_attribution_metrics():
    from cometbft_tpu_torch.metrics import AttributionMetrics
    from cometbft_tpu_torch.utils.metrics import Registry
    from cometbft_tpu_torch.utils.trace import SpanTracer

    events, epoch = event_list(6, heights=3)

    class Ring:
        epoch_wall = epoch

        def events(self):
            return events

    reg = Registry()
    metrics = AttributionMetrics(reg)
    d = port_cp.observe_height(2, tracer=Ring(), metrics=metrics)
    assert d == dict(ref_cp.decompose_local(events, 2, wall_epoch=epoch),
                     critical_stage=ref_cp.dominant_stage(d["stages"]))
    text = reg.expose()
    for stage in port_cp.STAGES:
        one = 1.0 if stage == d["critical_stage"] else 0.0
        assert f'cometbft_attribution_height_critical_stage{{stage="{stage}"}} {one:g}' in text \
            or f'cometbft_attribution_height_critical_stage{{stage="{stage}"}} {one}' in text
        assert f'cometbft_attribution_height_stage_seconds_count{{stage="{stage}"}} 1' in text
    assert port_cp.observe_height(99, tracer=Ring(), metrics=metrics) is None
    # best-effort by contract: a broken ring never fails the commit
    assert port_cp.observe_height(1, tracer=object()) is None
    assert port_cp.observe_height(1, tracer=SpanTracer(capacity=8)) is None


def test_each_committed_height_is_decomposed_at_commit():
    """ConsensusState._finalize_commit calls observe_height outside
    replay: a node with three stub validators (chip_smoke's (b) pattern)
    for three heights, on the CPU."""
    import os
    import sys

    import torch

    from cometbft_tpu_torch import metrics as M
    from cometbft_tpu_torch.config import test_config
    from cometbft_tpu_torch.crypto.batch import create_batch_verifier
    from cometbft_tpu_torch.utils.metrics import Registry

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    reg = Registry()
    saved = M.attribution_metrics()
    M.install_attribution_metrics(M.AttributionMetrics(reg))
    try:
        r = chip_smoke.cs_stub_run(
            torch.device("cpu"), "critpath", reg, 3, 3, False, config=test_config(),
            verifier_factory=lambda pk: create_batch_verifier(pk, device="cpu"))
        got = chip_smoke.check_critpath("critpath", r["attribution"], 3, reg)
    finally:
        M.install_attribution_metrics(saved)
    assert [h for h, _, _ in got["per_height"]] == [1, 2, 3]
    assert got["dominant"] in port_cp.STAGES
    assert 'cometbft_attribution_height_stage_seconds_count{stage="residual"} 3' in reg.expose()
