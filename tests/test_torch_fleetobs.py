"""utils/fleetobs: the port's fleet aggregator against the reference's on
one set of scrapes — the exposition parser, clock corrections, the merged
timeline, height stitching, latencies and the rollup — and
``scrape_node`` against a local ``http.server``."""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from cometbft_tpu.utils import fleetobs as ref_fo
from cometbft_tpu_torch.utils import fleetobs as port_fo

NODES = 4


def _ids():
    return [f"{k + 1:02x}" * 20 for k in range(NODES)]


def _exposition(k: int, rs) -> str:
    """Node k's /metrics text: its peers' clock offsets, its height,
    its tier, queue depths, hop histogram, peers, netem series."""
    ids = _ids()
    lines = ["# HELP cometbft_p2p_peer_clock_offset_seconds x",
             "# TYPE cometbft_p2p_peer_clock_offset_seconds gauge"]
    for j in range(NODES):
        if j != k:
            lines.append(f'cometbft_p2p_peer_clock_offset_seconds{{peer_id="{ids[j]}"}} '
                         f"{0.004 * (j - k) + float(rs.uniform(-1e-4, 1e-4))!r}")
    lines += [
        f"cometbft_consensus_latest_block_height {40 + k * (k % 2)}",
        f'cometbft_crypto_dispatch_current_tier{{tier="keyed"}} {1 if k != 2 else 0}',
        f'cometbft_crypto_dispatch_current_tier{{tier="host"}} {0 if k != 2 else 1}',
        f'cometbft_crypto_verify_queue_depth{{priority="consensus"}} {k}',
        f'cometbft_crypto_verify_queue_depth{{priority="prefetch"}} {2 * k}',
        f"cometbft_p2p_gossip_hop_seconds_count {10 * k}",
        f"cometbft_p2p_gossip_hop_seconds_sum {0.013 * k}",
        f"cometbft_p2p_peers {NODES - 1}",
        f'cometbft_netem_injected_delay_seconds_sum{{peer_id="{ids[(k + 1) % NODES]}"}} '
        f"{float(rs.uniform(0.1, 2.0))!r}",
        'cometbft_weird_label{a="q\\"uote",b="back\\\\slash"} 3',
        "not a series line !",
        "cometbft_bad_value{x=\"1\"} abc",
    ]
    return "\n".join(lines) + "\n"


def _trace(k: int, rs, epoch: float) -> dict:
    ids = _ids()
    ev = [{"name": "thread_name", "ph": "M", "pid": 1, "tid": 3, "args": {"name": "cs"}}]
    t = 1e3
    for h in range(1, 8):
        wall = float(rs.uniform(1e5, 4e5))
        origin = ids[h % NODES][:16]
        send_wall = epoch + t / 1e6 + 0.001 * (h % NODES)
        ev.append({"name": "height/proposal_received", "ph": "X", "ts": t + 100, "dur": 0,
                   "pid": 1, "tid": 3, "args": {"height": h, "send_wall": send_wall,
                                                 "origin": origin}})
        if h != 5 or k:
            ev.append({"name": "p2p/recv_hop", "ph": "X", "ts": t + 80, "dur": 15, "pid": 1,
                       "tid": 4, "args": {"height": h, "send_wall": send_wall,
                                          "origin": ids[(h + k) % NODES][:16]}})
        if h != 6:
            ev.append({"name": "height/quorum_precommit", "ph": "X", "ts": t + wall / 2,
                       "dur": 0, "pid": 1, "tid": 3, "args": {"height": h}})
        if not (h == 7 and k == 1):
            ev.append({"name": "height/pipeline", "ph": "X", "ts": t, "dur": wall, "pid": 1,
                       "tid": 3, "args": {"height": h, "round": 0}})
        ev.append({"name": "p2p/netem_hold", "ph": "X", "ts": t + 20, "dur": 50e3, "pid": 1,
                   "tid": 5, "args": {"peer": ids[0], "bytes": 100, "lost": 0}})
        t += wall + 500
    return {"traceEvents": ev, "displayTimeUnit": "ms",
            "otherData": {"wall_epoch": epoch, "dropped_spans": 0}}


def _raw(seed: int):
    rs = np.random.RandomState(seed)
    out = []
    for k in range(NODES):
        epoch = 1.76e9 + 0.004 * k
        out.append((f"node{k}", _exposition(k, rs), _trace(k, rs, epoch),
                    [{"t": epoch + 0.5 + j, "kind": "commit", "height": j} for j in range(3)]))
    return out


def _scrapes(fo, seed: int):
    return [fo.NodeScrape(name=n, target=None, metrics=fo.parse_prom_text(text), trace=tr,
                          flight=fl) for n, text, tr, fl in _raw(seed)]


@pytest.mark.parametrize("seed", [1, 2])
def test_parse_corrections_stitching_and_rollup_are_the_references(seed):
    ref_s, port_s = _scrapes(ref_fo, seed), _scrapes(port_fo, seed)
    for r, p in zip(ref_s, port_s):
        assert p.metrics == r.metrics and len(p.metrics) == NODES - 1 + 10
        assert port_fo.series(p, "crypto_verify_queue_depth", {"priority": "consensus"}) == \
            ref_fo.series(r, "crypto_verify_queue_depth", {"priority": "consensus"})
        assert port_fo.series_value(p, "p2p_peers") == ref_fo.series_value(r, "p2p_peers")
        assert port_fo.series_value(p, "nope") is None
    assert port_fo.node_identities(port_s) == ref_fo.node_identities(ref_s)
    corr = port_fo.clock_corrections(port_s)
    assert corr == ref_fo.clock_corrections(ref_s) and set(corr) == {f"node{k}" for k in
                                                                      range(NODES)}
    assert port_fo.merge_traces(port_s) == ref_fo.merge_traces(ref_s)
    st_p, st_r = port_fo.stitch_heights(port_s), ref_fo.stitch_heights(ref_s)
    assert st_p == st_r and len(st_p) == 7
    for m in (1, 2, 4):
        assert port_fo.complete_heights(st_p, m) == ref_fo.complete_heights(st_r, m)
    lat = port_fo.height_latencies_ms(st_p)
    assert lat == ref_fo.height_latencies_ms(st_r)
    assert port_fo.percentile(list(lat.values()), 95) == ref_fo.percentile(list(lat.values()), 95)
    assert port_fo.percentile([], 95) == 0.0
    assert port_fo.fleet_rollup(port_s) == ref_fo.fleet_rollup(ref_s)
    assert port_fo.fleet_payload(port_s, include_trace=True) == \
        ref_fo.fleet_payload(ref_s, include_trace=True)
    assert port_fo.fleet_payload(port_s, scenario="wan")["scenario"] == "wan"


def test_rollup_sets_the_fleet_metrics():
    from cometbft_tpu_torch.metrics import FleetMetrics, install_fleet_metrics
    from cometbft_tpu_torch.utils.metrics import Registry

    reg = Registry()
    install_fleet_metrics(FleetMetrics(reg))
    try:
        s = _scrapes(port_fo, 3)
        roll = port_fo.fleet_rollup(s)
        assert roll["height_skew"] == 3 and roll["max_height"] == 43
        text = reg.expose()
        assert "cometbft_fleet_nodes 4" in text and "cometbft_fleet_height_skew 3" in text
        assert 'cometbft_fleet_height_lag{node="node0"} 3' in text
        port_fo.fleet_rollup(s[1:])                 # node0 left: its child retires
        assert 'cometbft_fleet_height_lag{node="node0"}' not in reg.expose()
    finally:
        install_fleet_metrics(None)


def test_self_scrape_and_targets():
    from cometbft_tpu_torch.utils.metrics import Registry

    reg = Registry()
    reg.gauge("consensus", "latest_block_height", "h").set(17)
    s = port_fo.self_scrape("me", reg)
    assert port_fo.series_value(s, "consensus_latest_block_height") == 17.0
    assert "traceEvents" in s.trace and isinstance(s.flight, list)
    assert port_fo.fleet_peer_targets(" a:1, ,b:2 ") == ["a:1", "b:2"] == \
        ref_fo.fleet_peer_targets(" a:1, ,b:2 ")
    assert port_fo.fleet_peer_targets(None) == [] == port_fo.fleet_peer_targets("")
    with pytest.raises(ValueError):
        port_fo.scrape_fleet(["x:1"], pool=0)


class _Node(BaseHTTPRequestHandler):
    body: dict = {}

    def do_GET(self):
        data = self.body.get(self.path)
        if data is None:
            self.send_error(404)
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *a):
        pass


def test_scrape_node_over_http():
    from cometbft_tpu_torch.metrics import FleetMetrics, install_fleet_metrics
    from cometbft_tpu_torch.utils.metrics import Registry

    name, text, trace, flight = _raw(7)[0]

    class Handler(_Node):
        body = {"/metrics": text.encode(), "/trace": json.dumps(trace).encode(),
                "/debug/flight": json.dumps({"events": flight}).encode()}

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    reg = Registry()
    install_fleet_metrics(FleetMetrics(reg))
    try:
        target = f"127.0.0.1:{srv.server_address[1]}"
        s = port_fo.scrape_node(target, name="live", timeout=2.0)
        assert s.error is None and s.target == f"http://{target}"
        assert s.metrics == ref_fo.parse_prom_text(text) and s.trace == trace
        assert s.flight == flight and s.wall_epoch == trace["otherData"]["wall_epoch"]
        srv.shutdown()
        srv.server_close()
        got = port_fo.scrape_fleet([target], names=["gone"], timeout=0.5, include_self=True,
                                   self_registry=reg, pool=2)
        assert [g.name for g in got] == ["self", "gone"] and got[1].error
        assert threading.active_count() < 50
        exp = reg.expose()
        assert 'cometbft_fleet_scrapes{node="live",result="ok"} 1' in exp
        assert 'cometbft_fleet_scrapes{node="gone",result="error"} 1' in exp
    finally:
        install_fleet_metrics(None)
        srv.server_close()
        th.join(5)
