"""Fleet observability aggregator (a copy of cometbft_tpu/utils/fleetobs.py)
— N nodes' rings on ONE timeline.

Four per-process observability planes exist (metrics, span tracer,
flight recorder, device health), but a localnet is a SYSTEM: a
height's wall-clock starts when the proposer stamps the proposal, not
when each replica's `_height_t0` sees it arrive.  This module scrapes
N nodes' ``/metrics``, ``/trace`` and ``/debug/flight`` surfaces,
aligns them on wall clock (each trace ring exports its
``wall_epoch`` anchor; flight events are wall-stamped by contract),
and produces:

- one merged Chrome trace-event file (pid = node) a human loads in
  Perfetto to SEE proposal → gossip hop → quorum → commit across the
  fleet;
- stitched per-height trees keyed by (height, round, origin) — the
  ``p2p/recv_hop`` spans recorded by trace-context-stamped gossip are
  the joints;
- cross-node proposal→commit height latencies (the
  ``height_latency_p95_4node`` SLO the perf ledger gates);
- a fleet rollup (per-node committed height + lag, one-hot dispatch
  tier, verify-queue depths, hop-latency aggregates) — the skew/lag
  table an operator reads first, served live via ``/debug/fleet``.

Clock alignment: the merged
timeline and stitched latencies are OFFSET-CORRECTED onto the first
scrape's clock using the mesh's own pong-piggyback estimates —
:func:`node_identities` recovers which scrape is which node from the
``p2p_peer_clock_offset_seconds`` gauges (every node names its
peers, so its own id is the one it never names), and
:func:`clock_corrections` reads the reference node's estimate for
each.  The estimates are ms-scale (RTT halved), so trust the
corrected timeline to about a link RTT, not to microseconds; nodes
the gauges can't identify (pre-fleet peers, the first ~10 s before a
stamped pong) fall back to raw wall clock, which on a same-box
localnet is exact anyway.  No third-party deps (stdlib + the
in-repo sync/metrics seams); never imported by a hot path.

Where the port departs from its reference: the reference reads
``CMT_TPU_FLEET_SCRAPE_POOL``, ``CMT_TPU_SCENARIO`` and
``CMT_TPU_FLEET_PEERS``; the port reads no environment variable:
``scrape_fleet(pool=...)``, ``fleet_payload(scenario=...)`` and
``fleet_peer_targets(targets)`` take them as arguments.
"""

from __future__ import annotations

import json
import math
import re
import time
import urllib.request
from dataclasses import dataclass, field

from cometbft_tpu_torch.utils import sync as cmtsync

#: span names the stitcher joins into a height tree
_SPAN_COMMIT = "height/pipeline"
_SPAN_HOP = "p2p/recv_hop"
_SPAN_PROPOSAL = "height/proposal_received"
_SPAN_ORIGIN_WALL = "height/proposal_origin_wall"
_SPAN_QUORUM = ("height/quorum_prevote", "height/quorum_precommit")


@dataclass
class NodeScrape:
    """One node's three surfaces, as scraped (or read in-process)."""

    name: str
    target: str | None = None  # base URL; None = read in-process
    metrics: list = field(default_factory=list)  # (series, labels, value)
    flight: list = field(default_factory=list)   # wall-stamped events
    trace: dict = field(default_factory=dict)    # Chrome export object
    error: str | None = None

    @property
    def wall_epoch(self) -> float | None:
        """The trace ring's wall anchor (None from pre-fleet nodes)."""
        return (self.trace.get("otherData") or {}).get("wall_epoch")

    def span_events(self) -> list[dict]:
        return [
            e
            for e in self.trace.get("traceEvents", ())
            if e.get("ph") == "X"
        ]


# -- prometheus text parsing ---------------------------------------------

_SERIES_RE = re.compile(
    r'^([A-Za-z_:][\w:]*)(\{(.*)\})?\s+(\S+)\s*$'
)
_LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def parse_prom_text(text: str) -> list[tuple[str, dict, float]]:
    """Minimal text-exposition parser for the families the rollup
    reads (counters/gauges + histogram _sum/_count/_bucket lines)."""
    out = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _SERIES_RE.match(line)
        if m is None:
            continue
        name, _, rawlabels, rawvalue = m.groups()
        labels = (
            {
                k: v.replace('\\"', '"').replace("\\\\", "\\")
                for k, v in _LABEL_RE.findall(rawlabels)
            }
            if rawlabels
            else {}
        )
        try:
            value = float(rawvalue)
        except ValueError:
            continue
        out.append((name, labels, value))
    return out


def series(
    scrape: NodeScrape, suffix: str, labels: dict | None = None
) -> list[tuple[dict, float]]:
    """All samples of a series, matched by SUFFIX (``/metrics`` names
    carry the registry namespace prefix; callers speak the
    lint/doc-level ``<subsystem>_<field>`` names) with an optional
    label-subset filter."""
    want = labels or {}
    out = []
    for name, lbl, value in scrape.metrics:
        if name != suffix and not name.endswith("_" + suffix):
            continue
        if all(lbl.get(k) == v for k, v in want.items()):
            out.append((lbl, value))
    return out


def series_value(
    scrape: NodeScrape, suffix: str, labels: dict | None = None
) -> float | None:
    got = series(scrape, suffix, labels)
    return got[0][1] if got else None


# -- scraping -------------------------------------------------------------


def _base_url(target: str) -> str:
    return target if "://" in target else f"http://{target}"


def _get(url: str, timeout: float) -> bytes:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read()


def scrape_node(
    target: str, name: str | None = None, timeout: float = 2.0
) -> NodeScrape:
    """Scrape one node's metrics server (all three surfaces).  Errors
    land in ``NodeScrape.error`` — one dead node must not blank the
    fleet view — and in the ``fleet_scrapes`` counter."""
    from cometbft_tpu_torch.metrics import fleet_metrics

    base = _base_url(target)
    name = name or target
    s = NodeScrape(name=name, target=base)
    t0 = time.perf_counter()
    try:
        s.metrics = parse_prom_text(
            _get(base + "/metrics", timeout).decode("utf-8", "replace")
        )
        s.trace = json.loads(_get(base + "/trace", timeout))
        s.flight = json.loads(_get(base + "/debug/flight", timeout)).get(
            "events", []
        )
        fleet_metrics().scrapes.labels(node=name, result="ok").inc()
    except Exception as exc:  # noqa: BLE001 — a dead peer is a data point
        s.error = repr(exc)
        fleet_metrics().scrapes.labels(node=name, result="error").inc()
    fleet_metrics().scrape_seconds.observe(time.perf_counter() - t0)
    return s


def self_scrape(name: str = "self", registry=None) -> NodeScrape:
    """Read this process's own surfaces directly (no HTTP): the
    ``/debug/fleet`` handler holds the registry/TRACER/FLIGHT handles,
    so a wire round trip through its own server would only add
    latency and a serialization/parse cycle for identical data."""
    from cometbft_tpu_torch.utils.flight import FLIGHT
    from cometbft_tpu_torch.utils.trace import TRACER

    s = NodeScrape(name=name, target=None)
    if registry is not None:
        s.metrics = parse_prom_text(registry.expose())
    s.trace = TRACER.export()
    s.flight = FLIGHT.events()
    return s


def scrape_fleet(
    targets: list[str],
    names: list[str] | None = None,
    timeout: float = 2.0,
    include_self: bool = False,
    self_name: str = "self",
    self_registry=None,
    pool: int = 8,
) -> list[NodeScrape]:
    """Scrape every target CONCURRENTLY (one dead peer's connect
    timeout must cost the fleet view max(timeout), not N x timeout —
    /debug/fleet serves from a request handler).

    Concurrency is BOUNDED by ``pool`` (default 8): one thread per
    target was fine at 4 nodes and is a thread burst at 32.  Workers are named ``fleet-scrape*`` and joined before
    return, so the thread-leak gate can hold this seam to zero."""
    out: list[NodeScrape] = []
    if include_self:
        out.append(self_scrape(self_name, self_registry))
    if not targets:
        return out
    from concurrent.futures import ThreadPoolExecutor

    if pool < 1:
        raise ValueError(f"pool must be >= 1, got {pool}")
    bound = pool

    def one(i_t):
        i, t = i_t
        n = names[i] if names and i < len(names) else None
        return scrape_node(t, name=n, timeout=timeout)

    with ThreadPoolExecutor(
        max_workers=min(bound, len(targets)),
        thread_name_prefix="fleet-scrape",
    ) as pool:
        out.extend(pool.map(one, enumerate(targets)))
    return out


# -- clock alignment ------------------------------------------------------


def node_identities(scrapes: list[NodeScrape]) -> dict[str, str]:
    """full node id -> scrape name, derived from the mesh's own
    offset gauges: every node's ``p2p_peer_clock_offset_seconds``
    names its PEERS, so in a full mesh a node's own id is exactly the
    one id every other node names and it never names itself.  A node
    with no stamped-pong samples yet (first ~10 s, or a pre-fleet
    peer) stays unmapped — its correction falls back to zero."""
    per: dict[str, set[str]] = {}
    for s in scrapes:
        per[s.name] = {
            lbl.get("peer_id", "")
            for lbl, _ in series(s, "p2p_peer_clock_offset_seconds")
        }
    all_ids = set().union(*per.values()) if per else set()
    out: dict[str, str] = {}
    for s in scrapes:
        if not per[s.name]:
            continue  # no peer evidence — can't isolate its own id
        own = all_ids - per[s.name]
        if len(own) == 1:
            out[next(iter(own))] = s.name
    return out


def clock_corrections(scrapes: list[NodeScrape]) -> dict[str, float]:
    """scrape name -> estimated ``that_node_wall - reference_wall``
    (reference = first scrape), i.e. the seconds to SUBTRACT from a
    node's wall stamps to land on the reference clock.  Uses the
    reference node's own pong-piggyback offset gauges, routed through
    :func:`node_identities`; anything underdetermined corrects by 0
    (same-box localnets are already aligned)."""
    if not scrapes:
        return {}
    name_to_id = {v: k for k, v in node_identities(scrapes).items()}
    ref = scrapes[0]
    ref_off = {
        lbl.get("peer_id", ""): v
        for lbl, v in series(ref, "p2p_peer_clock_offset_seconds")
    }
    corr = {ref.name: 0.0}
    for s in scrapes[1:]:
        fid = name_to_id.get(s.name)
        corr.setdefault(
            s.name, float(ref_off.get(fid, 0.0)) if fid else 0.0
        )
    return corr


def _origin_corrections(
    scrapes: list[NodeScrape], corrections: dict[str, float]
) -> dict[str, float]:
    """origin id PREFIX (as hop/proposal spans carry, ``id[:16]``) ->
    the origin node's clock correction."""
    out = {}
    for fid, name in node_identities(scrapes).items():
        out[fid[:16]] = corrections.get(name, 0.0)
    return out


# -- merged timeline ------------------------------------------------------


def _fleet_t0(
    scrapes: list[NodeScrape], corrections: dict[str, float]
) -> float:
    anchors = [
        s.wall_epoch - corrections.get(s.name, 0.0)
        for s in scrapes
        if s.wall_epoch
    ]
    anchors += [
        ev["t"] - corrections.get(s.name, 0.0)
        for s in scrapes
        for ev in s.flight
        if "t" in ev
    ]
    return min(anchors) if anchors else 0.0


def merge_traces(
    scrapes: list[NodeScrape],
    corrections: dict[str, float] | None = None,
) -> dict:
    """One Chrome trace across the fleet: pid = node index (named via
    process_name metadata), every span/flight event re-timed onto the
    OFFSET-CORRECTED shared wall axis (reference = first scrape,
    corrections from the mesh's own pong-piggyback offset gauges;
    earliest corrected anchor = 0)."""
    if corrections is None:
        corrections = clock_corrections(scrapes)
    t0 = _fleet_t0(scrapes, corrections)
    events: list[dict] = []
    for pid, s in enumerate(scrapes):
        events.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "args": {"name": s.name},
            }
        )
        corr = corrections.get(s.name, 0.0)
        epoch = s.wall_epoch
        if epoch is not None:
            shift_us = (epoch - corr - t0) * 1e6
            for e in s.span_events():
                e2 = dict(e, pid=pid)
                e2["ts"] = round(e.get("ts", 0.0) + shift_us, 1)
                events.append(e2)
            # keep per-thread track names readable under the node pid
            for e in s.trace.get("traceEvents", ()):
                if e.get("ph") == "M" and e.get("name") == "thread_name":
                    events.append(dict(e, pid=pid))
        for ev in s.flight:
            if "t" not in ev:
                continue
            events.append(
                {
                    "name": ev.get("kind", "event"),
                    "ph": "i",
                    "s": "p",
                    "pid": pid,
                    "tid": 0,
                    "ts": round((ev["t"] - corr - t0) * 1e6, 1),
                    "cat": "flight",
                    "args": {
                        k: v for k, v in ev.items() if k not in ("t",)
                    },
                }
            )
    events.sort(key=lambda e: (e.get("ts", 0.0), e.get("pid", 0)))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "wall_epoch": t0,
            "nodes": [s.name for s in scrapes],
            "clock_corrections": corrections,
            "scrape_errors": {
                s.name: s.error for s in scrapes if s.error
            },
        },
    }


# -- height stitching -----------------------------------------------------


def stitch_heights(
    scrapes: list[NodeScrape],
    corrections: dict[str, float] | None = None,
) -> dict[int, dict]:
    """Join each node's span fragments into per-height trees.

    A height is COMPLETE when the fleet saw its proposal land, at
    least one gossip hop (``p2p/recv_hop``), a quorum mark, and a
    commit (``height/pipeline`` root) — with the hop origins telling
    us how many distinct nodes' sends are in the tree.  Wall times
    come from each ring's ``wall_epoch`` anchor and are mapped onto
    the reference clock via :func:`clock_corrections` (commit ends by
    the SCRAPING node's correction, origin send stamps by the ORIGIN
    node's); ``first_send_wall`` is then the earliest corrected
    origin send stamp anywhere in the fleet (the network-inclusive
    start), ``commit_end_wall`` the latest corrected commit
    completion (the network-inclusive end).
    """
    if corrections is None:
        corrections = clock_corrections(scrapes)
    origin_corr = _origin_corrections(scrapes, corrections)
    heights: dict[int, dict] = {}

    def h_entry(h) -> dict:
        return heights.setdefault(
            int(h),
            {
                "proposal": False,
                "quorum": False,
                "commit": False,
                "hops": 0,
                "origins": set(),
                "committed_on": set(),
                "first_send_wall": None,
                "commit_end_wall": None,
            },
        )

    def corrected_send(args) -> float | None:
        sw = args.get("send_wall") or args.get("origin_send_wall")
        if sw is None:
            return None
        return sw - origin_corr.get(args.get("origin") or "", 0.0)

    for s in scrapes:
        epoch = s.wall_epoch
        corr = corrections.get(s.name, 0.0)
        for e in s.span_events():
            args = e.get("args") or {}
            h = args.get("height")
            if h is None:
                continue
            name = e.get("name")
            if name == _SPAN_COMMIT:
                ent = h_entry(h)
                ent["commit"] = True
                ent["committed_on"].add(s.name)
                if epoch is not None:
                    end = (
                        epoch - corr
                        + (e.get("ts", 0.0) + e.get("dur", 0.0)) / 1e6
                    )
                    if (
                        ent["commit_end_wall"] is None
                        or end > ent["commit_end_wall"]
                    ):
                        ent["commit_end_wall"] = end
            elif name == _SPAN_HOP:
                ent = h_entry(h)
                ent["hops"] += 1
                if args.get("origin"):
                    ent["origins"].add(args["origin"])
                sw = corrected_send(args)
                if sw is not None and (
                    ent["first_send_wall"] is None
                    or sw < ent["first_send_wall"]
                ):
                    ent["first_send_wall"] = sw
            elif name in (_SPAN_PROPOSAL, _SPAN_ORIGIN_WALL):
                ent = h_entry(h)
                ent["proposal"] = True
                sw = corrected_send(args)
                if sw is not None and (
                    ent["first_send_wall"] is None
                    or sw < ent["first_send_wall"]
                ):
                    ent["first_send_wall"] = sw
            elif name in _SPAN_QUORUM:
                h_entry(h)["quorum"] = True
    return heights


def complete_heights(
    stitched: dict[int, dict], min_origins: int = 2
) -> list[int]:
    """Heights whose tree has every stage plus hops from at least
    ``min_origins`` distinct origin nodes."""
    return sorted(
        h
        for h, ent in stitched.items()
        if ent["proposal"]
        and ent["quorum"]
        and ent["commit"]
        and ent["hops"] > 0
        and len(ent["origins"]) >= min_origins
    )


def height_latencies_ms(stitched: dict[int, dict]) -> dict[int, float]:
    """Cross-node proposal→commit latency per height: earliest origin
    send stamp to latest commit completion, fleet-wide."""
    out = {}
    for h, ent in sorted(stitched.items()):
        if ent["first_send_wall"] is None or ent["commit_end_wall"] is None:
            continue
        out[h] = max(
            0.0, (ent["commit_end_wall"] - ent["first_send_wall"]) * 1e3
        )
    return out


def percentile(values: list[float], p: float) -> float:
    """Nearest-rank percentile (the ledger's latency rows use p95)."""
    if not values:
        return 0.0
    vs = sorted(values)
    idx = max(0, min(len(vs) - 1, math.ceil(p / 100.0 * len(vs)) - 1))
    return vs[idx]


# -- fleet rollup ---------------------------------------------------------

#: node labels whose fleet_height_lag child the last rollup set — a
#: repointed peer list or a newly-erroring peer must retire
#: its child (the p2p plane's departed-peer convention), not leave a
#: frozen lag tripping alerts for a node that no longer reports.
#: Guarded by _LAG_MTX: /debug/fleet is served by per-request threads
#: (and the JSON-RPC route by another server), so two concurrent
#: rollups would otherwise race the retire-then-replace sequence.
_LAG_NODES_SET: set[str] = set()
_LAG_MTX = cmtsync.Mutex()


def fleet_rollup(scrapes: list[NodeScrape]) -> dict:
    """The skew/lag table: per-node commit height (+lag behind the
    fleet max), one-hot dispatch tier, verify-queue depths, gossip-hop
    aggregates, peer count, clock offsets.  Feeds the FleetMetrics
    gauges on the aggregating node."""
    from cometbft_tpu_torch.metrics import fleet_metrics

    nodes = []
    heights = {}
    for s in scrapes:
        tier = None
        for lbl, v in series(s, "crypto_dispatch_current_tier"):
            if v >= 1.0:
                tier = lbl.get("tier")
                break
        queue_depth = {
            lbl.get("priority", ""): v
            for lbl, v in series(s, "crypto_verify_queue_depth")
        }
        hop_count = sum(
            v for _, v in series(s, "p2p_gossip_hop_seconds_count")
        )
        hop_sum = sum(v for _, v in series(s, "p2p_gossip_hop_seconds_sum"))
        height = series_value(s, "consensus_latest_block_height")
        if height is not None:
            heights[s.name] = int(height)
        nodes.append(
            {
                "node": s.name,
                "target": s.target,
                "error": s.error,
                "height": None if height is None else int(height),
                "dispatch_tier": tier,
                "verify_queue_depth": queue_depth,
                "peers": series_value(s, "p2p_peers"),
                "gossip_hops": int(hop_count),
                "gossip_hop_avg_ms": (
                    round(hop_sum / hop_count * 1e3, 3) if hop_count else None
                ),
                "clock_offsets": {
                    lbl.get("peer_id", "")[:16]: v
                    for lbl, v in series(s, "p2p_peer_clock_offset_seconds")
                },
            }
        )
    max_h = max(heights.values()) if heights else 0
    skew = (max_h - min(heights.values())) if heights else 0
    lag_set = set()
    for n in nodes:
        n["height_lag"] = (
            None if n["height"] is None else max_h - n["height"]
        )
        if n["height"] is not None:
            lag_set.add(n["node"])
    with _LAG_MTX:
        for n in nodes:
            if n["height"] is not None:
                fleet_metrics().height_lag.labels(node=n["node"]).set(
                    n["height_lag"]
                )
        for stale in _LAG_NODES_SET - lag_set:
            fleet_metrics().height_lag.remove(node=stale)
        _LAG_NODES_SET.clear()
        _LAG_NODES_SET.update(lag_set)
    fleet_metrics().nodes.set(len(scrapes))
    fleet_metrics().height_skew.set(skew)
    return {
        "nodes": nodes,
        "max_height": max_h,
        "height_skew": skew,
        "scrape_errors": sum(1 for s in scrapes if s.error),
    }


def fleet_payload(
    scrapes: list[NodeScrape], include_trace: bool = False,
    scenario: str | None = None,
) -> dict:
    """The ``/debug/fleet`` JSON: rollup + stitched-height summary (+
    the full merged Chrome trace on request)."""
    corrections = clock_corrections(scrapes)
    stitched = stitch_heights(scrapes, corrections=corrections)
    lat = height_latencies_ms(stitched)
    payload = {
        "rollup": fleet_rollup(scrapes),
        "stitched_heights": {
            h: {
                **{
                    k: (sorted(v) if isinstance(v, set) else v)
                    for k, v in ent.items()
                },
                "latency_ms": round(lat[h], 3) if h in lat else None,
            }
            for h, ent in sorted(stitched.items())
        },
        "complete_heights": complete_heights(stitched),
        "height_latency_p95_ms": (
            round(percentile(list(lat.values()), 95.0), 3) if lat else None
        ),
    }
    payload["clock_corrections"] = corrections
    # scenario plane: the scenario the caller names (wan, byzantine,
    # churn), so a reader knows WHICH conditions produced the numbers
    payload["scenario"] = scenario
    # attribution plane: each committed height's wall decomposed into
    # the critpath stage taxonomy on the same corrected axis (the
    # stage budget an operator reads AFTER the p95 row says "slow")
    try:
        from cometbft_tpu_torch.utils import critpath

        budgets = critpath.stage_budgets(
            scrapes, corrections=corrections
        )
        payload["stage_budgets"] = {
            h: d for h, d in sorted(budgets.items())
        }
        p95 = critpath.budget_at_percentile(budgets, 95.0)
        payload["stage_budget_p95"] = p95
        if p95 is not None:
            payload["critical_stage_p95"] = critpath.dominant_stage(
                p95["stages"]
            )
    except Exception:  # noqa: BLE001 — diagnostics, never the payload
        payload["stage_budgets"] = {}
        payload["stage_budget_p95"] = None
    if include_trace:
        payload["merged_trace"] = merge_traces(
            scrapes, corrections=corrections
        )
    return payload


def fleet_peer_targets(targets: str | None) -> list[str]:
    """Parse a comma-separated list of metrics addresses.  Empty/None
    means this node aggregates only itself."""
    if not targets:
        return []
    return [t.strip() for t in targets.split(",") if t.strip()]


__all__ = [
    "NodeScrape",
    "clock_corrections",
    "complete_heights",
    "fleet_payload",
    "fleet_peer_targets",
    "fleet_rollup",
    "height_latencies_ms",
    "merge_traces",
    "node_identities",
    "parse_prom_text",
    "percentile",
    "scrape_fleet",
    "scrape_node",
    "self_scrape",
    "series",
    "series_value",
    "stitch_heights",
]
