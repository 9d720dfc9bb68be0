"""Critical-path extraction (a copy of cometbft_tpu/utils/critpath.py) —
a committed height's wall, decomposed into a fixed stage taxonomy.

The fleet plane measures THAT ``height_latency_p95_4node`` is
~500 ms; this module says WHICH STAGE owns it.  Given a height's span
tree — local (one tracer ring) or stitched cross-node (fleetobs's
offset-corrected trees) — the proposal-origin→commit-end wall is
decomposed into the taxonomy below.  Every decomposition satisfies
``sum(stages.values()) == wall`` exactly (residual is defined as the
remainder, floored at zero), so stage budgets reconcile with the SLO
latency by construction, and a missing span NEVER crashes the walk —
its time degrades into ``residual``.

Stage taxonomy:

==============  =========================================================
stage           wall interval it owns
==============  =========================================================
proposal_wait   height start (or tree start) → the proposer's SEND
                stamp: waiting for a proposal to exist at all
gossip_hop      proposer's send stamp → proposal received locally (or
                on the slowest replica, cross-node): network transit
verify_spec     ``verify_queue/prepare`` time inside the vote window —
                the host phase: SHA-512 prehash, speculative-cache
                consult (hits resolve here), plan/packing
verify_launch   ``verify_queue/launch`` time inside the vote window —
                the gated device/host execute phase
quorum_wait     proposal received → +2/3 precommit, minus the verify
                time above: waiting on the NETWORK to vote
store_save      ``store/save_block`` — the atomic block+commit write
wal_fsync       ``wal/write_end_height`` — the height-boundary fsync
abci_execute    ``exec/apply_block`` — FinalizeBlock/Commit round trip
                through the application
index           ``indexer/index_block`` overlap with the height wall
                (async; the post-commit tail is the next height's
                problem)
residual        wall minus everything above: scheduling gaps, timeout
                waits, anything unattributed — an honest "don't know"
==============  =========================================================

Consumers: consensus ``_finalize_commit`` (feeds the
``AttributionMetrics`` family per committed height) and
``fleetobs.fleet_payload``'s stage budgets.  Stdlib only.
"""

from __future__ import annotations

#: the fixed taxonomy, in pipeline order (dominance ties break toward
#: the earlier stage)
STAGES = (
    "proposal_wait",
    "gossip_hop",
    "verify_spec",
    "verify_launch",
    "quorum_wait",
    "store_save",
    "wal_fsync",
    "abci_execute",
    "index",
    "residual",
)

#: span name -> the commit-pipeline stage it measures
_COMMIT_SPANS = {
    "store/save_block": "store_save",
    "wal/write_end_height": "wal_fsync",
    "exec/apply_block": "abci_execute",
    "indexer/index_block": "index",
}

_SPAN_ROOT = "height/pipeline"
_SPAN_PROPOSAL = "height/proposal_received"
_SPAN_ORIGIN_WALL = "height/proposal_origin_wall"
_SPAN_HOP = "p2p/recv_hop"
_SPAN_QUORUM_PREVOTE = "height/quorum_prevote"
_SPAN_QUORUM_PRECOMMIT = "height/quorum_precommit"
_SPAN_VERIFY_PREP = "verify_queue/prepare"
_SPAN_VERIFY_LAUNCH = "verify_queue/launch"
#: WAN-emulation hold (p2p/conn/netem.py) — injected, not intrinsic,
#: wall; frames are multiplexed so the span carries no height tag
_SPAN_NETEM = "p2p/netem_hold"


def _clip(start: float, end: float, lo: float, hi: float) -> float:
    """Overlap length of [start, end] with [lo, hi] (>= 0)."""
    return max(0.0, min(end, hi) - max(start, lo))


def _union_len(
    intervals: list[tuple[float, float]], lo: float, hi: float
) -> float:
    """Total length of the union of ``intervals`` clipped to
    [lo, hi] — two overlapping verify launches must not double-bill
    the vote window."""
    clipped = sorted(
        (max(s, lo), min(e, hi))
        for s, e in intervals
        if min(e, hi) > max(s, lo)
    )
    total, cur_s, cur_e = 0.0, None, None
    for s, e in clipped:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _empty_stages() -> dict[str, float]:
    return {s: 0.0 for s in STAGES}


def _is_height(ev: dict, height: int) -> bool:
    try:
        return int((ev.get("args") or {}).get("height")) == height
    except (TypeError, ValueError):
        return False


def _decompose_window(
    t0: float,
    t1: float,
    t_send: float | None,
    t_prop: float | None,
    t_qpc: float | None,
    commit_durs: dict[str, float],
    verify_prep: list[tuple[float, float]],
    verify_launch: list[tuple[float, float]],
) -> dict[str, float]:
    """The shared stage math, all times in SECONDS on one axis.
    Degrades monotonically: any missing mark zeroes its stage(s) and
    the time lands in residual."""
    stages = _empty_stages()
    wall = max(t1 - t0, 0.0)
    if wall <= 0.0:
        return stages

    def clamp(t):
        return None if t is None else min(max(t, t0), t1)

    t_send, t_prop, t_qpc = clamp(t_send), clamp(t_prop), clamp(t_qpc)
    if t_prop is not None:
        if t_send is not None and t_send <= t_prop:
            stages["proposal_wait"] = t_send - t0
            stages["gossip_hop"] = t_prop - t_send
        else:
            # no origin stamp (self-proposed, or an untagged sender):
            # the whole pre-proposal interval is proposal_wait
            stages["proposal_wait"] = t_prop - t0
    # the vote window: proposal landed -> +2/3 precommit
    if t_prop is not None and t_qpc is not None and t_qpc >= t_prop:
        prep_u = _union_len(verify_prep, t_prop, t_qpc)
        launch_u = _union_len(verify_launch, t_prop, t_qpc)
        both_u = _union_len(verify_prep + verify_launch, t_prop, t_qpc)
        # prep overlaps launch by design (the double-buffer overlap
        # proof); bill the window once, split by each side's share
        if prep_u + launch_u > 0.0:
            stages["verify_spec"] = both_u * prep_u / (prep_u + launch_u)
            stages["verify_launch"] = both_u - stages["verify_spec"]
        stages["quorum_wait"] = max(0.0, (t_qpc - t_prop) - both_u)
    for stage, dur in commit_durs.items():
        stages[stage] = max(dur, 0.0)
    attributed = sum(stages.values())
    stages["residual"] = max(0.0, wall - attributed)
    # over-attribution (clock fuzz on stitched trees, an index span
    # wider than its clip) is squeezed back so the budget still sums
    # to the wall the SLO row reports
    if attributed > wall and attributed > 0.0:
        scale = wall / attributed
        for s in STAGES:
            stages[s] *= scale
    return stages


# -- local decomposition (one tracer ring) --------------------------------


def decompose_local(
    events: list[dict], height: int, wall_epoch: float | None = None
) -> dict | None:
    """Decompose one committed height from a single ring's span
    events (trace-export ``traceEvents`` or ``SpanTracer.events()``
    shape: ts/dur in microseconds on one epoch).  Returns ``{height,
    wall_s, stages}`` or None when the height has no committed root
    span."""
    root = None
    marks: dict[str, float] = {}
    commit_spans: dict[str, tuple[float, float]] = {}
    verify_prep: list[tuple[float, float]] = []
    verify_launch: list[tuple[float, float]] = []
    origin_send_wall: float | None = None

    for ev in events:
        if ev.get("ph") not in (None, "X"):
            continue
        name = ev.get("name")
        ts = float(ev.get("ts", 0.0)) / 1e6
        dur = float(ev.get("dur", 0.0)) / 1e6
        if name == _SPAN_VERIFY_PREP:
            verify_prep.append((ts, ts + dur))
            continue
        if name == _SPAN_VERIFY_LAUNCH:
            verify_launch.append((ts, ts + dur))
            continue
        if not _is_height(ev, height):
            continue
        if name == _SPAN_ROOT:
            if root is None or ts >= root[0]:
                root = (ts, ts + dur)
        elif name == _SPAN_PROPOSAL:
            marks.setdefault("prop", ts)
        elif name in (_SPAN_ORIGIN_WALL, _SPAN_HOP):
            args = ev.get("args") or {}
            sw = args.get("send_wall") or args.get("origin_send_wall")
            if sw is not None:
                try:
                    sw = float(sw)
                except (TypeError, ValueError):
                    continue
                if origin_send_wall is None or sw < origin_send_wall:
                    origin_send_wall = sw
        elif name == _SPAN_QUORUM_PRECOMMIT:
            marks["qpc"] = max(marks.get("qpc", ts), ts)
        elif name in _COMMIT_SPANS:
            stage = _COMMIT_SPANS[name]
            prev = commit_spans.get(stage)
            if prev is None or ts >= prev[0]:
                commit_spans[stage] = (ts, ts + dur)
    if root is None:
        return None
    t0, t1 = root
    t_send = None
    if origin_send_wall is not None and wall_epoch is not None:
        t_send = origin_send_wall - wall_epoch
    commit_durs = {
        stage: _clip(s, e, t0, t1)
        for stage, (s, e) in commit_spans.items()
    }
    stages = _decompose_window(
        t0, t1, t_send, marks.get("prop"), marks.get("qpc"),
        commit_durs, verify_prep, verify_launch,
    )
    return {
        "height": int(height),
        "wall_s": round(max(t1 - t0, 0.0), 6),
        "stages": {s: round(v, 6) for s, v in stages.items()},
    }


def committed_heights(events: list[dict]) -> list[int]:
    """Heights with a ``height/pipeline`` root in the ring, sorted."""
    out = set()
    for ev in events:
        if ev.get("name") != _SPAN_ROOT:
            continue
        h = (ev.get("args") or {}).get("height")
        try:
            out.add(int(h))
        except (TypeError, ValueError):
            continue
    return sorted(out)


# -- cross-node decomposition (fleetobs stitched trees) -------------------


def decompose_stitched(
    scrapes, height: int, corrections: dict[str, float] | None = None
) -> dict | None:
    """Decompose one height across a fleet of scrapes
    (utils/fleetobs.NodeScrape), on the offset-corrected wall axis.

    Wall matches :func:`fleetobs.height_latencies_ms` exactly:
    earliest corrected origin send → latest corrected commit end.  The
    commit-pipeline stages come from the GATING node (latest commit
    end — the replica the SLO actually waited for); gossip_hop runs to
    the SLOWEST replica's proposal receipt for the same reason.
    Returns None when no node committed the height."""
    from cometbft_tpu_torch.utils import fleetobs

    if corrections is None:
        corrections = fleetobs.clock_corrections(scrapes)
    origin_corr = {}
    for fid, name in fleetobs.node_identities(scrapes).items():
        origin_corr[fid[:16]] = corrections.get(name, 0.0)

    first_send = None
    commit_end = None
    gating = None  # (scrape, local t0..t1 seconds, shift to wall)
    prop_latest = None
    qpc_latest = None
    netem_holds: list[tuple[float, float]] = []
    for s in scrapes:
        epoch = s.wall_epoch
        if epoch is None:
            continue
        shift = epoch - corrections.get(s.name, 0.0)
        for ev in s.span_events():
            name = ev.get("name")
            ts = float(ev.get("ts", 0.0)) / 1e6
            dur = float(ev.get("dur", 0.0)) / 1e6
            if name == _SPAN_NETEM:
                netem_holds.append((shift + ts, shift + ts + dur))
                continue
            if name in (_SPAN_ORIGIN_WALL, _SPAN_HOP, _SPAN_PROPOSAL):
                if not _is_height(ev, height):
                    continue
                args = ev.get("args") or {}
                sw = args.get("send_wall") or args.get(
                    "origin_send_wall"
                )
                if sw is not None:
                    try:
                        sw = float(sw) - origin_corr.get(
                            args.get("origin") or "", 0.0
                        )
                    except (TypeError, ValueError):
                        sw = None
                    if sw is not None and (
                        first_send is None or sw < first_send
                    ):
                        first_send = sw
                if name == _SPAN_PROPOSAL:
                    w = shift + ts
                    if prop_latest is None or w > prop_latest:
                        prop_latest = w
            elif name == _SPAN_QUORUM_PRECOMMIT and _is_height(
                ev, height
            ):
                w = shift + ts
                if qpc_latest is None or w > qpc_latest:
                    qpc_latest = w
            elif name == _SPAN_ROOT and _is_height(ev, height):
                end = shift + ts + dur
                if commit_end is None or end > commit_end:
                    commit_end = end
                    gating = (s, ts, ts + dur, shift)
    if gating is None:
        return None
    g, g_t0, g_t1, g_shift = gating
    t0 = first_send if first_send is not None else g_shift + g_t0
    t1 = commit_end
    # commit-pipeline + verify intervals from the gating node, on the
    # corrected wall axis
    commit_spans: dict[str, tuple[float, float]] = {}
    verify_prep: list[tuple[float, float]] = []
    verify_launch: list[tuple[float, float]] = []
    for ev in g.span_events():
        name = ev.get("name")
        ts = g_shift + float(ev.get("ts", 0.0)) / 1e6
        dur = float(ev.get("dur", 0.0)) / 1e6
        if name == _SPAN_VERIFY_PREP:
            verify_prep.append((ts, ts + dur))
        elif name == _SPAN_VERIFY_LAUNCH:
            verify_launch.append((ts, ts + dur))
        elif name in _COMMIT_SPANS and _is_height(ev, height):
            stage = _COMMIT_SPANS[name]
            prev = commit_spans.get(stage)
            if prev is None or ts >= prev[0]:
                commit_spans[stage] = (ts, ts + dur)
    commit_durs = {
        stage: _clip(s, e, t0, t1)
        for stage, (s, e) in commit_spans.items()
    }
    stages = _decompose_window(
        t0, t1, first_send, prop_latest, qpc_latest,
        commit_durs, verify_prep, verify_launch,
    )
    # injected (netem) wall overlapping this height's window: the
    # seconds during which at least one emulated link was holding a
    # frame — read gossip_hop minus this for the INTRINSIC hop wall
    # (docs/observability.md "Scenario plane").  Kept beside, not
    # inside, the stage taxonomy: stages must keep summing to wall_s.
    injected = _union_len(netem_holds, t0, t1)
    return {
        "height": int(height),
        "wall_s": round(max(t1 - t0, 0.0), 6),
        "gating_node": g.name,
        "stages": {s: round(v, 6) for s, v in stages.items()},
        "injected_s": round(injected, 6),
    }


def stage_budgets(
    scrapes, corrections: dict[str, float] | None = None
) -> dict[int, dict]:
    """Every committed height in the fleet, decomposed — the
    ``/debug/fleet`` stage-budget table and the fleet smoke's ledger
    input."""
    from cometbft_tpu_torch.utils import fleetobs

    if corrections is None:
        corrections = fleetobs.clock_corrections(scrapes)
    heights: set[int] = set()
    for s in scrapes:
        heights.update(committed_heights(s.span_events()))
    out: dict[int, dict] = {}
    for h in sorted(heights):
        d = decompose_stitched(scrapes, h, corrections=corrections)
        if d is not None:
            out[h] = d
    return out


def budget_at_percentile(
    budgets: dict[int, dict], p: float = 95.0
) -> dict | None:
    """The stage budget OF the percentile height: nearest-rank on
    wall_s picks an actual height, and that height's decomposition is
    returned — so the per-stage ledger rows sum (with residual) to the
    latency row they explain, by construction."""
    if not budgets:
        return None
    ranked = sorted(budgets.values(), key=lambda d: d["wall_s"])
    import math

    idx = max(
        0, min(len(ranked) - 1, math.ceil(p / 100.0 * len(ranked)) - 1)
    )
    return ranked[idx]


# -- runtime hook (consensus _finalize_commit) ----------------------------


def dominant_stage(stages: dict[str, float]) -> str:
    """The stage that owns the height (ties break in pipeline order)."""
    best = STAGES[0]
    for s in STAGES:
        if stages.get(s, 0.0) > stages.get(best, 0.0):
            best = s
    return best


def observe_height(height: int, tracer=None, metrics=None) -> dict | None:
    """Decompose ``height`` from the live ring and feed the
    AttributionMetrics family: every stage's seconds into the
    ``attribution_height_stage_seconds`` histogram, and the dominant
    stage one-hot into ``attribution_height_critical_stage``.
    Best-effort by contract — observability must never fail a commit."""
    try:
        if tracer is None:
            from cometbft_tpu_torch.utils.trace import TRACER as tracer
        if metrics is None:
            from cometbft_tpu_torch.metrics import attribution_metrics

            metrics = attribution_metrics()
        d = decompose_local(
            tracer.events(), height, wall_epoch=tracer.epoch_wall
        )
        if d is None:
            return None
        dom = dominant_stage(d["stages"])
        for stage in STAGES:
            metrics.height_stage_seconds.labels(stage=stage).observe(
                d["stages"].get(stage, 0.0)
            )
            metrics.height_critical_stage.labels(stage=stage).set(
                1.0 if stage == dom else 0.0
            )
        d["critical_stage"] = dom
        return d
    except Exception:  # noqa: BLE001 — observability, never liveness
        return None


__all__ = [
    "STAGES",
    "budget_at_percentile",
    "committed_heights",
    "decompose_local",
    "decompose_stitched",
    "dominant_stage",
    "observe_height",
    "stage_budgets",
]
