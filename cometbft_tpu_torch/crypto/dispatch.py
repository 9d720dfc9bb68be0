"""The failover dispatch ladder: health-driven tier demotion and
promotion, and the cost model that orders a batch's walk (a copy of
cometbft_tpu/crypto/dispatch.py for the ed25519 tiers).

**The ladder.**  Tiers in strict preference order::

    keyed_mesh > keyed > generic_mesh > generic > host > python

(the keyed verify sharded over a device mesh, the single-device keyed
verify, the sharded generic verify, the single-device generic verify,
the native host RLC check, and the per-signature oracle; the
reference's BLS rung comes with BLS).
``TorchBatchVerifier.plan()`` asks the ladder which of a batch's
eligible tiers are admissible; ``execute()`` walks them top-down, and
``parallel/mesh.py``'s ``ShardedTorchBatchVerifier`` inherits the same
policy through that seam.  The
``python`` floor (the per-signature oracle) is never demoted: consensus
liveness rests on it.

**Demotion** is immediate: a typed tier fault (``TierFault``, of which
the chaos plan's ``ChaosFault`` is one, or ``TierUnavailable``), a
watchdog overrun (crypto/health.py) or ``demote_after`` consecutive
canary failures demotes the tier for a cool-down that doubles with
each repeat offence, up to ``cooldown_max_s``.

**Promotion**: once its cool-down has expired a demoted tier is
re-admitted for a half-open trial: the next batch may run on it, and
one success promotes it (one failure re-demotes it at the doubled
cool-down); ``promote_after`` healthy canaries promote it too.

**Chaos**: a deterministic fault plan (``ChaosPlan``, the reference's
grammar) injected at the execute seam -- device loss, a launch hang
past the watchdog's budget, a transient mis-launch, the loss of one
shard of a mesh.
``CHAOS.load(plan)`` arms it; the port reads no environment variable
for it.  Chaos never faults the host or python floor.

**Cost-based routing**: ``TierCostModel`` keeps per-(tier, pow2
shape bucket) throughput estimates, seeded from the perf ledger's
single-batch rows (``crypto/health.py measured_tier_throughput``: the
rows ``chip_smoke.py`` measured on this machine's card, never a TPU
round's) at the first routing consult (``ensure_seeded``) and refined
online by an EWMA over the per-batch timings ``note_batch`` receives,
and ``route()`` orders a batch's admissible tiers (plus the host rung)
by predicted wall time for that shape.  Cost ordering only permutes
the admissible list; the floor is always last.  Hysteresis keeps one
noisy sample from flapping the order: a seeded estimate takes part at
once, an online one only after ``min_samples`` samples, a reorder
needs a ``margin`` predicted gain, samples are winsorized, and an
adopted order holds for ``cooldown_s`` per bucket.  While a
non-static order is in force, every ``ROUTE_RESAMPLE_EVERY``-th batch
of its bucket takes the static order, so the tier it displaced is
measured again: the canary prober (crypto/health.py) only demotes and
promotes, it gives the cost model no sample.

Every transition is recorded in the ladder's transition ring, as a
``crypto/dispatch_transition`` flight event, and in
``crypto_dispatch_demotions_total{from,to,reason}`` /
``crypto_dispatch_promotions_total{tier}`` /
``crypto_dispatch_current_tier{tier}`` (one-hot).
``debug_dispatch_payload()`` gathers the ladder, the chaos plan, the
cost table and the ledger's measured throughput with the order
contradictions it shows.

Every parameter is a constructor argument with the reference's
default.
"""

from __future__ import annotations

import logging
import random
import time
from collections import deque

from cometbft_tpu_torch.metrics import crypto_metrics as _crypto_metrics
from cometbft_tpu_torch.utils.flight import FLIGHT
from cometbft_tpu_torch.utils import sync as cmtsync

#: the full ladder, best tier first
TIER_ORDER = ("keyed_mesh", "keyed", "generic_mesh", "generic", "host", "python")
#: tiers that launch on the device
DEVICE_TIERS = frozenset(("keyed_mesh", "keyed", "generic_mesh", "generic"))
#: tiers the chaos plan may fault: everything above the host/python floor
CHAOS_TIERS = DEVICE_TIERS
#: tiers that shard over a device mesh (the scope of shard_loss chaos)
MESH_TIERS = frozenset(("keyed_mesh", "generic_mesh"))
#: the floor: per-signature verification, never demoted, never faulted
FLOOR_TIER = "python"

DEFAULT_DEMOTE_AFTER = 3
DEFAULT_PROMOTE_AFTER = 2
DEFAULT_COOLDOWN_S = 30.0
DEFAULT_COOLDOWN_MAX_S = 600.0
#: transition-ring depth
TRANSITION_RING = 64

# -- cost-routing policy (TierCostModel) --------------------------------
#: online samples a (tier, bucket) estimate needs before it may reorder
DEFAULT_ROUTE_MIN_SAMPLES = 3
#: predicted gain a lower rung needs to outrank a higher one (0.2: 20%)
DEFAULT_ROUTE_MARGIN = 0.2
#: an adopted order holds at least this long per (bucket, candidates)
DEFAULT_ROUTE_COOLDOWN_S = 30.0
#: under a non-static order, every this-many-th batch of the bucket
#: takes the static order, so a displaced tier is measured again
ROUTE_RESAMPLE_EVERY = 32
#: EWMA smoothing for online refinement
ROUTE_EWMA_ALPHA = 0.2
#: a sample is clamped to [est / 2, est * 2] before the EWMA
ROUTE_WINSOR_FACTOR = 2.0
#: shape-bucket ceiling (anything larger shares the top bucket)
MAX_SHAPE_BUCKET = 1 << 20

_log = logging.getLogger("cometbft_tpu_torch.crypto.dispatch")


def shape_bucket(n: int) -> int:
    """The pow2 ceiling bucket a batch of ``n`` signatures falls in: the
    cost model's shape key (a 2-signature evidence check and a 10k
    commit never share an estimate)."""
    if n <= 1:
        return 1
    return min(1 << (n - 1).bit_length(), MAX_SHAPE_BUCKET)


class TierUnavailable(RuntimeError):
    """A tier cannot serve this batch at all (capability or policy), as
    opposed to failing at run time."""

    def __init__(self, tier: str, reason: str = "") -> None:
        super().__init__(f"tier {tier} unavailable: {reason}")
        self.tier = tier
        self.reason = reason


class TierFault(RuntimeError):
    """A tier failed at run time (a chaos fault, or a launch the
    watchdog declared hung): the typed escalation the execute walk
    turns into a demotion.  Any other exception from a tier, a kernel
    that fails to build or to launch among them, reaches the caller."""

    def __init__(self, tier: str, reason: str = "") -> None:
        super().__init__(f"tier {tier} fault: {reason}")
        self.tier = tier
        self.reason = reason


class ChaosFault(TierFault):
    """A fault injected by the chaos plan."""


def fault_reason(exc: BaseException) -> str:
    """Bounded-cardinality reason label for an escalation exception."""
    if isinstance(exc, ChaosFault):
        return f"chaos:{exc.reason}"
    if isinstance(exc, (TierFault, TierUnavailable)):
        return exc.reason or type(exc).__name__
    return f"launch:{type(exc).__name__}"


# -- the chaos plan ------------------------------------------------------

#: device_loss -- every device-tier launch in the window raises;
#: launch_hang -- the launch sleeps past the watchdog's budget, then
#:   raises (the watchdog fires first);
#: mislaunch   -- exactly ONE launch in the window raises (transient);
#: shard_loss  -- only the *_mesh tiers raise (one device of the mesh
#:   gone: the single-device tiers still work).
CHAOS_KINDS = ("device_loss", "launch_hang", "mislaunch", "shard_loss")


class ChaosPlan:
    """A deterministic fault schedule: windows of (start_s, end_s, kind)
    over seconds since the chaos epoch.  Spec grammar (entries separated
    by ``;``):

    - ``kind@START-END``: an explicit window, e.g. ``device_loss@0-2.5``.
    - ``seed=N[,on=S][,off=S][,n=K][,kinds=a|b]``: K pseudo-random fault
      windows from ``random.Random(N)``: quiet gaps of ~``off`` seconds,
      faults of ~``on`` seconds, kinds drawn from the ``|``-list.  The
      same spec gives the same schedule, always.
    """

    def __init__(self, windows: list[tuple[float, float, str]]) -> None:
        self.windows = sorted(windows)
        for start, end, kind in self.windows:
            if kind not in CHAOS_KINDS:
                raise ValueError(f"chaos plan: unknown fault kind {kind!r} "
                                 f"(one of {'|'.join(CHAOS_KINDS)})")
            if not (0 <= start < end):
                raise ValueError(f"chaos plan: bad window {start}-{end}")

    @classmethod
    def parse(cls, spec: str) -> "ChaosPlan":
        windows: list[tuple[float, float, str]] = []
        for entry in spec.split(";"):
            entry = entry.strip()
            if not entry:
                continue
            if entry.startswith("seed="):
                windows.extend(cls._seeded(entry))
                continue
            try:
                kind, span = entry.split("@", 1)
                a, b = span.split("-", 1)
                windows.append((float(a), float(b), kind.strip()))
            except ValueError:
                raise ValueError(f"chaos plan: cannot parse entry {entry!r} "
                                 "(want kind@start-end or seed=N,...)") from None
        if not windows:
            raise ValueError("chaos plan: empty plan")
        return cls(windows)

    @staticmethod
    def _seeded(entry: str) -> list[tuple[float, float, str]]:
        params = {"on": 2.0, "off": 6.0, "n": 4.0}
        kinds: list[str] = ["device_loss"]
        seed = 0
        for part in entry.split(","):
            key, _, val = part.partition("=")
            key = key.strip()
            if key == "seed":
                seed = int(val)
            elif key == "kinds":
                kinds = [k for k in val.split("|") if k]
            elif key in params:
                params[key] = float(val)
            else:
                raise ValueError(f"chaos plan: unknown seeded param {key!r}")
        rng = random.Random(seed)
        windows: list[tuple[float, float, str]] = []
        t = 0.0
        for _ in range(int(params["n"])):
            t += params["off"] * (0.5 + rng.random())
            dur = params["on"] * (0.5 + rng.random())
            windows.append((t, t + dur, kinds[rng.randrange(len(kinds))]))
            t += dur
        return windows

    def applies(self, kind: str, tier: str) -> bool:
        if tier not in CHAOS_TIERS:
            return False  # the host/python floor is never faulted
        if kind == "shard_loss":
            return tier in MESH_TIERS
        return True

    def fault_at(self, tier: str, t: float, fired: set[int]) -> tuple[int, str] | None:
        """The (window index, kind) faulting ``tier`` at plan time ``t``;
        a ``mislaunch`` window fires once (the caller's ``fired`` set)."""
        for idx, (start, end, kind) in enumerate(self.windows):
            if not (start <= t < end) or not self.applies(kind, tier):
                continue
            if kind == "mislaunch" and idx in fired:
                continue
            return idx, kind
        return None


@cmtsync.guarded
class Chaos:
    """The chaos injector: a no-op until a plan is loaded.  The plan's
    clock starts at the first injection check."""

    _GUARDED_BY = {
        "_epoch": "_mtx",
        "_fired": "_mtx",
        "_hits": "_mtx",
    }

    def __init__(self) -> None:
        self._mtx = cmtsync.Mutex()
        self._epoch: float | None = None
        self._fired: set[int] = set()
        self._hits: dict[str, int] = {}
        self._tiers = CHAOS_TIERS
        self.plan: ChaosPlan | None = None

    def load(self, plan: ChaosPlan | None, tiers=CHAOS_TIERS) -> None:
        """Arm ``plan`` (None disarms) with a fresh epoch.  ``tiers``
        narrows the plan to some of the device tiers (a loss of one
        tier's kernel rather than of the device); the floor is never
        faulted whatever it names."""
        with self._mtx:
            self.plan = plan
            self._tiers = frozenset(tiers) & CHAOS_TIERS
            self._epoch = None
            self._fired = set()
            self._hits = {}

    def enabled(self) -> bool:
        return self.plan is not None

    def inject(self, tier: str, probe: bool = False) -> None:
        """The execute seam's (and the canary prober's) injection point:
        raises ChaosFault when the plan schedules a fault for ``tier``
        now.  ``launch_hang`` first sleeps past the watchdog's budget, so
        the watchdog demotes, except on the probe seam (``probe``), where
        the prober's own timeout plays that part."""
        plan = self.plan
        if plan is None or tier not in self._tiers:
            return
        with self._mtx:
            if self._epoch is None:
                self._epoch = time.monotonic()
            t = time.monotonic() - self._epoch
            hit = plan.fault_at(tier, t, self._fired)
            if hit is None:
                return
            idx, kind = hit
            if kind == "mislaunch":
                self._fired.add(idx)
            self._hits[kind] = self._hits.get(kind, 0) + 1
        if kind == "launch_hang" and not probe:
            from cometbft_tpu_torch.crypto import health as _health

            time.sleep(_health.WATCHDOG.budget_s * 1.25)
        raise ChaosFault(tier, kind)

    def snapshot(self) -> dict:
        plan = self.plan
        with self._mtx:
            elapsed = (round(time.monotonic() - self._epoch, 3)
                       if self._epoch is not None else None)
            hits = dict(self._hits)
        return {
            "enabled": plan is not None,
            "elapsed_s": elapsed,
            "hits": hits,
            "windows": ([{"kind": k, "start_s": a, "end_s": b} for a, b, k in plan.windows]
                        if plan is not None else []),
        }


# -- the cost model ------------------------------------------------------


class TierCostModel:
    """Per-(tier, pow2 shape bucket) throughput estimates and the order
    they imply.  Not locked on its own: the owning DispatchLadder calls
    every ``*_locked`` method under its lock.

    A ``seeded`` estimate comes from the perf ledger's measured rows
    (``seed_locked``) and takes part at once; an online estimate starts
    ``warming`` and takes part only after ``min_samples`` batches; either
    becomes ``learned`` once ``min_samples`` online samples have refined
    it.  Estimates are strictly per bucket: which tier wins flips with
    batch size, so there is no extrapolation across shapes.

    Ordering: the estimated tiers are bubble-sorted among themselves,
    a lower tier passing a higher one only when it predicts a ``margin``
    faster run, and put back into the slots they held; tiers without
    an estimate keep their static places.  An adopted order is cached
    per (bucket, candidates) and held for ``cooldown_s``; while it is not
    the static order, every ``ROUTE_RESAMPLE_EVERY``-th batch takes the static
    order (source ``resample``), so the displaced tier's estimate is
    refreshed and a transient slowdown cannot lock it out.
    """

    def __init__(self, enabled: bool = True, min_samples: int = DEFAULT_ROUTE_MIN_SAMPLES,
                 margin: float = DEFAULT_ROUTE_MARGIN,
                 cooldown_s: float = DEFAULT_ROUTE_COOLDOWN_S) -> None:
        self.enabled = enabled
        self.min_samples = min_samples
        self.margin = margin
        self.cooldown_s = cooldown_s
        # (tier, bucket) -> {sigs_per_sec, samples, source, config}
        self._est: dict[tuple[str, int], dict] = {}
        # (bucket, static candidates) -> {order, last_reorder, reorders,
        # since_resample}
        self._orders: dict[tuple[int, tuple], dict] = {}
        #: ledger seeding has happened (set once; a racing second seed
        #: is harmless: seed_locked never overwrites online evidence)
        self.seeded = False

    def seed_locked(self, measured: dict) -> int:
        """Seed from ``health.measured_tier_throughput()``'s per-bucket
        view; an estimate that already has online samples is never
        overwritten.  Returns the number of estimates seeded."""
        n = 0
        for tier, info in measured.items():
            if tier not in TIER_ORDER or tier == FLOOR_TIER:
                continue
            for bucket, entry in (info.get("buckets") or {}).items():
                key = (tier, int(bucket))
                st = self._est.get(key)
                if st is not None and st["samples"] > 0:
                    continue
                self._est[key] = {
                    "sigs_per_sec": float(entry["sigs_per_sec"]),
                    "samples": 0,
                    "source": "seeded",
                    "config": entry.get("config"),
                }
                n += 1
        self.seeded = True
        return n

    def observe_locked(self, tier: str, batch: int, seconds: float | None) -> None:
        """One batch's throughput, folded into the (tier, bucket) EWMA
        after clamping to [est/2, est*2]: an established estimate moves
        at most 20% per batch."""
        if tier == FLOOR_TIER or tier not in TIER_ORDER or batch < 1 or not seconds \
                or seconds <= 0:
            return
        sample = batch / seconds
        key = (tier, shape_bucket(batch))
        st = self._est.get(key)
        if st is None:
            self._est[key] = {
                "sigs_per_sec": sample,
                "samples": 1,
                "source": "learned" if self.min_samples <= 1 else "warming",
                "config": None,
            }
            return
        prev = st["sigs_per_sec"]
        clamped = min(max(sample, prev / ROUTE_WINSOR_FACTOR), prev * ROUTE_WINSOR_FACTOR)
        st["sigs_per_sec"] = (1.0 - ROUTE_EWMA_ALPHA) * prev + ROUTE_EWMA_ALPHA * clamped
        st["samples"] += 1
        if st["samples"] >= self.min_samples:
            st["source"] = "learned"

    def _participating_locked(self, tier: str, bucket: int) -> dict | None:
        st = self._est.get((tier, bucket))
        if st is None or st["source"] not in ("seeded", "learned"):
            return None  # warming: under min_samples, no say yet
        return st

    def desired_locked(self, candidates: list[str], bucket: int) -> tuple:
        """The cost-implied order (class docstring)."""
        order = list(candidates)
        idxs = [i for i, t in enumerate(order)
                if self._participating_locked(t, bucket) is not None]
        sub = [order[i] for i in idxs]
        for _ in range(len(sub)):
            swapped = False
            for k in range(len(sub) - 1):
                ea = self._participating_locked(sub[k], bucket)
                eb = self._participating_locked(sub[k + 1], bucket)
                if eb["sigs_per_sec"] > ea["sigs_per_sec"] * (1.0 + self.margin):
                    sub[k], sub[k + 1] = sub[k + 1], sub[k]
                    swapped = True
            if not swapped:
                break
        for i, t in zip(idxs, sub):
            order[i] = t
        return tuple(order)

    def order_locked(self, candidates: list[str], bucket: int,
                     now: float) -> tuple[tuple, bool, str]:
        """-> (order, reordered now, source) for one batch.  ``source``
        says how the FIRST tier got its place: ``static``, the winning
        estimate's provenance (``seeded`` or ``learned``), or
        ``resample`` (the static order, taken under another one)."""
        static = tuple(candidates)
        if not self.enabled or len(static) < 2:
            return static, False, "static"
        desired = self.desired_locked(candidates, bucket)
        key = (bucket, static)
        st = self._orders.get(key)
        if st is None:
            st = self._orders[key] = {"order": static, "last_reorder": None, "reorders": 0,
                                      "since_resample": 0}
        reordered = False
        if desired != st["order"]:
            last = st["last_reorder"]
            if last is None or now - last >= self.cooldown_s:
                st["order"] = desired
                st["last_reorder"] = now
                st["reorders"] += 1
                reordered = True
        order = st["order"]
        if order[0] == static[0]:
            return order, reordered, "static"
        st["since_resample"] += 1
        if st["since_resample"] >= ROUTE_RESAMPLE_EVERY:
            st["since_resample"] = 0
            return static, reordered, "resample"
        est = self._participating_locked(order[0], bucket)
        return order, reordered, est["source"] if est is not None else "learned"

    def snapshot_locked(self, now: float) -> dict:
        table = [
            {
                "tier": tier,
                "bucket": bucket,
                "sigs_per_sec": round(st["sigs_per_sec"], 1),
                "samples": st["samples"],
                "source": st["source"],
                "config": st["config"],
                "participating": self._participating_locked(tier, bucket) is not None,
            }
            for (tier, bucket), st in sorted(self._est.items())
        ]
        orders = [
            {
                "bucket": bucket,
                "candidates": list(cands),
                "order": list(st["order"]),
                "reorders": st["reorders"],
                "last_reorder_age_s": (round(now - st["last_reorder"], 3)
                                       if st["last_reorder"] is not None else None),
            }
            for (bucket, cands), st in sorted(self._orders.items())
            if st["order"] != cands or st["reorders"]
        ]
        return {
            "enabled": self.enabled,
            "seeded": self.seeded,
            "policy": {
                "min_samples": self.min_samples,
                "margin": self.margin,
                "cooldown_s": self.cooldown_s,
                "ewma_alpha": ROUTE_EWMA_ALPHA,
                "winsor_factor": ROUTE_WINSOR_FACTOR,
            },
            "table": table,
            "orders": orders,
        }


# -- the ladder ----------------------------------------------------------


@cmtsync.guarded
class DispatchLadder:
    """The process-wide tier-availability state machine (module
    docstring).  Every verifier consults the one ``LADDER``, so a tier
    demoted under one caller's traffic is demoted for all."""

    _GUARDED_BY = {
        "_state": "_mtx",
        "_known": "_mtx",
        "_transitions": "_mtx",
        "_gauge_set": "_mtx",
    }

    def __init__(self, demote_after: int = DEFAULT_DEMOTE_AFTER,
                 promote_after: int = DEFAULT_PROMOTE_AFTER,
                 cooldown_s: float = DEFAULT_COOLDOWN_S,
                 cooldown_max_s: float = DEFAULT_COOLDOWN_MAX_S,
                 clock=time.monotonic, cost_model: TierCostModel | None = None) -> None:
        self._mtx = cmtsync.Mutex()
        self._configure(demote_after, promote_after, cooldown_s, cooldown_max_s, clock,
                        cost_model)

    def _configure(self, demote_after, promote_after, cooldown_s, cooldown_max_s, clock,
                   cost_model) -> None:
        self._clock = clock
        self.demote_after = demote_after
        self.promote_after = promote_after
        self.cooldown_s = cooldown_s
        self.cooldown_max_s = cooldown_max_s
        # tier -> mutable state dict (guarded by _mtx)
        self._state: dict[str, dict] = {}
        self._known: set[str] = {"host", FLOOR_TIER}
        self._transitions: deque = deque(maxlen=TRANSITION_RING)
        # the one-hot gauge changes only on transitions and _known growth
        self._gauge_set = False
        self._cost = cost_model if cost_model is not None else TierCostModel()

    # -- state helpers (call under _mtx) ---------------------------------

    def _st(self, tier: str) -> dict:
        st = self._state.get(tier)
        if st is None:
            st = self._state[tier] = {
                "demoted": False,
                "fail_streak": 0,      # consecutive probe failures
                "ok_streak": 0,        # healthy canaries while demoted
                "cooldown_until": 0.0,
                "next_cooldown_s": self.cooldown_s,
                "demotions": 0,
                "promotions": 0,
                "last_reason": None,
            }
        return st

    def _active_locked(self, tier: str) -> bool:
        if tier == FLOOR_TIER:
            return True
        st = self._state.get(tier)
        if st is None or not st["demoted"]:
            return True
        # half-open trial: cool-down expiry re-admits the tier for the
        # next batch (a success promotes, a failure re-demotes at double
        # the cool-down), so a process with no prober still recovers
        return self._clock() >= st["cooldown_until"]

    def _current_locked(self) -> str:
        for tier in TIER_ORDER:
            if tier in self._known and self._active_locked(tier):
                return tier
        return FLOOR_TIER

    def _next_active_below_locked(self, tier: str) -> str:
        if tier not in TIER_ORDER:
            return FLOOR_TIER
        for t in TIER_ORDER[TIER_ORDER.index(tier) + 1:]:
            if (t in self._known or t in ("host", FLOOR_TIER)) and self._active_locked(t):
                return t
        return FLOOR_TIER

    # -- queries ----------------------------------------------------------

    def active(self, tier: str) -> bool:
        """Is ``tier`` admissible now (not demoted, or past its
        cool-down for a half-open trial)?"""
        with self._mtx:
            return self._active_locked(tier)

    def admissible(self, tiers: list[str]) -> list[str]:
        """The admissible tiers of an eligibility list, in ladder order;
        registers them as known (the current-tier gauge tracks the best
        tier this process could run)."""
        with self._mtx:
            refresh = not self._gauge_set or any(t not in self._known for t in tiers)
            self._known.update(tiers)
            out = [t for t in tiers if self._active_locked(t)]
        if refresh:
            self._set_current_gauge()
        return out

    def current_tier(self) -> str:
        with self._mtx:
            return self._current_locked()

    # -- cost routing -----------------------------------------------------

    def ensure_seeded(self) -> None:
        """Seed the cost model from the perf ledger once, at the first
        routing consult (importing this module reads no file).  The
        ledger is read outside the lock.  A missing ledger, or one that
        is not JSON, seeds nothing (``health.perf_ledger_tail``); a row
        of the wrong shape raises to the caller, where the reference
        logs it and runs unseeded."""
        if self._cost.seeded or not self._cost.enabled:
            return
        from cometbft_tpu_torch.crypto.health import measured_tier_throughput

        measured = measured_tier_throughput()
        with self._mtx:
            n = self._cost.seed_locked(measured)
        if n:
            _log.info("cost model seeded from the perf ledger: %d estimates", n)

    def route(self, admissible: list[str], batch: int, add_host: bool = True) -> list[str]:
        """One batch's walk: the admissible tiers plus the host rung,
        ordered by predicted wall time for the batch's shape bucket.  The
        caller appends the floor.  Counts ``crypto_dispatch_route`` for
        the first tier and ``crypto_route_reorders_total`` when a new
        order is adopted."""
        candidates = list(admissible)
        if add_host and "host" not in candidates:
            candidates.append("host")
        if not candidates:
            return []
        bucket = shape_bucket(batch)
        self.ensure_seeded()
        with self._mtx:
            order, reordered, source = self._cost.order_locked(candidates, bucket,
                                                               self._clock())
        cm = _crypto_metrics()
        if reordered:
            cm.route_reorders_total.labels(bucket=str(bucket)).inc()
            FLIGHT.record("crypto/route_reorder", bucket=bucket, order=list(order))
            _log.info("cost model reordered the dispatch walk: bucket=%d order=%s static=%s",
                      bucket, list(order), candidates)
        cm.dispatch_route.child(order[0], str(bucket), source).inc()
        return list(order)

    def note_route(self, tier: str, batch: int, source: str = "static") -> None:
        """Route accounting for a plan that never reaches ``route()``
        (the host-only branch): every plan is counted exactly once."""
        _crypto_metrics().dispatch_route.labels(
            tier=tier, bucket=str(shape_bucket(batch)), source=source).inc()

    def router_prefers(self, faster: str, preferred: str, bucket: int | None) -> bool:
        """Does the cost model, for ``bucket``, rank ``faster`` above
        ``preferred`` in a full walk (every tier with a participating
        estimate there, plus the pair)?  The ``resolved_by_router`` flag
        of ``debug_dispatch_payload``'s contradictions: a pure read, no
        metrics, no order adopted."""
        if bucket is None or not self._cost.enabled:
            return False
        if FLOOR_TIER in (faster, preferred):
            return False  # the floor is never part of the permutation
        self.ensure_seeded()
        with self._mtx:
            candidates = [t for t in TIER_ORDER if t != FLOOR_TIER and (
                t in (faster, preferred)
                or self._cost._participating_locked(t, int(bucket)) is not None)]
            order = self._cost.desired_locked(candidates, int(bucket))
        return order.index(faster) < order.index(preferred)

    def cost_snapshot(self) -> dict:
        self.ensure_seeded()
        with self._mtx:
            return self._cost.snapshot_locked(self._clock())

    # -- evidence ---------------------------------------------------------

    def note_batch(self, tier: str, batch: int = 0, seconds: float | None = None) -> None:
        """The one per-batch accounting point: the tier that answered,
        with the batch's shape and wall for the cost model; a success on
        a tier re-admitted for a trial promotes it."""
        _crypto_metrics().dispatch_tier.child(tier).inc()
        promote = False
        with self._mtx:
            refresh = not self._gauge_set or tier not in self._known
            self._known.add(tier)
            self._cost.observe_locked(tier, batch, seconds)
            st = self._st(tier)
            st["fail_streak"] = 0
            if st["demoted"] and self._clock() >= st["cooldown_until"]:
                # only a half-open trial admits a batch onto a demoted
                # tier after its cool-down; a launch already in flight
                # when the tier was demoted lands here inside the
                # cool-down, and its success must not cancel the demotion
                promote = True
        if promote:
            self._promote(tier, reason="trial_success")
        elif refresh:
            self._set_current_gauge()

    def tier_fault(self, tier: str, reason: str, batch: int = 0,
                   duplicate: bool = False) -> None:
        """A run-time failure on ``tier``: demote it now with an
        exponential cool-down.  No-op for the python floor.
        ``duplicate`` marks evidence of an offence already demoted (the
        launch's watchdog fired before its exception got here)."""
        if tier == FLOOR_TIER:
            return
        now = self._clock()
        with self._mtx:
            self._known.add(tier)
            st = self._st(tier)
            was_demoted = st["demoted"]
            # a fault on a tier still cooling down is more evidence of
            # the same offence: recorded, but the back-off advances once
            dup = duplicate or (was_demoted and now < st["cooldown_until"])
            st["demoted"] = True
            st["ok_streak"] = 0
            st["last_reason"] = reason
            if dup:
                cooldown = max(st["cooldown_until"] - now, 0.0)
            else:
                st["cooldown_until"] = now + st["next_cooldown_s"]
                cooldown = st["next_cooldown_s"]
                st["next_cooldown_s"] = min(st["next_cooldown_s"] * 2, self.cooldown_max_s)
            st["demotions"] += 1
            to = self._next_active_below_locked(tier)
        self._emit("demote", tier, to, reason, cooldown_s=cooldown, batch=batch,
                   redemoted=was_demoted)

    def watchdog_fault(self, tier: str) -> None:
        """A launch watchdog overrun on ``tier`` (crypto/health.py):
        demote now, before the stalled call returns."""
        if tier in TIER_ORDER and tier != FLOOR_TIER:
            self.tier_fault(tier, reason="watchdog")

    def note_probe(self, tier: str, ok: bool) -> None:
        """Canary evidence: ``demote_after`` consecutive failures demote;
        ``promote_after`` consecutive successes (after the cool-down)
        promote a demoted tier."""
        if tier not in TIER_ORDER or tier == FLOOR_TIER:
            return
        demote = promote = False
        now = self._clock()
        with self._mtx:
            self._known.add(tier)
            st = self._st(tier)
            if ok:
                st["fail_streak"] = 0
                if st["demoted"]:
                    st["ok_streak"] += 1
                    if st["ok_streak"] >= self.promote_after and now >= st["cooldown_until"]:
                        promote = True
            else:
                st["ok_streak"] = 0
                if not st["demoted"]:
                    st["fail_streak"] += 1
                    if st["fail_streak"] >= self.demote_after:
                        demote = True
                elif now >= st["cooldown_until"]:
                    # a failing canary past the cool-down spends the
                    # half-open trial: the tier closes again
                    demote = True
        if demote:
            self.tier_fault(tier, reason="probe_failures")
        elif promote:
            self._promote(tier, reason="probes")

    # -- transitions ------------------------------------------------------

    def _promote(self, tier: str, reason: str) -> None:
        with self._mtx:
            st = self._st(tier)
            if not st["demoted"]:
                return
            st["demoted"] = False
            st["fail_streak"] = 0
            st["ok_streak"] = 0
            st["promotions"] += 1
            st["last_reason"] = reason
            # next_cooldown_s stays raised: a tier that faults again soon
            # pays the doubled cool-down
            to = self._current_locked()
        _crypto_metrics().dispatch_promotions_total.labels(tier=tier).inc()
        self._emit("promote", tier, to, reason)

    def _emit(self, kind: str, frm: str, to: str, reason: str, **fields) -> None:
        event = {"kind": kind, "from": frm, "to": to, "reason": reason, "at": time.time()}
        event.update(fields)
        with self._mtx:
            self._transitions.append(event)
        if kind == "demote":
            _crypto_metrics().dispatch_demotions_total.labels(
                **{"from": frm, "to": to, "reason": reason}).inc()
        FLIGHT.record("crypto/dispatch_transition", transition=kind, tier=frm, to=to,
                      reason=reason)
        (_log.error if kind == "demote" else _log.info)(
            "dispatch ladder %s: tier=%s to=%s reason=%s %s", kind, frm, to, reason, fields)
        self._set_current_gauge()

    def _set_current_gauge(self) -> None:
        with self._mtx:
            current = self._current_locked()
            self._gauge_set = True
        gauge = _crypto_metrics().dispatch_current_tier
        for tier in TIER_ORDER:
            gauge.labels(tier=tier).set(1.0 if tier == current else 0.0)

    # -- introspection ----------------------------------------------------

    def snapshot(self) -> dict:
        now = self._clock()
        with self._mtx:
            tiers = {}
            for tier in TIER_ORDER:
                st = self._state.get(tier)
                if st is None:
                    tiers[tier] = {"known": tier in self._known, "demoted": False}
                    continue
                tiers[tier] = {
                    "known": tier in self._known,
                    "demoted": st["demoted"],
                    "fail_streak": st["fail_streak"],
                    "ok_streak": st["ok_streak"],
                    "cooldown_remaining_s": round(max(st["cooldown_until"] - now, 0.0), 3),
                    "next_cooldown_s": st["next_cooldown_s"],
                    "demotions": st["demotions"],
                    "promotions": st["promotions"],
                    "last_reason": st["last_reason"],
                }
            return {
                "order": list(TIER_ORDER),
                "current": self._current_locked(),
                "policy": {
                    "demote_after": self.demote_after,
                    "promote_after": self.promote_after,
                    "cooldown_s": self.cooldown_s,
                    "cooldown_max_s": self.cooldown_max_s,
                },
                "tiers": tiers,
                "transitions": list(self._transitions),
            }

    def reset(self, demote_after: int = DEFAULT_DEMOTE_AFTER,
              promote_after: int = DEFAULT_PROMOTE_AFTER,
              cooldown_s: float = DEFAULT_COOLDOWN_S,
              cooldown_max_s: float = DEFAULT_COOLDOWN_MAX_S, clock=time.monotonic,
              cost_model: TierCostModel | None = None) -> None:
        """Wipe all tier state and the cost model, and take a new policy
        (the reference's defaults unless given)."""
        with self._mtx:
            self._configure(demote_after, promote_after, cooldown_s, cooldown_max_s, clock,
                            cost_model)


#: process-wide singletons: every verifier and the watchdog feed and
#: consult the same ladder
LADDER = DispatchLadder()
CHAOS = Chaos()


def reset_for_tests(ledger: bool = False) -> None:
    """Wipe the ladder's state (default policy) and disarm chaos.  The
    cost model is marked seeded unless ``ledger``: a test's routes never
    read the perf ledger a card run left in the checkout, and a test
    that seeds names its own file (``health.PERF_LEDGER``)."""
    LADDER.reset()
    LADDER._cost.seeded = not ledger
    CHAOS.load(None)


# -- the debug payload -----------------------------------------------------


def _contradiction_bucket(measured: dict, lo: str, hi: str) -> int | None:
    """The shape bucket a contradiction was measured at: the faster
    tier's latest row's bucket, else the preferred tier's; None when
    neither row named a batch size."""
    for tier in (lo, hi):
        bucket = measured.get(tier, {}).get("bucket")
        if bucket is not None:
            return bucket
    return None


def debug_dispatch_payload() -> dict:
    """The ladder (order, per-tier state, transitions), the chaos plan,
    the live cost table and the perf ledger's latest measured sigs/s per
    tier, with an order contradiction wherever a tier the ladder prefers
    measured slower than one below it; each carries
    ``resolved_by_router``: True when the cost model ranks the pair the
    measured way for that shape."""
    from cometbft_tpu_torch.crypto.health import measured_tier_throughput

    measured = measured_tier_throughput()
    contradictions = []
    for i, hi in enumerate(TIER_ORDER):
        if measured.get(hi, {}).get("sigs_per_sec") is None:
            continue
        for lo in TIER_ORDER[i + 1:]:
            if measured.get(lo, {}).get("sigs_per_sec") is None:
                continue
            hi_v = measured[hi]["sigs_per_sec"]
            lo_v = measured[lo]["sigs_per_sec"]
            if lo_v > hi_v:
                bucket = _contradiction_bucket(measured, lo, hi)
                contradictions.append({
                    "preferred": hi,
                    "preferred_sigs_per_sec": hi_v,
                    "faster": lo,
                    "faster_sigs_per_sec": lo_v,
                    "bucket": bucket,
                    "resolved_by_router": LADDER.router_prefers(lo, hi, bucket),
                })
    return {
        "ladder": LADDER.snapshot(),
        "chaos": CHAOS.snapshot(),
        "cost_model": LADDER.cost_snapshot(),
        "measured_tier_throughput": measured,
        "order_contradictions": contradictions,
    }

