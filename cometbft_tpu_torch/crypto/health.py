"""The device-health plane: the launch watchdog, busy/idle and overlap
accounting, the canary prober and the perf ledger (a copy of
cometbft_tpu/crypto/health.py).

- **LaunchWatchdog** bounds every device launch at the
  ``TorchBatchVerifier`` execute seam.  A launch that outlives its
  budget (a constructor argument, default 240 s) counts in
  ``crypto_device_hangs_total``, is recorded as a ``crypto/device_hang``
  flight event and demotes its tier on the dispatch ladder at once.
  The stalled call itself cannot be interrupted (the hang lives in the
  CUDA runtime); the watchdog turns a silent stall into a signal, and logs
  the recovery if the launch ever returns.  Its one daemon thread
  starts at the first launch and sleeps until the nearest deadline, or
  for one budget when no launch is armed; arming a launch wakes it
  only when the new deadline falls before that wake-up, so a steady
  stream of launches never wakes it (a woken thread takes the GIL from
  the launching one at its next release, in the middle of a launch).
  While the thread runs, arming takes no lock.
- **DeviceUsage** accounts busy and idle time between launches
  (``crypto_device_busy_seconds_total`` / ``..._idle_...``) over each
  launch's wall, which ends at the verdicts' copy to the host, the
  wait between a batch's plan and its launch
  (``crypto_launch_queue_wait_seconds``), and the share of a launch's
  wall the host did not spend blocked in the verdicts' fetch
  (``timed_fetch``; ``crypto_host_device_overlap_ratio``).
- **HealthProber** (a ``BaseService``) runs a canary verify against
  each available tier every ``interval_s`` seconds, each in a worker
  thread bounded by a timeout, and feeds ``crypto_tier_probe_seconds``,
  ``crypto_tier_healthy`` and the dispatch ladder's ``note_probe``:
  ``demote_after`` failed canaries demote a tier, ``promote_after``
  healthy ones (past its cool-down) promote it.  A failed canary is a
  typed tier fault (a chaos fault among them), a wrong verdict or a
  timeout.  Any other exception is a fault of the port, not evidence
  about a tier: it is recorded and logged, the ladder is told nothing,
  and ``probe_once`` re-raises it after the round.  Each canary is
  pinned to its own tier (``default_tier_probes``); the device
  canaries exist only once CUDA is initialised in the process, so the
  prober thread never initialises it.  Canaries call the array
  functions, not ``execute``: they give the cost model no sample.
- **The perf ledger** (``perf_ledger_path``: ``build/perf_ledger.json``
  beside the package, the reference's ``{"entries": [...]}`` schema)
  holds the rows ``chip_smoke.py`` measured on this machine's card;
  ``measured_tier_throughput`` turns its single-batch rows into the
  per-(tier, bucket) table the cost model is seeded from.  The
  reference's ledger (``docs/data/perf_ledger.json``, TPU and CPU
  rounds) is never read.  ``debug_perf_payload`` gathers the health
  plane's state.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import re
import threading
import time

from cometbft_tpu_torch.metrics import health_metrics as _health_metrics
from cometbft_tpu_torch.utils.flight import FLIGHT
from cometbft_tpu_torch.utils.service import BaseService
from cometbft_tpu_torch.utils import sync as cmtsync

DEFAULT_LAUNCH_BUDGET_S = 240.0
DEFAULT_HEALTH_INTERVAL_S = 60.0

#: the port's perf ledger: rows measured on this machine's card
PERF_LEDGER = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "perf_ledger.json",
)

_log = logging.getLogger("cometbft_tpu_torch.crypto.health")


class LaunchWatchdog:
    """Bounds device launches: one shared daemon thread tracks every
    armed launch's deadline; an overrun is counted, flight-recorded and
    demotes its tier.  The execute seam's API::

        token = WATCHDOG.arm("keyed", batch=n)
        try:
            out = run_keyed(...)
        finally:
            fired = WATCHDOG.disarm(token)

    ``budget_s`` may be changed between launches."""

    def __init__(self, budget_s: float = DEFAULT_LAUNCH_BUDGET_S):
        self.budget_s = budget_s
        self._mtx = cmtsync.Mutex()
        self._wake = threading.Event()
        # token -> {t0, deadline, tier, batch, fired}: ``arm`` inserts
        # without the lock (one dict store, atomic under the GIL); pops,
        # reads and the ``fired`` marks are under _mtx
        self._active: dict[int, dict] = {}
        self._tokens = itertools.count(1)
        self._thread: threading.Thread | None = None
        self._stop = False
        # guarded by _mtx: when the thread's current wait ends
        self._sleep_until = float("inf")

    def arm(self, tier: str, batch: int = 0) -> int:
        t0 = time.monotonic()
        deadline = t0 + self.budget_s
        token = next(self._tokens)
        self._active[token] = {"t0": t0, "deadline": deadline, "tier": tier,
                               "batch": batch, "fired": False}
        thread = self._thread
        if thread is not None and thread.is_alive() and deadline >= self._sleep_until:
            return token  # the thread wakes before this deadline anyway
        with self._mtx:
            wake = deadline < self._sleep_until
            if self._thread is None or not self._thread.is_alive():
                self._stop = False
                self._sleep_until = float("inf")
                self._thread = threading.Thread(target=self._loop, name="crypto-watchdog",
                                                daemon=True)
                self._thread.start()
        if wake:
            self._wake.set()
        return token

    def disarm(self, token: int) -> bool:
        """True when the watchdog had already fired for this launch (it
        recovered after being declared hung)."""
        with self._mtx:
            entry = self._active.pop(token, None)
        if entry is None:
            return False
        if entry["fired"]:
            stalled = round(time.monotonic() - entry["t0"], 3)
            FLIGHT.record("crypto/device_hang_recovered", tier=entry["tier"],
                          batch=entry["batch"], stalled_s=stalled)
            _log.error("device launch recovered after a watchdog trip: tier=%s stalled_s=%s",
                       entry["tier"], stalled)
        return entry["fired"]

    def _loop(self) -> None:
        while True:
            with self._mtx:
                if self._stop:
                    return
                pending = [e["deadline"] for e in list(self._active.values())
                           if not e["fired"]]
                now = time.monotonic()
                self._sleep_until = min(pending) if pending else now + self.budget_s
                timeout = max(self._sleep_until - now, 0.0)
            self._wake.wait(timeout)
            self._wake.clear()
            now = time.monotonic()
            expired: list[dict] = []
            with self._mtx:
                if self._stop:
                    return
                for entry in list(self._active.values()):
                    if not entry["fired"] and entry["deadline"] <= now:
                        entry["fired"] = True
                        expired.append(dict(entry))
            for entry in expired:  # record outside the lock
                elapsed = round(now - entry["t0"], 3)
                _health_metrics().device_hangs_total.inc()
                FLIGHT.record("crypto/device_hang", tier=entry["tier"], batch=entry["batch"],
                              elapsed_s=elapsed,
                              budget_s=round(entry["deadline"] - entry["t0"], 3))
                _log.error("device launch exceeded the watchdog's budget: tier=%s batch=%d "
                           "elapsed_s=%s", entry["tier"], entry["batch"], elapsed)
                # the overrun demotes the wedged tier now, before the
                # stalled call returns
                from cometbft_tpu_torch.crypto import dispatch as _dispatch

                try:
                    _dispatch.LADDER.watchdog_fault(entry["tier"])
                except Exception:  # noqa: BLE001 -- the watchdog thread must survive
                    _log.exception("watchdog demotion failed")

    def stop(self) -> None:
        """Stop the shared thread (a later arm starts a new one)."""
        with self._mtx:
            self._stop = True
            thread = self._thread
        self._wake.set()
        if thread is not None:
            thread.join(timeout=5)
        with self._mtx:
            self._thread = None
            self._sleep_until = float("inf")

    def snapshot(self) -> dict:
        with self._mtx:
            active = [{"tier": e["tier"], "batch": e["batch"],
                       "elapsed_s": round(time.monotonic() - e["t0"], 3), "fired": e["fired"]}
                      for e in list(self._active.values())]
        return {"budget_s": self.budget_s, "active_launches": active}


class _TimedFetch:
    """``DeviceUsage.timed_fetch``'s context manager: adds the block's
    seconds to this thread's fetch-wait total."""

    __slots__ = ("_tl", "_t0")

    def __init__(self, tl: threading.local) -> None:
        self._tl = tl

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._tl.fetch = getattr(self._tl, "fetch", 0.0) + time.perf_counter() - self._t0
        return False


class DeviceUsage:
    """Busy/idle accounting between launches, the queue-wait instrument
    and the fetch-wait total the overlap ratio comes from: a few float
    operations under one lock per launch.  The fetch-wait total is per
    thread, so concurrent verifiers do not charge each other's fetches."""

    def __init__(self):
        self._mtx = cmtsync.Mutex()
        self._tl = threading.local()
        # guarded by _mtx: the high-water mark of wall time already
        # counted busy -- concurrent launches count the UNION of their
        # intervals, so busy + idle never exceeds the wall
        self._covered_until: float | None = None
        self._busy: dict[str, float] = {}
        self._idle: dict[str, float] = {}
        self._launches = 0
        self._last_overlap: float | None = None
        self._last_queue_wait: float | None = None
        self._last_fetch_wait: float | None = None

    def timed_fetch(self) -> _TimedFetch:
        """Wraps a blocking fetch of verdicts: its seconds count as this
        thread's fetch wait."""
        return _TimedFetch(self._tl)

    def fetch_wait(self) -> float:
        """This thread's accumulated blocking-fetch seconds."""
        return getattr(self._tl, "fetch", 0.0)

    def note_queue_wait(self, seconds: float) -> None:
        _health_metrics().launch_queue_wait_seconds.observe(seconds)
        self._last_queue_wait = seconds

    def launch_end(self, t_launch: float, ndev: int = 1, fetch_wait: float = 0.0) -> None:
        """Account one finished launch on each of ``ndev`` devices (the
        shards of a mesh launch, labelled "0" .. ndev-1): busy = the part
        of [t_launch, now) not yet counted; idle = the gap before it;
        overlap = the share of the launch's wall the host did not spend
        blocked in the fetch (``fetch_wait`` seconds of it)."""
        now = time.perf_counter()
        wall = max(now - t_launch, 0.0)
        overlap = min(max(1.0 - fetch_wait / wall, 0.0), 1.0) if wall > 0 else None
        devices = [str(d) for d in range(max(ndev, 1))]
        with self._mtx:
            prev = self._covered_until
            idle = 0.0
            if prev is None:
                busy = max(now - t_launch, 0.0)
            else:
                idle = max(t_launch - prev, 0.0)
                busy = max(now - max(t_launch, prev), 0.0)
            self._covered_until = max(prev or now, now)
            self._launches += 1
            for dev in devices:
                self._busy[dev] = self._busy.get(dev, 0.0) + busy
                if idle:
                    self._idle[dev] = self._idle.get(dev, 0.0) + idle
            if overlap is not None:
                self._last_overlap = overlap
            self._last_fetch_wait = fetch_wait
        hm = _health_metrics()
        for dev in devices:
            hm.device_busy_seconds_total.child(dev).inc(busy)
            if idle:
                hm.device_idle_seconds_total.child(dev).inc(idle)
        if overlap is not None:
            hm.host_device_overlap_ratio.set(overlap)

    def snapshot(self) -> dict:
        """``busy_seconds`` / ``idle_seconds`` are the sums over devices
        (device "0" alone outside a mesh); ``by_device`` has each one's."""
        with self._mtx:
            busy, idle = sum(self._busy.values()), sum(self._idle.values())
            total = busy + idle
            return {
                "launches": self._launches,
                "busy_seconds": round(busy, 6),
                "idle_seconds": round(idle, 6),
                "by_device": {d: {"busy_seconds": round(self._busy.get(d, 0.0), 6),
                                  "idle_seconds": round(self._idle.get(d, 0.0), 6)}
                              for d in sorted(set(self._busy) | set(self._idle))},
                "occupancy": round(busy / total, 4) if total > 0 else None,
                "overlap_ratio": self._last_overlap,
                "last_queue_wait_s": self._last_queue_wait,
                "last_fetch_wait_s": self._last_fetch_wait,
            }


class HealthProber(BaseService):
    """Background canary prober over the available dispatch tiers
    (module docstring).

    ``tiers`` maps tier name -> zero-argument callable returning truthy
    on a correct verify; None takes :func:`default_tier_probes` anew at
    every round (device tiers appear once CUDA is initialised).  The
    first round runs one full interval after start.  A canary runs in a
    worker thread; one still running after ``probe_timeout_s`` (the
    watchdog's budget unless given) is abandoned and reported hung, and
    while it lives its tier fails at once instead of stacking workers."""

    def __init__(self, interval_s: float = DEFAULT_HEALTH_INTERVAL_S, tiers: dict | None = None,
                 logger: logging.Logger | None = None,
                 watchdog: LaunchWatchdog | None = None,
                 probe_timeout_s: float | None = None):
        super().__init__(name="health-prober",
                         logger=logger or logging.getLogger("cometbft_tpu_torch.crypto.health"))
        if interval_s <= 0:
            raise ValueError("HealthProber needs a positive interval")
        self.interval_s = interval_s
        self._tiers = tiers
        self._watchdog = watchdog if watchdog is not None else WATCHDOG
        self._probe_timeout = probe_timeout_s
        self._state_mtx = cmtsync.Mutex()
        self._state: dict[str, dict] = {}      # guarded by _state_mtx
        self.probes_total = 0                   # guarded by _state_mtx
        #: tier -> a canary worker still running past its timeout
        self._inflight: dict[str, threading.Thread] = {}
        #: the last untyped exception a canary raised (a port fault)
        self.last_error: BaseException | None = None
        self._thread: threading.Thread | None = None

    @property
    def probe_timeout_s(self) -> float:
        """How long one canary may run before it is declared hung."""
        if self._probe_timeout is not None:
            return self._probe_timeout
        return self._watchdog.budget_s

    def on_start(self) -> None:
        global _ACTIVE_PROBER
        _ACTIVE_PROBER = self
        self._thread = threading.Thread(target=self._loop, name="health-prober", daemon=True)
        self._thread.start()

    def on_stop(self) -> None:
        global _ACTIVE_PROBER
        if _ACTIVE_PROBER is self:
            _ACTIVE_PROBER = None
        if self._thread is not None:
            self._thread.join(timeout=max(5.0, self.probe_timeout_s + 1.0))
            self._thread = None

    def _loop(self) -> None:
        # the quit event's wait is the schedule: one round per interval
        while not self.quit_event().wait(self.interval_s):
            try:
                self.probe_once()
            except Exception:  # noqa: BLE001 -- recorded in last_error; the loop goes on
                self.logger.exception("canary probe round raised")

    def _tier_probes(self) -> dict:
        if self._tiers is not None:
            return self._tiers
        return default_tier_probes()

    def _run_probe(self, tier: str, probe) -> tuple[bool, str | None, float,
                                                    BaseException | None]:
        """One canary in a worker thread bounded by the timeout -> (ok,
        error text, seconds, untyped exception or None)."""
        with self._state_mtx:
            prev = self._inflight.get(tier)
        if prev is not None and prev.is_alive():
            return False, "previous probe still hung", 0.0, None
        box: dict = {}

        def run() -> None:
            from cometbft_tpu_torch.crypto import dispatch as _disp

            t0 = time.perf_counter()
            try:
                # the chaos plan faults canaries as it faults batches;
                # the watchdog bounds them as it bounds launches
                _disp.CHAOS.inject(tier, probe=True)
                token = self._watchdog.arm(f"probe:{tier}")
                try:
                    box["ok"] = bool(probe())
                finally:
                    self._watchdog.disarm(token)
            except (_disp.TierFault, _disp.TierUnavailable) as exc:
                box["err"] = f"{type(exc).__name__}: {exc}"
            except Exception as exc:  # noqa: BLE001 -- handed to probe_once
                box["err"] = f"{type(exc).__name__}: {exc}"
                box["exc"] = exc
            box["dt"] = time.perf_counter() - t0

        worker = threading.Thread(target=run, name=f"probe-{tier}", daemon=True)
        t0 = time.perf_counter()
        worker.start()
        worker.join(self.probe_timeout_s)
        if worker.is_alive():
            with self._state_mtx:
                self._inflight[tier] = worker
            return (False, f"probe exceeded {self.probe_timeout_s:g}s timeout",
                    time.perf_counter() - t0, None)
        with self._state_mtx:
            self._inflight.pop(tier, None)
        return (box.get("ok", False), box.get("err"), box.get("dt", time.perf_counter() - t0),
                box.get("exc"))

    def probe_once(self) -> dict[str, bool]:
        """One canary round over every available tier -> tier ->
        healthy.  An untyped exception of a canary is recorded, tells the
        ladder nothing, and is re-raised once the round is done."""
        from cometbft_tpu_torch.crypto import dispatch as _disp

        hm = _health_metrics()
        results: dict[str, bool] = {}
        raised: BaseException | None = None
        for tier, probe in self._tier_probes().items():
            ok, err, dt, exc = self._run_probe(tier, probe)
            hm.tier_probe_seconds.labels(tier=tier).observe(dt)
            hm.tier_healthy.labels(tier=tier).set(1.0 if ok else 0.0)
            if exc is None:
                _disp.LADDER.note_probe(tier, ok)
            else:
                raised = raised or exc
                self.last_error = exc
            with self._state_mtx:
                prev = self._state.get(tier, {})
                self._state[tier] = {
                    "healthy": ok,
                    "last_probe_s": round(dt, 6),
                    "last_probe_at": time.time(),
                    "consecutive_failures": 0 if ok else prev.get("consecutive_failures", 0) + 1,
                    "error": err,
                }
                self.probes_total += 1
                was_healthy = prev.get("healthy")
            if not ok:
                hm.tier_probe_failures_total.labels(tier=tier).inc()
                FLIGHT.record("crypto/tier_unhealthy", tier=tier, probe_s=round(dt, 3),
                              err=err or "mis-verified")
                self.logger.error("dispatch tier failed its canary probe: tier=%s probe_s=%.3f "
                                  "err=%s", tier, dt, err or "mis-verified")
            elif was_healthy is False:
                FLIGHT.record("crypto/tier_recovered", tier=tier, probe_s=round(dt, 3))
                self.logger.info("dispatch tier recovered: tier=%s", tier)
            results[tier] = ok
        if raised is not None:
            raise raised
        return results

    def snapshot(self) -> dict:
        with self._state_mtx:
            return {
                "interval_s": self.interval_s,
                "probe_timeout_s": self.probe_timeout_s,
                "probes_total": self.probes_total,
                "hung_probes": sorted(t for t, w in self._inflight.items() if w.is_alive()),
                "tiers": {t: dict(st) for t, st in self._state.items()},
                "last_error": repr(self.last_error) if self.last_error is not None else None,
            }


#: the running prober (set by HealthProber.on_start), for debug_perf_payload
_ACTIVE_PROBER: HealthProber | None = None
_CANARY = None


def _canary_fixture():
    """Two signed messages, made once per process (signing on the
    oracle takes milliseconds)."""
    global _CANARY
    if _CANARY is None:
        from cometbft_tpu_torch.crypto import ed25519 as ed

        privs = [ed.priv_key_from_secret(b"health-canary-%d" % i) for i in range(2)]
        msgs = [b"health canary %d" % i for i in range(2)]
        _CANARY = [(p.pub_key(), m, p.sign(m)) for p, m in zip(privs, msgs)]
    return _CANARY


def default_tier_probes() -> dict:
    """tier -> canary for every tier available now: the host tier
    always; keyed and generic only once CUDA is initialised in this
    process (the prober must never be the thread that initialises it);
    keyed_mesh and generic_mesh too when more than one card is visible."""
    import torch

    probes: dict = {"host": _probe_host}
    if torch.cuda.is_initialized():
        probes["generic"] = _probe_generic
        probes["keyed"] = _probe_keyed
        if torch.cuda.device_count() > 1:
            probes["keyed_mesh"] = _probe_keyed_mesh
            probes["generic_mesh"] = _probe_generic_mesh
    return probes


def _probe_host() -> bool:
    from cometbft_tpu_torch.crypto import ed25519 as ed

    bv = ed.CpuBatchVerifier()
    for pub, msg, sig in _canary_fixture():
        bv.add(pub, msg, sig)
    ok, bits = bv.verify()
    return ok and all(bits)


def _probe_arrays():
    """The canary's 8 lanes: the fixture four times."""
    import numpy as np

    fixture = _canary_fixture()
    pub = np.stack([np.frombuffer(p.bytes(), dtype=np.uint8) for p, _, _ in fixture] * 4)
    sig = np.stack([np.frombuffer(s, dtype=np.uint8) for _, _, s in fixture] * 4)
    msgs = [m for _, m, _ in fixture] * 4
    return pub, sig, msgs


def _probe_device():
    import torch

    return torch.device("cuda", torch.cuda.current_device())


def _probe_generic() -> bool:
    """Generic-tier canary, pinned to ``verify_arrays``."""
    from cometbft_tpu_torch.ops.ed25519_verify import verify_arrays

    pub, sig, msgs = _probe_arrays()
    return bool(verify_arrays(pub, sig, msgs, _probe_device()).all())


def _probe_keyed() -> bool:
    """Keyed-tier canary, pinned to ``verify_arrays_keyed_async`` and
    ``_finish`` on the canary's own 2-key table entry (built once).  A
    set the table policy declines (TABLE_MAX_KEYS below 2) reports the
    generic path's health, as the reference's does."""
    from cometbft_tpu_torch.ops import precompute as PR
    from cometbft_tpu_torch.ops.ed25519_verify import _finish, verify_arrays_keyed_async

    pub, sig, msgs = _probe_arrays()
    pubs_b = [p.bytes() for p, _, _ in _canary_fixture()]
    entry = PR.table_cache(_probe_device()).lookup_or_build(pubs_b)
    if entry is None:
        return _probe_generic()
    key_ids = entry.key_ids([bytes(p) for p in pub])
    return bool(_finish(verify_arrays_keyed_async(entry, key_ids, pub, sig, msgs)).all())


def _probe_keyed_mesh(mesh=None) -> bool:
    """Mesh canary pinned to the keyed_mesh runner (``mesh``: every
    visible card unless given): a canary exercises its own tier, never a
    walk down the ladder, whose fallback's health would read as evidence
    for the tier it stands in for.  A mesh of one device, or a set the
    table policy declines, reports the single-device canary's health,
    as the reference's does."""
    from cometbft_tpu_torch.ops import precompute as PR
    from cometbft_tpu_torch.parallel.mesh import ShardedTorchBatchVerifier

    bv = ShardedTorchBatchVerifier(mesh=mesh, device_min_batch=0)
    if not bv._mesh_capable():
        return _probe_keyed()
    pub, sig, msgs = _probe_arrays()
    entry = PR.table_cache(bv.device).lookup_or_build([p.bytes() for p, _, _ in _canary_fixture()])
    if entry is None:
        return _probe_generic_mesh(mesh)
    key_ids = entry.key_ids([bytes(p) for p in pub])
    return bool(bv._run_keyed_mesh(entry, key_ids, pub, sig, msgs).all())


def _probe_generic_mesh(mesh=None) -> bool:
    """Mesh canary pinned to the generic_mesh runner, for the same
    reason as the keyed_mesh canary."""
    from cometbft_tpu_torch.parallel.mesh import ShardedTorchBatchVerifier

    bv = ShardedTorchBatchVerifier(mesh=mesh, device_min_batch=0)
    pub, sig, msgs = _probe_arrays()
    return bool(bv._run_generic_mesh(pub, sig, msgs).all())


#: process-wide instruments, like the ladder they feed
WATCHDOG = LaunchWatchdog()
USAGE = DeviceUsage()


# -- the perf ledger and the debug payload ----------------------------------


def perf_ledger_path() -> str:
    """The port's perf ledger (``PERF_LEDGER``)."""
    return PERF_LEDGER


def perf_ledger_tail(n: int = 10) -> list[dict]:
    """The last ``n`` ledger entries (0: all); empty when there is no
    ledger or it is not JSON."""
    try:
        with open(perf_ledger_path()) as f:
            doc = json.load(f)
        entries = doc.get("entries", [])
        return entries[-n:] if n else entries
    except (OSError, ValueError):
        return []


def append_perf_ledger(entries: list[dict]) -> str:
    """Append rows to the ledger (made if missing; written to a
    temporary file, then renamed) -> its path."""
    path = perf_ledger_path()
    doc = {"entries": perf_ledger_tail(0) + list(entries)}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
    os.replace(tmp, path)
    return path


#: a batch size from a config name, for rows without a ``batch`` field:
#: "<n>sig"/"<n>val" tokens and the verify_commit_<n> family
_SHAPE_TOKEN_RE = re.compile(r"(?:^|[_-])(\d+)(?:sig|val)s?(?=$|[_-])")
_VERIFY_COMMIT_RE = re.compile(r"^verify_commit_(\d+)(?:$|_)")


def _entry_batch(e: dict) -> int | None:
    """The batch size a ledger row measured (its ``batch``/``nval``
    field or a parseable config name), or None."""
    for field in ("batch", "nval"):
        v = e.get(field)
        if isinstance(v, (int, float)) and v >= 1:
            return int(v)
    cfg = e.get("config") or ""
    m = _SHAPE_TOKEN_RE.search(cfg) or _VERIFY_COMMIT_RE.match(cfg)
    if m:
        return int(m.group(1))
    return None


#: config families that measure single-batch tier throughput, the only
#: rows a routing seed may use when a row carries no ``route_seed``
_SEEDABLE_CONFIG_RE = re.compile(
    r"^(micro_|verify_commit_|verify_queue_sync$|keyed_mesh_|bls_aggregate_)")


def _route_seedable(e: dict) -> bool:
    """May this row seed a (tier, bucket) estimate?  An explicit
    ``route_seed`` decides; otherwise the config allowlist above."""
    flag = e.get("route_seed")
    if flag is not None:
        return bool(flag)
    return bool(_SEEDABLE_CONFIG_RE.match(e.get("config") or ""))


def _entry_throughput(e: dict) -> float | None:
    """A row's sigs/s: its value on a sigs/sec row, else its
    ``sigs_per_sec`` field; None without a positive rate."""
    if e.get("unit") == "sigs/sec":
        v = e.get("value")
    else:
        v = e.get("sigs_per_sec")
    if isinstance(v, (int, float)) and v > 0:
        return float(v)
    return None


def measured_tier_throughput() -> dict[str, dict]:
    """The latest measured sigs/s per dispatch tier from the ledger (a
    later row wins; zero values are skipped), with ``buckets``: the
    latest single-batch row (``_route_seedable``) per (tier, pow2
    bucket) among rows that name a batch size -- the view
    ``dispatch.TierCostModel`` is seeded from.  A row without a batch
    size stays a tier-level fact only."""
    from cometbft_tpu_torch.crypto.dispatch import shape_bucket

    out: dict[str, dict] = {}
    for e in perf_ledger_tail(0):
        tier = e.get("dispatch_tier")
        if not tier:
            continue
        prev = out.get(tier)
        buckets = prev.get("buckets", {}) if prev else {}
        rate = _entry_throughput(e)
        batch = _entry_batch(e)
        bucket = shape_bucket(batch) if batch is not None else None
        if rate is not None and bucket is not None and _route_seedable(e):
            buckets[bucket] = {
                "sigs_per_sec": rate,
                "batch": batch,
                "config": e.get("config"),
                "source": e.get("source"),
                "measured": e.get("measured"),
            }
        val = e.get("value")
        if e.get("unit") != "sigs/sec" or not isinstance(val, (int, float)) or val <= 0:
            # not a tier-level point; keep its bucket on the tier's entry
            if prev is not None:
                prev["buckets"] = buckets
            elif buckets:
                out[tier] = {"buckets": buckets}
            continue
        entry = {
            "sigs_per_sec": val,
            "config": e.get("config"),
            "source": e.get("source"),
            "measured": e.get("measured"),
            "buckets": buckets,
        }
        if batch is not None:
            entry["batch"] = batch
            entry["bucket"] = bucket
        out[tier] = entry
    return out


def debug_perf_payload(ledger_tail_n: int = 10) -> dict:
    """The health plane's state: the device probe's status, the
    prober's tiers and last probes, the watchdog, utilization and the
    ledger's tail."""
    from cometbft_tpu_torch.crypto import batch as _batch

    prober = _ACTIVE_PROBER
    return {
        "device": _batch.device_status(),
        "prober": (prober.snapshot() if prober is not None
                   else {"running": False, "tiers": {}}),
        "watchdog": WATCHDOG.snapshot(),
        "utilization": USAGE.snapshot(),
        "ledger": {"path": perf_ledger_path(), "tail": perf_ledger_tail(ledger_tail_n)},
    }
