"""The device-health plane's launch instruments: the launch watchdog
and busy/idle accounting (a copy of cometbft_tpu/crypto/health.py's
``LaunchWatchdog`` and ``DeviceUsage``).

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
  launch's wall, which ends at the verdicts' copy to the host, and the
  wait between a batch's plan and its launch
  (``crypto_launch_queue_wait_seconds``).

The canary prober (the reference's ``HealthProber``) is a later slice.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time

from cometbft_tpu_torch.metrics import health_metrics as _health_metrics
from cometbft_tpu_torch.utils.flight import FLIGHT

DEFAULT_LAUNCH_BUDGET_S = 240.0

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
        self._mtx = threading.Lock()
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


class DeviceUsage:
    """Busy/idle accounting between launches and the queue-wait
    instrument: a few float operations under one lock per launch."""

    def __init__(self):
        self._mtx = threading.Lock()
        # guarded by _mtx: the high-water mark of wall time already
        # counted busy -- concurrent launches count the UNION of their
        # intervals, so busy + idle never exceeds the wall
        self._covered_until: float | None = None
        self._busy = 0.0
        self._idle = 0.0
        self._launches = 0

    def note_queue_wait(self, seconds: float) -> None:
        _health_metrics().launch_queue_wait_seconds.observe(seconds)

    def launch_end(self, t_launch: float) -> None:
        """Account one finished launch on the one device ("0"): busy = the
        part of [t_launch, now) not yet counted; idle = the gap before
        it."""
        now = time.perf_counter()
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
            self._busy += busy
            self._idle += idle
        hm = _health_metrics()
        hm.device_busy_seconds_total.child("0").inc(busy)
        if idle:
            hm.device_idle_seconds_total.child("0").inc(idle)

    def snapshot(self) -> dict:
        with self._mtx:
            total = self._busy + self._idle
            return {
                "launches": self._launches,
                "busy_seconds": round(self._busy, 6),
                "idle_seconds": round(self._idle, 6),
                "occupancy": round(self._busy / total, 4) if total > 0 else None,
            }


#: process-wide instruments, like the ladder they feed
WATCHDOG = LaunchWatchdog()
USAGE = DeviceUsage()
