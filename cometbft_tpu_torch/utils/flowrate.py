"""Flow-rate monitoring and limiting (a copy of
cometbft_tpu/utils/flowrate.py; reference: internal/flowrate).

Token-bucket style rate accounting used by the connection send/recv
routines: a sliding-window rate monitor with a blocking ``limit`` call
that sleeps in steps of at most 0.1 s.
"""

from __future__ import annotations

import threading
import time


class Monitor:
    """Sliding-EMA transfer-rate monitor (internal/flowrate/flowrate.go:13).

    Tracks bytes transferred and an exponentially-weighted rate sample.
    ``limit(want, rate)`` blocks until transferring ``want`` more bytes
    would not exceed ``rate`` bytes/sec, then returns the permitted count.
    """

    def __init__(self, sample_period: float = 0.1, window: float = 1.0):
        self._mtx = threading.Lock()
        self._sample_period = sample_period
        self._alpha = sample_period / max(window, sample_period)
        self.start = time.monotonic()
        self.bytes_total = 0
        self.rate_avg = 0.0  # EMA bytes/sec
        self.rate_peak = 0.0  # highest EMA sample seen
        self._sample_bytes = 0
        self._sample_start = self.start
        self._window = window
        self._credit = 0.0
        self._credit_time = self.start
        self.active = True

    def update(self, n: int) -> int:
        """Record ``n`` transferred bytes."""
        with self._mtx:
            self._advance_locked()
            self.bytes_total += n
            self._sample_bytes += n
            return n

    def _advance_locked(self) -> None:
        now = time.monotonic()
        elapsed = now - self._sample_start
        while elapsed >= self._sample_period:
            rate = self._sample_bytes / self._sample_period
            self.rate_avg += self._alpha * (rate - self.rate_avg)
            if self.rate_avg > self.rate_peak:
                self.rate_peak = self.rate_avg
            self._sample_bytes = 0
            self._sample_start += self._sample_period
            elapsed -= self._sample_period
            # after an idle gap the remaining windows all carry zero bytes;
            # fast-forward instead of looping unboundedly
            if elapsed > 10 * self._sample_period:
                self.rate_avg *= (1 - self._alpha) ** int(
                    elapsed / self._sample_period
                )
                self._sample_start = now
                break

    def status(self) -> dict:
        with self._mtx:
            self._advance_locked()
            dur = max(time.monotonic() - self.start, 1e-9)
            return {
                "bytes": self.bytes_total,
                "duration": dur,
                "rate_avg": self.rate_avg,
                "rate_peak": self.rate_peak,
                "rate_mean": self.bytes_total / dur,
            }

    def limit(self, want: int, rate: int) -> int:
        """Block until ``want`` bytes may be transferred without exceeding
        ``rate`` B/s; returns bytes permitted (== want).

        Token bucket with burst capped at one window's worth of bytes —
        idle time earns at most ``rate * window`` credit, so a peer that
        sleeps then floods is still throttled to the configured rate
        (flowrate.go Monitor.Limit, as used by MConnection's
        sendRoutine — p2p/conn/connection.go:43-44).
        """
        if rate <= 0 or want <= 0:
            return max(want, 0)
        burst = max(rate * self._window, float(want))
        while True:
            with self._mtx:
                now = time.monotonic()
                self._credit = min(
                    burst, self._credit + (now - self._credit_time) * rate
                )
                self._credit_time = now
                if self._credit >= want:
                    self._credit -= want
                    return want
                wait = (want - self._credit) / rate
            if not self.active:
                return 0
            time.sleep(min(wait, 0.1))

    def done(self) -> None:
        self.active = False


__all__ = ["Monitor"]
