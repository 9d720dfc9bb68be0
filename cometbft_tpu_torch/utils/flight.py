"""Always-on flight recorder (a copy of cometbft_tpu/utils/flight.py).

A bounded ring of the most recent events -- here the dispatch ladder's
transitions, the launch watchdog's overruns and the cost model's
reorders -- so the story before a fault survives to the post-mortem.
``record()`` takes no lock: ``append`` on a bounded deque is atomic
under the GIL (``recorded_total`` is best-effort under concurrency).
The depth is a constructor argument; the port reads no environment
variable for it.
"""

from __future__ import annotations

import threading
import time
from collections import deque

DEFAULT_DEPTH = 2048


class FlightRecorder:
    """Bounded lock-free ring of recent events."""

    def __init__(self, depth: int = DEFAULT_DEPTH):
        if depth < 1:
            raise ValueError(f"flight depth must be >= 1, got {depth}")
        self.depth = depth
        self._ring: deque[dict] = deque(maxlen=depth)
        # best-effort under concurrency (unlocked += is not atomic)
        self.recorded_total = 0

    def record(self, kind: str, **fields) -> None:
        """Append one event.  ``fields`` must be JSON-able primitives;
        ``t`` is the wall clock (``time.time()``)."""
        self._ring.append({
            "t": time.time(),
            "thread": threading.current_thread().name,
            "kind": kind,
            **fields,
        })
        self.recorded_total += 1

    def events(self) -> list[dict]:
        """Snapshot, oldest first."""
        return list(self._ring)

    def tail(self, n: int = 20) -> list[dict]:
        return self.events()[-n:]

    def export(self) -> dict:
        events = self.events()
        return {
            "depth": self.depth,
            "recorded_total": self.recorded_total,
            "dropped": max(0, self.recorded_total - len(events)),
            "clock": "wall",
            "events": events,
        }

    def format_tail(self, n: int = 20) -> str:
        """Human-readable tail for attaching to error reports."""
        lines = [f"--- flight recorder tail (last {n} of "
                 f"{self.recorded_total} events) ---"]
        for ev in self.tail(n):
            extra = " ".join(f"{k}={v}" for k, v in ev.items()
                             if k not in ("t", "thread", "kind"))
            lines.append(f"  {ev['t']:.6f} [{ev['thread']}] {ev['kind']}"
                         + (f" {extra}" if extra else ""))
        if len(lines) == 1:
            lines.append("  <empty>")
        return "\n".join(lines)

    def clear(self) -> None:
        self._ring.clear()
        self.recorded_total = 0


#: process-wide recorder: every plane records here
FLIGHT = FlightRecorder()



def flight_tail(n: int = 20) -> str:
    """Convenience for error constructors: a newline-prefixed tail that
    can be appended to any message (empty-ring safe)."""
    return "\n" + FLIGHT.format_tail(n)
