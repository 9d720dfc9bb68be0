"""Timeout scheduling for the consensus state machine (a copy of
cometbft_tpu/consensus/ticker.py; reference: internal/consensus/ticker.go:15
TimeoutTicker).

One background thread arms at most ONE pending timeout; scheduling a
newer (height, round, step) replaces the old one (timeoutRoutine's
stopTimer-on-newer semantics).  Fired timeouts are delivered through a
callback into the state machine's input queue — never invoked inline.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable

from cometbft_tpu_torch.utils.service import BaseService

# Round step ordering (internal/consensus/types/round_state.go RoundStepType)
STEP_NEW_HEIGHT = 1
STEP_NEW_ROUND = 2
STEP_PROPOSE = 3
STEP_PREVOTE = 4
STEP_PREVOTE_WAIT = 5
STEP_PRECOMMIT = 6
STEP_PRECOMMIT_WAIT = 7
STEP_COMMIT = 8

STEP_NAMES = {
    STEP_NEW_HEIGHT: "NewHeight",
    STEP_NEW_ROUND: "NewRound",
    STEP_PROPOSE: "Propose",
    STEP_PREVOTE: "Prevote",
    STEP_PREVOTE_WAIT: "PrevoteWait",
    STEP_PRECOMMIT: "Precommit",
    STEP_PRECOMMIT_WAIT: "PrecommitWait",
    STEP_COMMIT: "Commit",
}


@dataclass(frozen=True)
class TimeoutInfo:
    """(internal/consensus/state.go timeoutInfo)"""

    duration_ns: int
    height: int
    round: int
    step: int

    def hrs(self) -> tuple[int, int, int]:
        return (self.height, self.round, self.step)


class TimeoutTicker(BaseService):
    def __init__(self, on_timeout: Callable[[TimeoutInfo], None]):
        super().__init__(name="TimeoutTicker")
        self._on_timeout = on_timeout
        self._cv = threading.Condition()
        self._pending: TimeoutInfo | None = None
        self._deadline_ns: int = 0
        self._thread: threading.Thread | None = None

    def schedule(self, ti: TimeoutInfo) -> None:
        """Arm ti, replacing any pending timeout for an older HRS
        (ticker.go ScheduleTimeout)."""
        from cometbft_tpu_torch.utils.time import now_ns

        with self._cv:
            if self._pending is not None and ti.hrs() < self._pending.hrs():
                return  # ignore stale schedule
            self._pending = ti
            self._deadline_ns = now_ns() + ti.duration_ns  # deterministic: timeout scheduling, not state — replay re-fires from the recorded WAL timeout record
            self._cv.notify()

    def on_start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name="timeout-ticker", daemon=True
        )
        self._thread.start()

    def on_stop(self) -> None:
        with self._cv:
            self._cv.notify()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _run(self) -> None:
        from cometbft_tpu_torch.utils.time import now_ns

        while not self.quit_event().is_set():
            with self._cv:
                if self._pending is None:
                    self._cv.wait(timeout=0.2)
                    continue
                wait_ns = self._deadline_ns - now_ns()
                if wait_ns > 0:
                    self._cv.wait(timeout=wait_ns / 1e9)
                    continue  # re-check: schedule may have replaced it
                ti = self._pending
                self._pending = None
            self._on_timeout(ti)
