"""Canonical time (a copy of cometbft_tpu/utils/time.py; reference:
libs/time/time.go).

All timestamps in the system are unix-epoch nanoseconds.  ``now_ns``
is the single clock source so tests can monkeypatch it in one place
(the reference's cmttime.Now, canonicalized to ms there; we keep ns
and canonicalize only in encodings).
"""

from __future__ import annotations

import time


def now_ns() -> int:
    return time.time_ns()


def sleep_ns(ns: int) -> None:
    if ns > 0:
        time.sleep(ns / 1e9)
