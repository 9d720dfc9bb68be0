"""Crash-point injection (a copy of cometbft_tpu/utils/fail.py;
reference: internal/fail/fail.go).

``fail_point()`` is sprinkled through ApplyBlock's persistence sequence
(state/execution.go:270,277,317,325); setting ``FAIL_TEST_INDEX=n``
makes the n-th call hard-exit the process, so replay tests can assert
recovery from every crash point.
"""

from __future__ import annotations

import os

_call_index = 0


def reset() -> None:
    global _call_index
    _call_index = 0


def fail_point() -> None:
    global _call_index
    target = os.environ.get("FAIL_TEST_INDEX")
    if target is None or target == "":
        return
    if _call_index == int(target):
        os._exit(1)  # simulate kill -9: no cleanup, no flush
    _call_index += 1
