"""Runtime wire-provenance guard (a copy of
cometbft_tpu/utils/trustguard.py): the trust-boundary analog of the
lock modes in utils/sync.py and the device guard in ops/jitguard.py.

Armed (:func:`enable`):

- every reactor seam (the ``receive`` implementations, the consensus
  message-queue dequeue, statesync's chunk intake) stamps a
  thread-local **wire context** on the decoded envelope via
  :func:`wire_context` / :func:`guarded_seam`;
- every registered validator marks the active context via
  :func:`note_validated` when its check actually ran;
- every registered sink calls :func:`check_sink` at its mutation
  point: if a wire context is active and NO validator has run in it,
  the guard increments ``consensus_trust_guard_trips_total{sink}``,
  records a ``trust_guard_trip`` flight event, and raises
  :class:`TrustGuardError` — the state is never mutated.

A sink reached with no active wire context (WAL replay, timeout-driven
commits, administrative paths) is NOT checked: provenance is only
asserted for values that demonstrably crossed the wire this call
chain.  Contexts are thread-local, so work handed to another thread
(blocksync's pool routine) is out of the guard's scope.

Zero-cost when off: every entry point returns at once on the cached
flag.  Where the port departs from its reference: the reference arms
the guard from ``CMT_TPU_TRUSTGUARD`` at import; the port reads no
environment variable and is armed by :func:`enable`.  The port has 9
seams, every one of the reference's but RPC's three (``rpc_tx``,
``rpc_tx_async``, ``rpc_evidence``), which come with the RPC server.
"""

from __future__ import annotations

import functools
import threading
from contextlib import contextmanager

from cometbft_tpu_torch.utils.flight import FLIGHT

_ENABLED = False
_TLS = threading.local()

#: the node's ConsensusMetrics, installed at node assembly (the sinks
#: live in types/ with no node handle).  None -> trips still
#: flight-record and raise, just without the counter.
_METRICS = None


class TrustGuardError(Exception):
    """A wire-derived value reached a registered consensus sink with
    no registered validator run in its wire context."""


def enabled() -> bool:
    return _ENABLED


def enable(on: bool = True) -> None:
    """Arm (or, with ``on=False``, disarm) the guard process-wide."""
    global _ENABLED
    _ENABLED = bool(on)


def install_metrics(metrics) -> None:
    """Install the node's ConsensusMetrics as the trip counter sink
    (None resets)."""
    global _METRICS
    _METRICS = metrics


def reset(enable: bool | None = None) -> None:
    """Clear this thread's context stack and optionally set the
    enabled flag (None keeps it)."""
    global _ENABLED
    if enable is not None:
        _ENABLED = bool(enable)
    _TLS.stack = []


def _stack() -> list:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


@contextmanager
def wire_context(origin: str):
    """Stamp everything in the dynamic extent of this block as
    wire-derived from ``origin`` (a reactor seam name).  Re-entrant:
    nested seams (a reactor calling into the syncer) push their own
    frame, so validation is asserted per innermost envelope."""
    if not _ENABLED:
        yield
        return
    st = _stack()
    st.append({"origin": origin, "validated": []})
    try:
        yield
    finally:
        st.pop()


def guarded_seam(origin: str):
    """Decorator form of :func:`wire_context` for reactor seams —
    everything the decorated function does runs under a wire context
    named ``origin``.  One flag check of overhead when the guard is
    off."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _ENABLED:
                return fn(*args, **kwargs)
            with wire_context(origin):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def note_validated(validator: str) -> None:
    """Record that a registered validator ran for the innermost wire
    context (no-op outside one)."""
    if not _ENABLED:
        return
    st = _stack()
    if st:
        st[-1]["validated"].append(validator)


def check_sink(sink: str) -> None:
    """Assert at a registered sink's mutation point that a validator
    ran for the innermost wire context.  No-op when the guard is off
    or no wire context is active (local/replay/administrative paths
    carry no wire provenance)."""
    if not _ENABLED:
        return
    st = _stack()
    if not st:
        return
    frame = st[-1]
    if frame["validated"]:
        return
    if _METRICS is not None:
        _METRICS.trust_guard_trips_total.labels(sink=sink).inc()
    FLIGHT.record("trust_guard_trip", sink=sink, origin=frame["origin"])
    raise TrustGuardError(
        f"wire-derived value from seam '{frame['origin']}' reached "
        f"sink '{sink}' with no registered validator run in this "
        "context — the trust boundary was crossed unvalidated; see "
        "docs/trust_boundary.md"
    )


__all__ = [
    "TrustGuardError",
    "check_sink",
    "enable",
    "enabled",
    "guarded_seam",
    "install_metrics",
    "note_validated",
    "reset",
    "wire_context",
]
