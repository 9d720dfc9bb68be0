"""The device plane's runtime guard (the port of
cometbft_tpu/ops/jitguard.py, in torch terms): new launch signatures and
library builds per seam, and implicit host-device syncs in the launch
window.

The reference guards two silent failure modes of a steady state.  In the
port they read:

- **A new launch signature.**  The reference memoizes a compiled XLA
  program per shape at a few seams; a key off the pow2/bucket/chunk
  ladder recompiles in the middle of the steady state.  The port's
  kernels are compiled once per source, but each seam still launches a
  fixed set of shapes, and a new one means the batch left the ladder.
  Each seam notes a key the first time it sees a new signature
  (:func:`note_key`): ``table_build`` (``KeyTableCache._build_pages``:
  keys, window bits, the two launches' shapes), ``generic`` and
  ``chunked`` (``verify_generic_rows`` at or below and above
  MAX_LAUNCH lanes: batch, bucket, chunk, each slice's (Q, G)),
  ``keyed`` (``verify_arrays_keyed_async``: batch, bucket, window bits,
  chunk, each slice's G), ``sharded`` and ``keyed_mesh``
  (parallel/mesh.py).  A library build or load (ops/_build.py) notes
  ``build:<source>``.  Every note counts ``crypto_jit_cache_misses{seam}``
  and is kept in :func:`compile_counts`.
- **An implicit host-device sync.**  A stray ``.item()``, ``.cpu()`` or
  blocking copy in the launch path stalls the host on the card.

Counting is always on (a set lookup per launch).  The guard proper is
armed by :func:`enable` (the reference reads ``CMT_TPU_JITGUARD``; the
port reads no environment variable).  Armed, a note records its call
stack, and after :func:`seal` (the end of warm-up) a new key or build
raises :class:`RetraceError` with this stack and the seam's previous
one, counting ``crypto_guard_trips{kind="retrace"}``; and
:func:`transfer_window`, which ``TorchBatchVerifier`` opens around
each device-tier launch, sets ``torch.cuda.set_sync_debug_mode("error")``
so that a synchronizing CUDA call inside it raises at the offending line
and counts ``crypto_guard_trips{kind="transfer"}``.

**The window and other threads.**  The sync debug mode is global to the
process, not to a thread, while the verify queue runs its collector
(``plan()``: table lookups, which copy to and from the card) beside its
launcher (``execute()``: the windows), and the prober's canaries run in
threads of their own.  So every explicit copy or wait of the port (the
batch's staging, the verdicts' fetch, the pool's uploads and the
validity's copy back, a constant's first upload, a mesh placement) runs
in an :func:`audited` scope, the counterpart of the reference's explicit
``device_put``/``device_get``, and the two kinds of scope exclude each
other across threads:

- at most one window is open at a time; a window opens only when no
  other thread holds an audited scope, and then sets the mode;
- an audited scope on another thread waits until the window closes (a
  thread waiting to open a window goes first, so a busy collector
  cannot starve it);
- an audited scope on the window's own thread lifts the mode for its
  body and sets it again after.

So the mode is "error" only while the window's thread runs unaudited
code, and a trip can only come from that thread's launch path.  Nothing
of this runs unless the guard is enabled and sealed and CUDA is
initialised: the scopes are then a shared null context.
"""

from __future__ import annotations

import threading
import traceback
from contextlib import nullcontext

from cometbft_tpu_torch.metrics import crypto_metrics as _crypto_metrics

_ENABLED = False

#: the error torch raises for a synchronizing call under mode "error"
_SYNC_ERROR = "called a synchronizing CUDA operation"


class RetraceError(Exception):
    """A seam saw a new launch signature, or a library was built, after
    the warm-up boundary.  Carries the seam, the offending key and both
    call stacks (this one and the seam's previous note)."""


_counts: dict[str, int] = {}          # seam -> notes since reset()
_last_site: dict[str, tuple] = {}     # seam -> (key, stack) of the last note
_sealed = False
#: seam -> signatures seen in this process (the compile cache's
#: counterpart: reset() keeps it, as the reference's memo caches stay)
_SEEN: dict[str, set] = {}
_NULL = nullcontext()


def enable(on: bool = True) -> None:
    """Arm (or disarm) the guard: stacks recorded, raises after seal(),
    the sync window armed."""
    global _ENABLED
    _ENABLED = bool(on)


def enabled() -> bool:
    return _ENABLED


def note_compile(seam: str, key) -> None:
    """Record a new signature or a build at ``seam``, before its work is
    done, so a post-warm-up one raises before it costs anything."""
    _counts[seam] = _counts.get(seam, 0) + 1
    _crypto_metrics().jit_cache_misses.labels(seam=seam).inc()
    if not _ENABLED:
        return
    stack = "".join(traceback.format_stack(limit=16)[:-1])
    if _sealed:
        seen = next(iter(_SEEN.get(seam, ())), None)
        prior_key, prior_stack = _last_site.get(
            seam, (seen, "<no note since reset(): the key was seen before it>"))
        _crypto_metrics().guard_trips.labels(kind="retrace").inc()
        from cometbft_tpu_torch.utils.flight import FLIGHT

        raise RetraceError(
            f"RETRACE after warmup at seam '{seam}': key {key!r} is new "
            f"(warmed with e.g. {prior_key!r}).\n"
            "A steady-state launch signature left the pow2/bucket/chunk ladder, "
            "or a kernel library was built after warm-up.\n"
            f"--- this note:\n{stack}"
            f"--- previous note at seam '{seam}':\n{prior_stack}"
            + FLIGHT.format_tail())
    _last_site[seam] = (key, stack)


def note_key(seam: str, key) -> None:
    """:func:`note_compile` the first time ``seam`` sees ``key``; a key
    that raised is not remembered, so it raises again."""
    seen = _SEEN.setdefault(seam, set())
    if key in seen:
        return
    note_compile(seam, key)
    seen.add(key)


def compile_counts() -> dict[str, int]:
    """Notes per seam since the last :func:`reset`."""
    return dict(_counts)


def sealed() -> bool:
    return _sealed


def seal() -> None:
    """End the warm-up: from here on, when enabled, a new signature or a
    build raises RetraceError and transfer_window() arms."""
    global _sealed
    _sealed = True


def reset() -> None:
    """Forget counts, sites and the seal (not the seams' seen keys)."""
    global _sealed
    _sealed = False
    _counts.clear()
    _last_site.clear()


# -- the sync window ----------------------------------------------------


def _set_mode(mode: str) -> None:
    import torch

    torch.cuda.set_sync_debug_mode(mode)


def _cuda_ready() -> bool:
    import torch

    return torch.cuda.is_initialized()


def _is_sync_error(exc: BaseException) -> bool:
    return isinstance(exc, RuntimeError) and _SYNC_ERROR in str(exc)


_cond = threading.Condition()
_owner: int | None = None       # the thread holding the window
_pending = 0                    # threads waiting to open a window
_audits = 0                     # audited scopes open on non-owner threads
_lifted = 0                     # audited scopes open on the owner thread


class _Window:
    __slots__ = ("_nested",)

    def __enter__(self):
        global _owner, _pending
        me = threading.get_ident()
        with _cond:
            self._nested = _owner == me
            if not self._nested:
                _pending += 1
                while _owner is not None or _audits:
                    _cond.wait()
                _pending -= 1
                _owner = me
                _set_mode("error")
        return self

    def __exit__(self, exc_type, exc, tb):
        global _owner
        if exc is not None and _is_sync_error(exc):
            _crypto_metrics().guard_trips.labels(kind="transfer").inc()
        if not self._nested:
            with _cond:
                _set_mode("default")
                _owner = None
                _cond.notify_all()
        return False


class _Audited:
    __slots__ = ("_owned",)

    def __enter__(self):
        global _audits, _lifted
        me = threading.get_ident()
        with _cond:
            self._owned = _owner == me
            if self._owned:
                _lifted += 1
                if _lifted == 1:
                    _set_mode("default")
            else:
                while _owner is not None or _pending:
                    _cond.wait()
                _audits += 1
        return self

    def __exit__(self, *exc):
        global _audits, _lifted
        with _cond:
            if self._owned:
                _lifted -= 1
                if _lifted == 0:
                    _set_mode("error")
            else:
                _audits -= 1
                if not _audits:
                    _cond.notify_all()
        return False


def _armed() -> bool:
    return _ENABLED and _sealed and _cuda_ready()


def transfer_window():
    """The steady-state launch window (``TorchBatchVerifier``'s device
    tier launch): an implicit host-device sync inside it raises
    (``torch.cuda.set_sync_debug_mode("error")``) and counts a transfer
    trip.  A null context until the guard is enabled and sealed and
    CUDA is initialised.  Across threads, see the module docstring."""
    return _Window() if _armed() else _NULL


def audited():
    """An explicit, audited copy or wait (the reference's ``device_put``
    / ``device_get``): allowed inside the window; on another thread it
    waits for the window to close.  A null context unless the guard is
    enabled."""
    return _Audited() if _ENABLED and _cuda_ready() else _NULL


__all__ = [
    "RetraceError",
    "audited",
    "compile_counts",
    "enable",
    "enabled",
    "note_compile",
    "note_key",
    "reset",
    "seal",
    "sealed",
    "transfer_window",
]
