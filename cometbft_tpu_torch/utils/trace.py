"""Span tracing for the device path (a copy of cometbft_tpu/utils/trace.py).

Spans are context managers with thread-local parenting, kept in a
bounded ring and exported as Chrome trace-event JSON (the
``traceEvents`` object form that chrome://tracing and Perfetto load).
The port puts them around whole batches, never per-signature work:

- ``device_launch`` (kernel, batch, bucket, window_bits): the launches
  of one batch on the keyed or generic tier (ops/ed25519_verify.py);
- ``verify_queue/prepare`` and ``verify_queue/launch``: the verify
  queue's host phase and its launch (crypto/verify_queue.py), so the
  overlap shows as a prepare inside another batch's launch;
- a blocksync step's parts: ``blocksync/decode`` (kind, bytes) for each
  received message, ``blocksync/sync_step`` (height) for each block
  pair validated and applied, inside it ``blocksync/part_set``,
  ``verify_commit``, ``store/save_block``, ``blocksync/prefetch``
  (sigs) and ``exec/apply_block``, which holds ``verify_commit``, the
  ``abci/*`` calls and ``state/save`` (blocksync/reactor.py,
  state/execution.py, state/__init__.py; the reference has only the
  executor's and the verify's).

A disabled tracer returns one shared no-op span.  The ring's capacity
and the on/off switch are constructor arguments (the reference reads
``CMT_TPU_TRACE_RING`` and ``CMT_TPU_TRACE``; the port reads no
environment variable): ``TRACER.set_enabled(False)`` turns it off and
``TRACER.set_capacity(n)`` resizes the ring.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

DEFAULT_RING = 4096


class _NopSpan:
    """The disabled tracer's span: one shared object, nothing recorded."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args) -> None:
        pass


NOP_SPAN = _NopSpan()


class _Span:
    """One open span; records a complete ("ph": "X") event on exit."""

    __slots__ = ("_tracer", "name", "cat", "args", "_t0", "_parent")

    def __init__(self, tracer: "SpanTracer", name: str, cat: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def set(self, **args) -> None:
        """Attach data found inside the span (a verdict, a hit count)."""
        self.args.update(args)

    def __enter__(self):
        stack = self._tracer._stack()
        self._parent = stack[-1].name if stack else None
        stack.append(self)
        self._tracer._active[threading.get_ident()] = self.name
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        end = time.perf_counter()
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        tid = threading.get_ident()
        if stack:
            self._tracer._active[tid] = stack[-1].name
        else:
            self._tracer._active.pop(tid, None)
        if exc_type is not None:
            self.args["error"] = exc_type.__name__
        self._tracer._record(self.name, self.cat, self._t0, end - self._t0, self.args,
                             self._parent)
        return False


class SpanTracer:
    """Bounded ring of completed spans, exportable as Chrome trace JSON.

    ``span(name, cat, **args)`` opens a span; spans opened on one thread
    nest (the parent's name lands in the child's args).
    ``add_complete`` records a span after the fact from perf_counter
    times."""

    def __init__(self, capacity: int = DEFAULT_RING, enabled: bool = True):
        self.enabled = enabled
        self._events: deque[dict] = deque(maxlen=max(capacity, 1))
        self._mtx = threading.Lock()
        self._tls = threading.local()
        #: tid -> innermost open span name, while that thread has one
        self._active: dict[int, str] = {}
        #: perf_counter origin: event ts are microseconds since it
        self.epoch = time.perf_counter()
        #: wall clock at the same instant as ``epoch``
        self.epoch_wall = time.time()
        self._dropped = 0
        self._pid = os.getpid()
        #: tid -> thread name, taken at record time
        self._thread_names: dict[int, str] = {}

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def span(self, name: str, cat: str = "app", **args):
        """A context-manager span; the shared no-op when disabled."""
        if not self.enabled:
            return NOP_SPAN
        return _Span(self, name, cat, args)

    def add_complete(self, name: str, start: float, duration_s: float, cat: str = "app",
                     args: dict | None = None) -> None:
        """Record a span from ``time.perf_counter()`` values."""
        if not self.enabled:
            return
        self._record(name, cat, start, duration_s, args or {}, None)

    def _record(self, name: str, cat: str, start: float, duration_s: float, args: dict,
                parent: str | None) -> None:
        if parent is not None:
            args = dict(args, parent=parent)
        thread = threading.current_thread()
        event = {
            "name": name,
            "cat": cat,
            "ph": "X",
            "ts": round(max(start - self.epoch, 0.0) * 1e6, 1),
            "dur": round(max(duration_s, 0.0) * 1e6, 1),
            "pid": self._pid,
            "tid": thread.ident,
            "args": args,
        }
        with self._mtx:
            if len(self._events) == self._events.maxlen:
                self._dropped += 1
            self._events.append(event)
            self._thread_names[thread.ident] = thread.name
            if len(self._thread_names) > 1024:
                live = {e["tid"] for e in self._events}
                self._thread_names = {t: n for t, n in self._thread_names.items()
                                      if t in live}

    def current_spans(self) -> dict[int, str]:
        """tid -> innermost open span name."""
        return dict(self._active)

    def events(self) -> list[dict]:
        """The retained span events, oldest first."""
        with self._mtx:
            return list(self._events)

    def export(self) -> dict:
        """Chrome trace-event JSON (object form), with a thread-name
        metadata event per thread."""
        with self._mtx:
            events = list(self._events)
            names = dict(self._thread_names)
        pid = self._pid
        meta = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                 "args": {"name": names.get(tid, f"thread-{tid}")}}
                for tid in sorted({e["tid"] for e in events})]
        return {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "otherData": {"dropped_spans": self._dropped, "wall_epoch": self.epoch_wall,
                          "pid": pid},
        }

    def export_json(self) -> str:
        return json.dumps(self.export(), default=str)

    def dump(self, path: str) -> None:
        """Write the export to ``path`` (a temporary file, then a rename)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.export_json())
        os.replace(tmp, path)

    def clear(self) -> None:
        with self._mtx:
            self._events.clear()
            self._thread_names.clear()
            self._dropped = 0

    def set_enabled(self, enabled: bool) -> None:
        self.enabled = bool(enabled)

    def set_capacity(self, capacity: int) -> None:
        """Resize the ring to ``capacity`` events, keeping the newest."""
        with self._mtx:
            self._events = deque(self._events, maxlen=max(capacity, 1))

    @property
    def capacity(self) -> int:
        return self._events.maxlen


#: the process-wide tracer: every span of the port records here
TRACER = SpanTracer()
