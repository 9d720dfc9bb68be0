"""Pipelined verify-ahead: the double-buffered verify queue (a copy of
cometbft_tpu/crypto/verify_queue.py).

A process-wide ``VerifyQueue`` takes verification requests from any
caller (consensus votes, blocksync prefetch, light-client headers,
mempool CheckTx), coalesces them into device-sized batches and keeps
two buffers in flight:

- a *collector* thread takes pending requests, computes their
  speculative-cache keys and runs the verifier's host phase
  (``TorchBatchVerifier.plan()``: routing, the key-table lookup, the
  packed arrays) for buffer N+1 while buffer N runs on the
- *launcher* thread, which runs prepared buffers through
  ``execute()`` (the dispatch ladder's walk) and resolves the callers'
  futures.

Priorities: four lanes, consensus > prefetch > light_client > ingest.
A higher lane preempts the lower ones at buffer granularity in both
threads.  The ingest and light_client lanes accumulate behind a
micro-batcher (``_LaneBatcher``): a lane releases at its size target,
when its oldest request has waited its deadline, or on drain.

**Speculative-result cache.**  Every verification that passes lands in
a bounded LRU keyed by SHA-512(pubkey || signature || message); only
positive verdicts are kept, so a wrong "invalid" costs one retry and
never poisons the cache.

**Failures.**  ``QueueUnavailable`` means only: no queue installed, the
queue draining or stopped, or a wait that timed out; the
``*_or_fallback`` helpers then verify that item inline with
``pub_key.verify_signature``.  A batch whose ``plan`` or ``execute``
raised anything else fails its futures with that exception and
``result()`` re-raises it to the caller: the ladder walks typed tier
faults down inside ``execute``, so what reaches the queue is a fault
of the port (a kernel that failed to build or launch, a table build
that failed), not a reason to verify on the host.  The verifier
factory is not guarded either: a factory that raises fails the batch.

The defaults are the reference's, as module constants and constructor
arguments (the reference reads ``CMT_TPU_*`` variables; the port reads
none).  Observability: ``crypto_verify_queue_*``, the
``verify_queue/prepare`` and ``verify_queue/launch`` spans, and
``crypto_host_device_overlap_ratio``: the cumulative share of launch
wall time covered by host preparation of another buffer.
"""

from __future__ import annotations

import hashlib
import logging
import threading
import time
from collections import OrderedDict, deque

from cometbft_tpu_torch.metrics import crypto_metrics as _crypto_metrics
from cometbft_tpu_torch.metrics import health_metrics as _health_metrics
from cometbft_tpu_torch.utils.service import BaseService
from cometbft_tpu_torch.utils.trace import TRACER as _tracer
from cometbft_tpu_torch.utils import sync as cmtsync

PRIORITY_CONSENSUS = "consensus"
PRIORITY_PREFETCH = "prefetch"
PRIORITY_LIGHT = "light_client"
PRIORITY_INGEST = "ingest"
_PRIORITIES = (PRIORITY_CONSENSUS, PRIORITY_PREFETCH, PRIORITY_LIGHT, PRIORITY_INGEST)

#: blocksync prefetch depth in blocks (0 disables prefetch), the
#: default of ``BlocksyncReactor(prefetch_depth=...)``
DEFAULT_PREFETCH_DEPTH = 8
#: speculative-cache capacity in entries
DEFAULT_SPEC_CACHE_CAP = 65536
#: ingest micro-batcher: release at this many pending signatures ...
DEFAULT_CHECKTX_BATCH = 256
#: ... or when the oldest pending ingest request has waited this long
DEFAULT_CHECKTX_WAIT_MS = 5
#: light_client micro-batcher: the same two bounds
DEFAULT_LIGHT_BATCH = 1024
DEFAULT_LIGHT_WAIT_MS = 10
#: largest coalesced batch, in every lane: one MAX_LAUNCH slice
DEFAULT_MAX_BATCH = 8192
#: how long a caller waits on a future before QueueUnavailable
DEFAULT_WAIT_S = 120.0


class QueueUnavailable(RuntimeError):
    """No queue, a draining or stopped queue, or a wait that timed out:
    the caller verifies synchronously."""


class VerifyFuture:
    """Completion handle for one submitted (pubkey, msg, sig) request.
    ``result()`` returns the verdict, raises QueueUnavailable on a
    timeout or a stopped queue, and re-raises any other exception the
    request's batch failed with."""

    __slots__ = ("_event", "_result", "_error")

    def __init__(self) -> None:
        self._event = threading.Event()
        self._result: bool | None = None
        self._error: BaseException | None = None

    def _resolve(self, result: bool) -> None:
        if not self._event.is_set():
            self._result = result
            self._event.set()

    def _fail(self, exc: BaseException) -> None:
        # the first writer wins
        if not self._event.is_set():
            self._error = exc
            self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = DEFAULT_WAIT_S) -> bool:
        if not self._event.wait(timeout):
            raise QueueUnavailable("verify future timed out")
        if self._error is not None:
            raise self._error
        return bool(self._result)


def cache_key(pub: bytes, msg: bytes, sig: bytes) -> bytes:
    """SHA-512 over pubkey || signature || sign-bytes: binding the
    signature, so two signatures over the same bytes never share a
    cached verdict."""
    h = hashlib.sha512()
    h.update(pub)
    h.update(sig)
    h.update(msg)
    return h.digest()


@cmtsync.guarded
class SpeculativeCache:
    """Bounded LRU of cache_key -> True: proofs of validity only.  A
    negative verdict is never stored (a transient fault must cost one
    rejected attempt, not a poisoned entry)."""

    _GUARDED_BY = {"_map": "_mtx"}

    def __init__(self, capacity: int = DEFAULT_SPEC_CACHE_CAP) -> None:
        self.capacity = capacity
        self._mtx = cmtsync.Mutex()
        self._map: OrderedDict[bytes, bool] = OrderedDict()

    def lookup(self, key: bytes) -> bool | None:
        with self._mtx:
            if key not in self._map:
                return None
            self._map.move_to_end(key)
            return self._map[key]

    def store(self, key: bytes, ok: bool) -> None:
        if not ok:
            return
        with self._mtx:
            self._map[key] = True
            self._map.move_to_end(key)
            while len(self._map) > self.capacity:
                self._map.popitem(last=False)

    def __len__(self) -> int:
        with self._mtx:
            return len(self._map)


class _Request:
    __slots__ = ("pub_key", "msg", "sig", "future", "key", "t")

    def __init__(self, pub_key, msg: bytes, sig: bytes) -> None:
        self.pub_key = pub_key
        self.msg = msg
        self.sig = sig
        self.future = VerifyFuture()
        self.key: bytes | None = None  # the cache key, set by the collector
        #: arrival (monotonic): a lane's deadline runs from its oldest
        self.t = time.monotonic()


class _LaneBatcher:
    """The accumulate/deadline/release gate of a batched lane: a pending
    lane releases when it reaches ``batch_target``, when its oldest
    request has waited ``wait_s``, or on drain.  All timing reads the
    requests' arrival stamps, so tests drive it with explicit clocks."""

    __slots__ = ("batch_target", "wait_s")

    def __init__(self, batch_target: int, wait_ms: int) -> None:
        self.batch_target = batch_target
        self.wait_s = wait_ms / 1000.0

    def ready(self, lane: deque, draining: bool, now: float | None = None) -> bool:
        if not lane:
            return False
        if draining or len(lane) >= self.batch_target:
            return True
        now = time.monotonic() if now is None else now
        return now - lane[0].t >= self.wait_s

    def deadline_wait(self, lane: deque, now: float | None = None) -> float | None:
        """Seconds until the oldest pending request's deadline (None for
        an empty lane)."""
        if not lane:
            return None
        now = time.monotonic() if now is None else now
        return max(0.001, self.wait_s - (now - lane[0].t))


class _Prepared:
    """One prepared buffer: its requests grouped per key type, each group
    with its verifier and plan, ready for the launcher."""

    __slots__ = ("priority", "reqs", "groups", "prep_seconds")

    def __init__(self, priority: str) -> None:
        self.priority = priority
        self.reqs: list[_Request] = []
        #: (reqs, verifier | None, plan | None); a None verifier means a
        #: key type with no batch verifier, verified per signature
        self.groups: list[tuple] = []
        self.prep_seconds = 0.0


@cmtsync.guarded
class VerifyQueue(BaseService):
    """The double-buffered verify queue (module docstring).

    ``verifier_factory(pub_key)`` builds a batch's verifier (default:
    ``crypto.batch.create_batch_verifier``, on ``cuda``).  ``launch``
    replaces the launch phase: ``launch(items) -> list[bool]`` over
    (pub_key, msg, sig) tuples (tests gate it to pin the overlap).
    ``use_cache=False`` turns the speculative cache off.  A buffer of
    any lane holds at most ``max_batch`` requests."""

    _GUARDED_BY = {
        "_pending": "_qmtx",
        "_prepared": "_qmtx",
        "_preparing_lane": "_qmtx",
        "_draining": "_qmtx",
        "_launch_active": "_qmtx",
        "_launch_t0": "_qmtx",
        "_overlap_accum": "_qmtx",
        "_prep_since": "_qmtx",
        "_overlap_seconds": "_qmtx",
        "_launch_wall_seconds": "_qmtx",
        "_stats": "_qmtx",
        "_last_overlap": "_qmtx",
    }

    def __init__(self, verifier_factory=None, launch=None,
                 max_batch: int = DEFAULT_MAX_BATCH,
                 spec_cache: SpeculativeCache | None = None, use_cache: bool = True,
                 checktx_batch: int = DEFAULT_CHECKTX_BATCH,
                 checktx_wait_ms: int = DEFAULT_CHECKTX_WAIT_MS,
                 light_batch: int = DEFAULT_LIGHT_BATCH,
                 light_wait_ms: int = DEFAULT_LIGHT_WAIT_MS,
                 logger: logging.Logger | None = None) -> None:
        super().__init__(name="verify-queue",
                         logger=logger or logging.getLogger(
                             "cometbft_tpu_torch.crypto.verify_queue"))
        self._factory = verifier_factory
        self._launch = launch
        self._max_batch = max_batch
        self._batchers: dict[str, _LaneBatcher] = {
            PRIORITY_INGEST: _LaneBatcher(checktx_batch, checktx_wait_ms),
            PRIORITY_LIGHT: _LaneBatcher(light_batch, light_wait_ms),
        }
        self.cache = (spec_cache or SpeculativeCache()) if use_cache else None
        self._qmtx = cmtsync.Mutex()
        self._collector_wake = threading.Event()
        self._launcher_wake = threading.Event()
        # everything below is guarded by _qmtx
        self._pending: dict[str, deque[_Request]] = {p: deque() for p in _PRIORITIES}
        #: prepared buffers awaiting launch, at most one per lane: with
        #: the one the launcher holds, that is the double buffer
        self._prepared: dict[str, deque[_Prepared]] = {p: deque() for p in _PRIORITIES}
        #: the lane being prepared, from the pop until its buffer is
        #: parked or abandoned (busy() reads it)
        self._preparing_lane: str | None = None
        self._draining = False
        self._launch_active = 0
        self._launch_t0 = 0.0
        self._overlap_accum = 0.0
        #: start (or credited-until mark) of the prep running now, or None
        self._prep_since: float | None = None
        self._overlap_seconds = 0.0
        self._launch_wall_seconds = 0.0
        self._last_overlap: float | None = None
        self._stats = {
            "submitted": {p: 0 for p in _PRIORITIES},
            "cache_resolved": 0,
            "prepared_batches": 0,
            "launched_batches": 0,
            "launched_sigs": 0,
            "failed_batches": 0,
        }
        self._collector_thread: threading.Thread | None = None
        self._launcher_thread: threading.Thread | None = None

    # -- submission --------------------------------------------------------

    def accepting(self) -> bool:
        with self._qmtx:
            draining = self._draining
        return self.is_running() and not draining

    def busy(self) -> bool:
        """True while work a consensus vote could wait behind is pending,
        prepared, being prepared or launching.  Queued ingest and
        light_client work does not count (consensus preempts it); a
        launch already running does, whatever its lane."""
        with self._qmtx:
            return self._busy_locked()

    def _busy_locked(self) -> bool:
        return bool(
            self._launch_active
            or self._preparing_lane in (PRIORITY_CONSENSUS, PRIORITY_PREFETCH)
            or any(self._pending[p] or self._prepared[p]
                   for p in (PRIORITY_CONSENSUS, PRIORITY_PREFETCH))
        )

    def submit_many(self, items, priority: str = PRIORITY_CONSENSUS,
                    unless_busy: bool = False) -> list[VerifyFuture] | None:
        """Enqueue (pub_key, msg, sig) tuples -> one future each.  Raises
        QueueUnavailable when stopped or draining.  With ``unless_busy``
        it enqueues nothing and returns None while the queue is
        ``busy()``: the check and the enqueue hold one lock, so no buffer
        is popped between them."""
        if priority not in _PRIORITIES:
            raise ValueError(f"unknown priority {priority!r}")
        reqs = [_Request(pk, bytes(m), bytes(s)) for pk, m, s in items]
        with self._qmtx:
            if self._draining or not self.is_running():
                raise QueueUnavailable("verify queue is not accepting")
            if unless_busy and self._busy_locked():
                return None
            self._pending[priority].extend(reqs)
            self._stats["submitted"][priority] += len(reqs)
            depth = len(self._pending[priority])
        cm = _crypto_metrics()
        cm.verify_queue_submitted.labels(priority=priority).inc(len(reqs))
        cm.verify_queue_depth.labels(priority=priority).set(depth)
        self._collector_wake.set()
        return [r.future for r in reqs]

    def submit(self, pub_key, msg, sig, priority: str = PRIORITY_CONSENSUS) -> VerifyFuture:
        return self.submit_many([(pub_key, msg, sig)], priority)[0]

    # -- lifecycle ---------------------------------------------------------

    def on_start(self) -> None:
        self._collector_thread = threading.Thread(target=self._collector,
                                                  name="verify-queue-collect", daemon=True)
        self._launcher_thread = threading.Thread(target=self._launcher,
                                                 name="verify-queue-launch", daemon=True)
        self._collector_thread.start()
        self._launcher_thread.start()

    def on_stop(self) -> None:
        """Drain: stop accepting, let the collector prepare what is
        pending and the launcher run every prepared buffer, then fail
        what is left (QueueUnavailable) so no caller waits forever."""
        with self._qmtx:
            self._draining = True
        self._collector_wake.set()
        self._launcher_wake.set()
        for t in (self._collector_thread, self._launcher_thread):
            if t is not None:
                t.join(timeout=DEFAULT_WAIT_S)
        leftovers: list[_Request] = []
        with self._qmtx:
            for p in _PRIORITIES:
                leftovers.extend(self._pending[p])
                self._pending[p].clear()
                for prep in self._prepared[p]:
                    leftovers.extend(prep.reqs)
                self._prepared[p].clear()
        for r in leftovers:
            r.future._fail(QueueUnavailable("queue stopped"))
        if _QUEUE is self:
            install_queue(None)

    # -- the collector (host phase: buffer N+1) ----------------------------

    def _batcher_deadline_wait(self) -> float:
        """How long the collector may sleep: no longer than the nearest
        pending deadline of a batched lane."""
        wait = 0.05
        now = time.monotonic()
        with self._qmtx:
            for p, gate in self._batchers.items():
                remaining = gate.deadline_wait(self._pending[p], now)
                if remaining is not None:
                    wait = min(wait, remaining)
        return max(0.001, wait)

    def _next_pending(self) -> tuple[list[_Request] | None, str | None]:
        """Pop the next batch: the highest lane whose gate is open and
        whose prepared slot is free.  Sets ``_preparing_lane`` under the
        same lock as the pop."""
        with self._qmtx:
            for p in _PRIORITIES:
                gate = self._batchers.get(p)
                if gate is not None and not gate.ready(self._pending[p], self._draining):
                    continue
                if self._pending[p] and not self._prepared[p]:
                    take = min(len(self._pending[p]), self._max_batch)
                    reqs = [self._pending[p].popleft() for _ in range(take)]
                    self._preparing_lane = p
                    _crypto_metrics().verify_queue_depth.labels(priority=p).set(
                        len(self._pending[p]))
                    return reqs, p
        return None, None

    def _idle_done(self) -> bool:
        with self._qmtx:
            if not self._draining:
                return False
            return not any(self._pending.values())

    def _collector(self) -> None:
        while True:
            reqs, priority = self._next_pending()
            if reqs is None:
                if self._idle_done():
                    return
                self._collector_wake.wait(self._batcher_deadline_wait())
                self._collector_wake.clear()
                continue
            try:
                try:
                    prep = self._prepare(reqs, priority)
                except Exception as exc:  # noqa: BLE001 -- the callers get it
                    self.logger.error("verify-queue prepare failed: %r", exc)
                    for r in reqs:
                        r.future._fail(exc)
                    continue
                if not prep.reqs:
                    continue  # every request was a cache hit
                with self._qmtx:
                    self._prepared[priority].append(prep)
                    self._stats["prepared_batches"] += 1
                    inflight = self._launch_active + sum(len(d) for d in self._prepared.values())
                _crypto_metrics().verify_queue_inflight.set(inflight)
                self._launcher_wake.set()
            finally:
                # cleared after the buffer is parked: busy() never misses it
                with self._qmtx:
                    self._preparing_lane = None

    def _prepare(self, reqs: list[_Request], priority: str) -> _Prepared:
        """Host phase of one buffer: cache keys, speculative dedupe, then
        each group's ``plan()``, overlapping whatever launch is running."""
        t0 = time.perf_counter()
        with self._qmtx:
            self._prep_since = t0
        prep = _Prepared(priority)
        cm = _crypto_metrics()
        try:
            with _tracer.span("verify_queue/prepare", cat="crypto", batch=len(reqs),
                              priority=priority) as prep_span:
                work: list[_Request] = []
                for r in reqs:
                    r.key = cache_key(r.pub_key.bytes(), r.msg, r.sig)
                    cached = self.cache.lookup(r.key) if self.cache is not None else None
                    if cached is not None:
                        cm.verify_queue_spec_cache.labels(result="hit").inc()
                        r.future._resolve(cached)
                        continue
                    if self.cache is not None:
                        cm.verify_queue_spec_cache.labels(result="miss").inc()
                    work.append(r)
                with self._qmtx:
                    self._stats["cache_resolved"] += len(reqs) - len(work)
                if work:
                    prep.reqs = work
                    cm.verify_queue_batch_size.observe(len(work))
                    if self._launch is not None:
                        prep.groups = [(work, None, None)]
                    else:
                        prep.groups = self._build_groups(work)
                prep_span.set(hits=len(reqs) - len(work), misses=len(work))
            prep.prep_seconds = time.perf_counter() - t0
        finally:
            # host prep that ran while a launch was in flight is the
            # overlap; a launch that ended mid-prep already credited the
            # part before its end and moved the mark
            now = time.perf_counter()
            with self._qmtx:
                since = self._prep_since if self._prep_since is not None else t0
                if self._launch_active:
                    self._overlap_accum += max(0.0, now - max(since, self._launch_t0))
                self._prep_since = None
        return prep

    def _build_groups(self, work: list[_Request]) -> list[tuple]:
        from cometbft_tpu_torch.crypto import batch as crypto_batch

        by_type: dict[str, list[_Request]] = {}
        for r in work:
            by_type.setdefault(r.pub_key.type(), []).append(r)
        groups: list[tuple] = []
        for reqs in by_type.values():
            pk0 = reqs[0].pub_key
            verifier = plan = None
            # every group with a batch verifier plans through it, the
            # one-signature ones too, so the ladder is the one decision
            # point and routes the coalesced size
            if crypto_batch.supports_batch_verifier(pk0):
                verifier = (self._factory(pk0) if self._factory is not None
                            else crypto_batch.create_batch_verifier(pk0))
                for r in reqs:
                    verifier.add(r.pub_key, r.msg, r.sig)
                plan_fn = getattr(verifier, "plan", None)
                if plan_fn is not None:
                    plan = plan_fn()
            groups.append((reqs, verifier, plan))
        return groups

    # -- the launcher (device phase: buffer N) ------------------------------

    def _next_prepared(self) -> _Prepared | None:
        with self._qmtx:
            for p in _PRIORITIES:
                if self._prepared[p]:
                    return self._prepared[p].popleft()
        return None

    def _launch_done(self) -> bool:
        with self._qmtx:
            if not self._draining:
                return False
            if any(self._prepared.values()) or any(self._pending.values()):
                return False
        t = self._collector_thread
        return t is None or not t.is_alive()

    def _launcher(self) -> None:
        while True:
            prep = self._next_prepared()
            if prep is None:
                if self._launch_done():
                    return
                self._launcher_wake.wait(0.05)
                self._launcher_wake.clear()
                continue
            self._collector_wake.set()  # a slot is free: prepare buffer N+1
            self._execute(prep)

    def _execute(self, prep: _Prepared) -> None:
        t0 = time.perf_counter()
        with self._qmtx:
            self._launch_active += 1
            if self._launch_active == 1:
                self._launch_t0 = t0
                self._overlap_accum = 0.0
        try:
            with _tracer.span("verify_queue/launch", cat="crypto", batch=len(prep.reqs),
                              priority=prep.priority):
                for reqs, verifier, plan in prep.groups:
                    self._execute_group(reqs, verifier, plan)
        finally:
            now = time.perf_counter()
            wall = max(now - t0, 0.0)
            with self._qmtx:
                self._launch_active -= 1
                if self._prep_since is not None:
                    # a prep is still running: credit its overlap with
                    # this launch now and move its mark
                    self._overlap_accum += max(0.0, now - max(self._prep_since, t0))
                    self._prep_since = now
                overlap = min(self._overlap_accum, wall)
                self._overlap_accum = 0.0
                self._overlap_seconds += overlap
                self._launch_wall_seconds += wall
                self._stats["launched_batches"] += 1
                self._stats["launched_sigs"] += len(prep.reqs)
                # cumulative: overlapped prep seconds over launch wall
                ratio = (min(self._overlap_seconds / self._launch_wall_seconds, 1.0)
                         if self._launch_wall_seconds > 0 else 0.0)
                self._last_overlap = ratio
                inflight = self._launch_active + sum(len(d) for d in self._prepared.values())
            _crypto_metrics().verify_queue_inflight.set(inflight)
            _health_metrics().host_device_overlap_ratio.set(ratio)

    def _execute_group(self, reqs, verifier, plan) -> None:
        try:
            if self._launch is not None:
                results = self._launch([(r.pub_key, r.msg, r.sig) for r in reqs])
            elif verifier is not None:
                if plan is not None:
                    _, results = verifier.execute(plan)
                else:
                    _, results = verifier.verify()
            else:
                # a key type with no batch verifier: per signature, one
                # ladder sample without a shape (it must not time the
                # host tier)
                from cometbft_tpu_torch.crypto.dispatch import LADDER as _ladder

                _ladder.note_batch("host")
                results = [r.pub_key.verify_signature(r.msg, r.sig) for r in reqs]
            results = list(results)
        except Exception as exc:  # noqa: BLE001 -- the callers get it
            self.logger.error("verify-queue launch failed: %r (batch %d)", exc, len(reqs))
            with self._qmtx:
                self._stats["failed_batches"] += 1
            for r in reqs:
                r.future._fail(exc)
            return
        if len(results) != len(reqs):
            exc = RuntimeError(f"launch returned {len(results)} results for "
                               f"{len(reqs)} requests")
            self.logger.error("verify-queue launch result mismatch: %s", exc)
            with self._qmtx:
                self._stats["failed_batches"] += 1
            for r in reqs:
                r.future._fail(exc)
            return
        for r, bit in zip(reqs, results):
            bit = bool(bit)
            if self.cache is not None and r.key is not None:
                self.cache.store(r.key, bit)
            r.future._resolve(bit)

    # -- introspection -------------------------------------------------------

    def stats(self) -> dict:
        with self._qmtx:
            out = {
                "submitted": dict(self._stats["submitted"]),
                "cache_resolved": self._stats["cache_resolved"],
                "prepared_batches": self._stats["prepared_batches"],
                "launched_batches": self._stats["launched_batches"],
                "launched_sigs": self._stats["launched_sigs"],
                "failed_batches": self._stats["failed_batches"],
                "pending": {p: len(d) for p, d in self._pending.items()},
                "prepared": {p: len(d) for p, d in self._prepared.items()},
                "overlap_ratio": self._last_overlap,
                "draining": self._draining,
            }
        out["cache_entries"] = len(self.cache) if self.cache else 0
        return out


# -- the process-wide queue and its helpers ---------------------------------

_install_mtx = cmtsync.Mutex()
_QUEUE: VerifyQueue | None = None


def install_queue(queue: VerifyQueue | None) -> None:
    """Install the process-wide queue, or uninstall it with None (a
    queue's stop does this)."""
    global _QUEUE
    with _install_mtx:
        _QUEUE = queue


def speculation_active() -> bool:
    """True while a queue is installed and accepting."""
    q = _QUEUE
    return q is not None and q.accepting()


def cached_result(pub: bytes, msg: bytes, sig: bytes, key: bytes | None = None) -> bool | None:
    """True when this exact triple already verified valid, else None.
    ``key``: a precomputed ``cache_key``."""
    q = _QUEUE
    if q is None or q.cache is None:
        return None
    result = q.cache.lookup(key if key is not None else cache_key(pub, msg, sig))
    _crypto_metrics().verify_queue_spec_cache.labels(
        result="hit" if result is not None else "miss").inc()
    return result


def record_result(pub: bytes, msg: bytes, sig: bytes, ok: bool,
                  key: bytes | None = None) -> None:
    """Feed a verdict obtained elsewhere into the cache (True only)."""
    q = _QUEUE
    if q is not None and q.cache is not None:
        q.cache.store(key if key is not None else cache_key(pub, msg, sig), bool(ok))


def _verify_inline(q: VerifyQueue | None, items) -> list[bool]:
    """The synchronous path, cache-aware: cached triples resolve from the
    cache, fresh valid verdicts feed it."""
    out: list[bool] = []
    for pk, msg, sig in items:
        key = None
        if q is not None:
            pkb = pk.bytes()
            key = cache_key(pkb, msg, sig)
            if cached_result(pkb, msg, sig, key=key) is True:
                out.append(True)
                continue
        ok = pk.verify_signature(msg, sig)
        if key is not None and ok:
            record_result(pkb, msg, sig, ok, key=key)
        out.append(ok)
    return out


def _collect(items, futs, timeout: float) -> tuple[list[bool], int]:
    """Wait for a submission's futures under one shared deadline; an item
    whose future raises QueueUnavailable is verified inline -> (verdicts,
    items verified inline).  Any other exception reaches the caller."""
    out: list[bool] = []
    n_inline = 0
    deadline = time.monotonic() + timeout
    for (pk, msg, sig), fut in zip(items, futs):
        try:
            out.append(fut.result(max(0.0, deadline - time.monotonic())))
        except QueueUnavailable:
            out.append(pk.verify_signature(msg, sig))
            n_inline += 1
    return out, n_inline


def verify_or_fallback(items, priority: str = PRIORITY_CONSENSUS,
                       timeout: float = DEFAULT_WAIT_S) -> list[bool]:
    """Verify (pub_key, msg, sig) tuples through the queue as one
    submission; with no queue, a draining one or a timeout, the item is
    verified inline with ``pub_key.verify_signature``.  A consensus
    submission never waits behind a consensus or prefetch buffer or a
    launch: while the queue is ``busy()`` it verifies inline (and still
    feeds the cache).  It can wait behind one light_client or ingest
    prepare already running, as in the reference."""
    q = _QUEUE
    if q is None:
        return [pk.verify_signature(msg, sig) for pk, msg, sig in items]
    try:
        futs = q.submit_many(items, priority, unless_busy=priority == PRIORITY_CONSENSUS)
    except QueueUnavailable:
        return _verify_inline(q, items)
    if futs is None:
        return _verify_inline(q, items)
    return _collect(items, futs, timeout)[0]


def checktx_verify_or_fallback(items, timeout: float = DEFAULT_WAIT_S) -> tuple[list[bool], int]:
    """Mempool admission through the ``ingest`` lane (it waits behind
    work in flight: waiting is what fills its batch) -> (verdicts, items
    verified inline)."""
    return _lane_verify(items, PRIORITY_INGEST, timeout)


def light_verify_or_fallback(items, timeout: float = DEFAULT_WAIT_S) -> tuple[list[bool], int]:
    """Light-client header serving through the ``light_client`` lane,
    with ``checktx_verify_or_fallback``'s contract."""
    return _lane_verify(items, PRIORITY_LIGHT, timeout)


def _lane_verify(items, priority: str, timeout: float) -> tuple[list[bool], int]:
    q = _QUEUE
    if q is None:
        return _verify_inline(None, items), len(items)
    try:
        futs = q.submit_many(items, priority)
    except QueueUnavailable:
        return _verify_inline(q, items), len(items)
    return _collect(items, futs, timeout)


_LANE_TLS = threading.local()


class submission_lane:
    """While active on this thread, validation routes its signature
    checks through the queue at ``priority`` (the light serving plane's
    seam).  Nests; no effect without an accepting queue."""

    def __init__(self, priority: str) -> None:
        if priority not in _PRIORITIES:
            raise ValueError(f"unknown priority {priority!r}")
        self._priority = priority
        self._prev: str | None = None

    def __enter__(self) -> "submission_lane":
        self._prev = getattr(_LANE_TLS, "lane", None)
        _LANE_TLS.lane = self._priority
        return self

    def __exit__(self, *exc) -> None:
        _LANE_TLS.lane = self._prev


def active_submission_lane() -> str | None:
    """The lane a ``submission_lane`` pinned on this thread, or None
    (also when no queue is accepting)."""
    lane = getattr(_LANE_TLS, "lane", None)
    if lane is None:
        return None
    q = _QUEUE
    if q is None or not q.accepting():
        return None
    return lane


def submit_prefetch(items) -> int:
    """Fire-and-forget prefetch (blocksync replay): verdicts land in the
    cache for the verify_commit that follows -> requests enqueued (0
    when no queue accepts)."""
    q = _QUEUE
    if q is None:
        return 0
    try:
        q.submit_many(items, PRIORITY_PREFETCH)
    except QueueUnavailable:
        return 0
    return len(items)
