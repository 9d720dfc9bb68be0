"""Concurrency-correctness seam (a copy of cometbft_tpu/utils/sync.py;
the reference's race/deadlock tooling: `go test -race`, the `deadlock`
build tag swapping cmtsync.Mutex for go-deadlock, fortytw2/leaktest).

CPython's GIL rules out Go-style torn writes on single attributes, but
lock-ordering deadlocks, lost updates, and invariant races across
threads are just as real here.  Four tools, all zero-cost when
disabled (the factories return plain threading locks):

- ``Mutex()`` / ``RMutex()``: in deadlock mode every acquire gets a
  watchdog timeout (``timeout_s``, default 30): on expiry it dumps
  every thread's stack and raises PotentialDeadlock instead of
  hanging the node forever.  The port's core components construct
  their locks through this seam wherever the reference does.
- Lockgraph mode (go-deadlock's lock-order detection): every acquire
  records the thread's held-lock set into a global acquisition-order
  graph.  A cycle — lock B acquired under A somewhere, A acquired
  under B somewhere else — is reported immediately with BOTH
  acquisition stacks and raised as LockOrderError, even if the
  interleaving that would actually deadlock never fires in this run.
- Race mode (a GIL-aware TSan-lite): classes decorated with
  ``@guarded`` declare a ``_GUARDED_BY = {"field": "_mtx"}`` registry;
  every access to a registered field records (thread, guard-held).  An
  UNGUARDED WRITE observed cross-thread raises RaceError with both
  access stacks.  Unguarded reads are not judged: under the GIL they
  cannot tear.
- ``assert_no_thread_leaks()``: leaktest-style context manager —
  snapshots live threads on entry and fails if new non-daemon threads
  survive exit (after a grace period for teardown races).

Where the port departs from its reference: the reference reads its
modes from ``CMT_TPU_DEADLOCK``, ``CMT_TPU_DEADLOCK_TIMEOUT``,
``CMT_TPU_LOCKGRAPH`` and ``CMT_TPU_RACE`` at import; the port reads no
environment variable and takes them from one call,
:func:`configure`, made before the locks it should cover are created
(a lock keeps the kind it was made with).  Because the modes are set
after import, ``@guarded`` registers its class and :func:`configure`
instruments (or restores) every registered class when race mode turns
on (or off).
"""

from __future__ import annotations

import itertools
import os
import sys
import threading
import time
import traceback
import weakref

_ENABLED = False
_TIMEOUT = 30.0
_LOCKGRAPH = False
_RACE = False


def configure(
    deadlock: bool = False,
    timeout_s: float = 30.0,
    lockgraph: bool = False,
    race: bool = False,
) -> None:
    """Set the debug modes (all off by default).  Locks made after the
    call carry them; with every mode off ``Mutex()``/``RMutex()`` return
    plain ``threading`` locks.  Turning race mode on instruments every
    ``@guarded`` class; turning it off restores them."""
    global _ENABLED, _TIMEOUT, _LOCKGRAPH, _RACE
    if timeout_s < 0.001:
        raise ValueError(f"timeout_s must be >= 0.001, got {timeout_s}")
    _ENABLED, _TIMEOUT, _LOCKGRAPH = bool(deadlock), float(timeout_s), bool(lockgraph)
    if bool(race) != _RACE:
        _RACE = bool(race)
        for cls in _GUARDED_CLASSES:
            (_instrument if _RACE else _restore)(cls)


class PotentialDeadlock(Exception):
    """An acquire exceeded the deadlock watchdog timeout."""


class LockOrderError(Exception):
    """Two locks are acquired in both orders somewhere in the program —
    a potential ABBA deadlock, even if this run never interleaved into
    the actual hang (go-deadlock's lock-order report)."""


class RaceError(Exception):
    """A guarded field was written without its guard while another
    thread also touches it — a lost-update/invariant race the GIL does
    not prevent."""


def _dump_all_stacks() -> str:
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for tid, frame in sys._current_frames().items():
        out.append(f"--- thread {names.get(tid, '?')} ({tid}) ---")
        out.extend(
            line.rstrip() for line in traceback.format_stack(frame)
        )
    return "\n".join(out)


# -- per-thread held-lock tracking (lockgraph + race modes) -------------

_tls = threading.local()


def _held_locks() -> list:
    lst = getattr(_tls, "held", None)
    if lst is None:
        lst = []
        _tls.held = lst
    return lst


def _held_remove(lock) -> None:
    held = _held_locks()
    for i in range(len(held) - 1, -1, -1):
        if held[i] is lock:
            del held[i]
            return


# -- acquisition-order graph (lockgraph mode) ----------------------------
#
# Nodes are lock identities (a monotonic token, immune to id() reuse);
# a directed edge a->b means "b was acquired while a was held", stamped
# with the stack that first created it.  A new edge whose reverse path
# already exists is a potential ABBA deadlock.

_graph_mtx = threading.Lock()  # guards the dicts below; deliberately
# a RAW lock — the graph must never instrument itself
_order_adj: dict[int, set[int]] = {}
_order_edge_stacks: dict[tuple[int, int], str] = {}
_lock_names: dict[int, str] = {}
_lock_refs: dict[int, "weakref.ref"] = {}  # gid -> wrapper (liveness)
_gid_counter = itertools.count(1)
_MAX_EDGES = 20_000  # sweep threshold: per-height locks (VoteSet et
# al. mint a fresh Mutex every height) would otherwise grow the graph
# without bound on soak runs; dead locks' edges are garbage-collected
# at the threshold so detection stays LIVE instead of going blind
_graph_saturated = False


def _sweep_dead_locks() -> None:
    """Drop nodes/edges whose lock has been garbage-collected (holds
    _graph_mtx)."""
    dead = {g for g, ref in _lock_refs.items() if ref() is None}
    if not dead:
        return
    for g in dead:
        _lock_refs.pop(g, None)
        _lock_names.pop(g, None)
        _order_adj.pop(g, None)
    for g, nxt in _order_adj.items():
        nxt -= dead
    for key in [
        k for k in _order_edge_stacks if k[0] in dead or k[1] in dead
    ]:
        del _order_edge_stacks[key]


def _find_path(src: int, dst: int) -> list[int] | None:
    """DFS over the order graph; returns the node path src..dst."""
    stack = [(src, [src])]
    seen = {src}
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        for nxt in _order_adj.get(node, ()):
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _lock_name(gid: int) -> str:
    return _lock_names.get(gid, f"lock#{gid}")


def _note_order(lock, held: list) -> None:
    """Record held->lock edges; raise on a cycle.  Called BEFORE the
    actual acquire so a potential deadlock is caught even when this
    run's interleaving would have sailed through."""
    b = lock._gid
    stack_now = None  # captured only when a NEW edge appears (hot path
    # re-walks known edges on every acquire; stacks are debug payload)
    with _graph_mtx:
        for h in held:
            a = h._gid
            if a == b or (a, b) in _order_edge_stacks:
                continue
            if stack_now is None:
                stack_now = "".join(traceback.format_stack(limit=16)[:-2])
            path = _find_path(b, a)
            if path is not None:
                first_edge = (path[0], path[1])
                prior = _order_edge_stacks.get(first_edge, "<unknown>")
                chain = " -> ".join(_lock_name(g) for g in path + [b])
                msg = (
                    "POTENTIAL LOCK-ORDER CYCLE: acquiring "
                    f"{_lock_name(b)} while holding {_lock_name(a)}, "
                    f"but the reverse order {chain} is already "
                    "established\n"
                    f"--- this acquisition ({threading.current_thread().name}):\n"
                    f"{stack_now}"
                    f"--- prior acquisition of {_lock_name(path[1])} "
                    f"under {_lock_name(path[0])}:\n{prior}"
                )
                # the flight recorder tail rides along: what the node
                # was DOING when the cycle appeared (utils/flight.py)
                from cometbft_tpu_torch.utils.flight import flight_tail

                msg += flight_tail()
                sys.stderr.write(msg + "\n")
                raise LockOrderError(msg)
            if len(_order_edge_stacks) >= _MAX_EDGES:
                _sweep_dead_locks()
            if len(_order_edge_stacks) < _MAX_EDGES:
                _order_edge_stacks[(a, b)] = stack_now
                _order_adj.setdefault(a, set()).add(b)
            else:
                global _graph_saturated
                if not _graph_saturated:  # warn ONCE, don't go blind silently
                    _graph_saturated = True
                    sys.stderr.write(
                        "cmtsync: lock-order graph saturated "
                        f"({_MAX_EDGES} edges, all locks live) — new "
                        "order edges are no longer recorded\n"
                    )


def lock_order_edges() -> list[tuple[str, str]]:
    """The recorded acquisition-order edges as (held, acquired) name
    pairs, recorded while lockgraph mode is on."""
    with _graph_mtx:
        return sorted(
            (_lock_name(a), _lock_name(b)) for a, b in _order_edge_stacks
        )


def _reset_lock_graph() -> None:
    """Test helper: drop all recorded edges."""
    global _graph_saturated
    with _graph_mtx:
        _order_adj.clear()
        _order_edge_stacks.clear()
        _lock_names.clear()
        _lock_refs.clear()
        _graph_saturated = False


# -- race detection (race mode) ------------------------------------------
#
# Keyed by (id(obj), field) -> (objref, {thread_id: access_record});
# one record per thread, so a same-thread access can never mask an
# earlier cross-thread one (``x += 1`` reads before it writes — a
# single-slot record would overwrite the other thread's entry and the
# write would then only be compared against our own read).  The
# weakref invalidates stale entries when id() is reused.  A record
# whose thread has exited is dropped at compare time — a dead thread's
# access happened-before ours (the start/join handoff pattern), and
# thread idents get reused.  Record layout:
# (guard_held, is_write, thread_obj, stack)

_race_mtx = threading.Lock()  # raw on purpose, like _graph_mtx
_race_state: dict[tuple[int, str], tuple] = {}
_MAX_RACE_ENTRIES = 65_536
_MAX_THREADS_PER_FIELD = 16


def _race_note(obj, field: str, lockname: str, is_write: bool) -> None:
    try:
        lock = object.__getattribute__(obj, lockname)
    except AttributeError:
        return  # guard not constructed yet
    if not isinstance(lock, _WatchdogLock):
        return  # plain lock: ownership unknowable, nothing to judge
    held = any(h is lock for h in _held_locks())
    tid = threading.get_ident()
    stack = "".join(traceback.format_stack(limit=12)[:-2])
    me = threading.current_thread()
    tname = me.name
    key = (id(obj), field)
    with _race_mtx:
        entry = _race_state.get(key)
        if entry is not None and entry[0] is not None and entry[0]() is not obj:
            entry = None  # id() reuse: records belong to a dead object
        if entry is None:
            try:
                ref = weakref.ref(obj)
            except TypeError:
                ref = None
            if len(_race_state) >= _MAX_RACE_ENTRIES:
                _race_state.clear()
            entry = (ref, {})
            _race_state[key] = entry
        records = entry[1]
        for other_tid, rec in list(records.items()):
            if other_tid == tid:
                continue
            o_held, o_write, o_thread, o_stack = rec
            if not o_thread.is_alive():
                # exited thread: its access happened-before this one
                # (and its ident may be reused) — retire the record
                del records[other_tid]
                continue
            o_name = o_thread.name
            if (is_write and not held) or (o_write and not o_held):
                kind_now = "write" if is_write else "read"
                kind_prev = "write" if o_write else "read"
                msg = (
                    f"RACE on {type(obj).__name__}.{field} (guarded by "
                    f"{lockname}): {kind_now} "
                    f"{'WITHOUT' if not held else 'with'} the guard on "
                    f"thread {tname}, racing a {kind_prev} "
                    f"{'WITHOUT' if not o_held else 'with'} the guard on "
                    f"thread {o_name}\n"
                    f"--- this access ({tname}):\n{stack}"
                    f"--- previous access ({o_name}):\n{o_stack}"
                )
                from cometbft_tpu_torch.utils.flight import flight_tail

                msg += flight_tail()
                sys.stderr.write(msg + "\n")
                raise RaceError(msg)
        if len(records) >= _MAX_THREADS_PER_FIELD:
            records.clear()
        records[tid] = (held, is_write, me, stack)


def _reset_race_state() -> None:
    """Test helper: forget all recorded accesses."""
    with _race_mtx:
        _race_state.clear()


#: every class ``@guarded`` has seen, in decoration order
_GUARDED_CLASSES: list = []
_ORIG = "_cmt_race_orig"  # the class's own (__init__, __setattr__,
# __getattribute__) entries before instrumentation, None where inherited


def guarded(cls):
    """Class decorator for runtime guarded-by checking in race mode.
    Registers ``cls``; when race mode is (or later turns) on, reads its
    ``_GUARDED_BY`` registry ({field: lock_attr}, merged over the MRO)
    and intercepts attribute access so an unguarded cross-thread write
    raises RaceError with both stacks.  With race mode off the class is
    left unchanged, so production classes carry zero overhead."""
    _GUARDED_CLASSES.append(cls)
    if _RACE:
        _instrument(cls)
    return cls


def _instrument(cls) -> None:
    if _ORIG in cls.__dict__:
        return
    gb: dict[str, str] = {}
    for klass in reversed(cls.__mro__):
        gb.update(getattr(klass, "_GUARDED_BY", None) or {})
    if not gb:
        return

    orig_init = cls.__init__
    orig_setattr = cls.__setattr__
    orig_getattribute = cls.__getattribute__

    def __init__(self, *args, **kwargs):
        orig_init(self, *args, **kwargs)
        # accesses during construction are single-threaded by
        # definition; arm the checker only once the object can escape
        object.__setattr__(self, "_cmt_race_live", True)

    def __setattr__(self, name, value):
        if name in gb and object.__getattribute__(self, "__dict__").get(
            "_cmt_race_live"
        ):
            _race_note(self, name, gb[name], True)
        orig_setattr(self, name, value)

    def __getattribute__(self, name):
        if name in gb and object.__getattribute__(self, "__dict__").get(
            "_cmt_race_live"
        ):
            _race_note(self, name, gb[name], False)
        return orig_getattribute(self, name)

    own = tuple(
        cls.__dict__.get(n) for n in ("__init__", "__setattr__", "__getattribute__")
    )
    setattr(cls, _ORIG, own)
    cls.__init__ = __init__
    cls.__setattr__ = __setattr__
    cls.__getattribute__ = __getattribute__


def _restore(cls) -> None:
    own = cls.__dict__.get(_ORIG)
    if own is None:
        return
    for name, fn in zip(("__init__", "__setattr__", "__getattribute__"), own):
        if fn is None:
            delattr(cls, name)
        else:
            setattr(cls, name, fn)
    delattr(cls, _ORIG)


# -- the instrumented lock wrapper --------------------------------------


class _WatchdogLock:
    """Lock wrapper carrying the debug instrumentation: watchdog
    timeout (go-deadlock's DeadlockTimeout behavior) when constructed
    with one, plus held-set/order-graph bookkeeping whenever lockgraph
    or race mode is on."""

    __slots__ = (
        "_lock", "_timeout", "_owner_stack", "_gid", "name", "__weakref__",
    )

    def __init__(self, inner, timeout: float | None = None, name: str = ""):
        self._lock = inner
        self._timeout = timeout
        self._owner_stack = ""
        self._gid = next(_gid_counter)
        self.name = name or f"lock#{self._gid}"
        if _LOCKGRAPH:
            with _graph_mtx:
                _lock_names[self._gid] = self.name
                _lock_refs[self._gid] = weakref.ref(self)

    def acquire(self, blocking: bool = True, timeout: float = -1):
        track = _LOCKGRAPH or _RACE
        held = _held_locks() if track else None
        reentrant = track and any(h is self for h in held)
        if _LOCKGRAPH and blocking and not reentrant:
            # order edges are recorded (and cycles raised) BEFORE
            # blocking, so a potential deadlock is caught even when
            # this run's interleaving would not actually hang
            _note_order(self, held)
        ok = self._acquire_inner(blocking, timeout)
        if ok and track:
            held.append(self)
        return ok

    def _acquire_inner(self, blocking: bool, timeout: float):
        if not blocking:
            ok = self._lock.acquire(False)
            if ok and self._timeout is not None:
                self._remember()
            return ok
        if self._timeout is None:  # no watchdog: plain blocking acquire
            return self._lock.acquire(
                True, timeout if timeout not in (-1, None) else -1
            )
        limit = self._timeout if timeout in (-1, None) else min(
            timeout, self._timeout
        )
        ok = self._lock.acquire(True, limit)
        if not ok and timeout not in (-1, None) and timeout <= self._timeout:
            # the CALLER's finite timeout was the binding constraint —
            # timed-acquire semantics must be preserved in debug mode:
            # return False, don't diagnose a deadlock that isn't one
            return False
        if not ok:
            dump = _dump_all_stacks()
            sys.stderr.write(
                f"POTENTIAL DEADLOCK: lock held for > {limit}s\n"
                f"last acquirer:\n{self._owner_stack}\n"
                f"all threads:\n{dump}\n"
            )
            raise PotentialDeadlock(
                f"could not acquire lock within {limit}s "
                f"(last acquired at:\n{self._owner_stack})"
            )
        self._remember()
        return True

    def _remember(self) -> None:
        self._owner_stack = "".join(traceback.format_stack(limit=6)[:-1])

    def release(self) -> None:
        if _LOCKGRAPH or _RACE:
            _held_remove(self)
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        fn = getattr(self._lock, "locked", None)
        if fn is not None:  # Lock always; RLock only on Python >= 3.14
            return fn()
        if self._lock._is_owned():
            return True
        if self._lock.acquire(False):
            self._lock.release()
            return False
        return True

    # threading.Condition probes the lock for _is_owned /
    # _release_save / _acquire_restore and falls back to generic
    # (non-reentrant-safe) versions on AttributeError.  Forward
    # them when the inner lock provides them (RLock) so
    # Condition(RMutex()) keeps correct ownership semantics —
    # the generic fallback's acquire(False) probe succeeds
    # REENTRANTLY on an owned RLock and concludes it is unheld.
    # Implemented as real methods (not bare forwarding) so cond.wait's
    # release/reacquire keeps the held-set bookkeeping consistent.

    def _is_owned(self):
        fn = getattr(self._lock, "_is_owned", None)
        if fn is not None:
            return fn()
        # plain-Lock probe, same semantics as Condition's own fallback
        if self._lock.acquire(False):
            self._lock.release()
            return False
        return True

    def _release_save(self):
        fn = getattr(self._lock, "_release_save", None)
        if fn is not None:
            depth = 0
            if _LOCKGRAPH or _RACE:
                # RLock._release_save drops EVERY recursion level; the
                # held-set must drop (and later restore) the same count
                # or a guarded write after cond.wait inside a nested
                # `with` would be misjudged as unguarded
                held = _held_locks()
                depth = sum(1 for h in held if h is self)
                held[:] = [h for h in held if h is not self]
            return ("cmtsync-rlock", depth, fn())
        if _LOCKGRAPH or _RACE:
            _held_remove(self)
        self._lock.release()
        return None

    def _acquire_restore(self, state):
        fn = getattr(self._lock, "_acquire_restore", None)
        if fn is not None:
            tag, depth, inner_state = state
            assert tag == "cmtsync-rlock"
            fn(inner_state)
            if _LOCKGRAPH or _RACE:
                _held_locks().extend([self] * max(depth, 1))
        else:
            # plain-Lock path: a full wrapper acquire, so the watchdog
            # still bounds a cond.wait reacquire and the held-set/order
            # bookkeeping happens in one place
            self.acquire()


def _creation_site() -> str:
    f = sys._getframe(2)
    return f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"


def Mutex():
    """threading.Lock, or the instrumented wrapper when any of the
    debug modes (deadlock / lockgraph / race, :func:`configure`) is
    on."""
    lock = threading.Lock()
    if _ENABLED or _LOCKGRAPH or _RACE:
        return _WatchdogLock(
            lock,
            _TIMEOUT if _ENABLED else None,
            name=_creation_site() if _LOCKGRAPH else "",
        )
    return lock


def RMutex():
    """threading.RLock, or the instrumented wrapper when any of the
    debug modes is on."""
    lock = threading.RLock()
    if _ENABLED or _LOCKGRAPH or _RACE:
        return _WatchdogLock(
            lock,
            _TIMEOUT if _ENABLED else None,
            name=_creation_site() if _LOCKGRAPH else "",
        )
    return lock


class assert_no_thread_leaks:
    """(leaktest analog) fail if the body leaks non-daemon threads.

    with assert_no_thread_leaks(grace=2.0):
        svc = SomeService(); svc.start(); svc.stop()

    ``daemons_too=True`` counts daemon threads as leaks as well — the
    wire plane (MConnection send/recv/ping, switch accept) runs
    entirely on daemon threads, which the default mode would wave
    through; its loopback suites gate with this flag.
    """

    def __init__(self, grace: float = 2.0, daemons_too: bool = False):
        self.grace = grace
        self.daemons_too = daemons_too

    def __enter__(self):
        self._before = set(threading.enumerate())
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            return False
        deadline = time.monotonic() + self.grace
        while True:
            leaked = [
                t
                for t in threading.enumerate()
                if t not in self._before
                and t.is_alive()
                and (self.daemons_too or not t.daemon)
            ]
            if not leaked:
                return False
            if time.monotonic() > deadline:
                raise AssertionError(
                    "leaked non-daemon threads: "
                    + ", ".join(t.name for t in leaked)
                )
            time.sleep(0.05)


__all__ = [
    "LockOrderError",
    "configure",
    "Mutex",
    "PotentialDeadlock",
    "RMutex",
    "RaceError",
    "assert_no_thread_leaks",
    "guarded",
    "lock_order_edges",
]
