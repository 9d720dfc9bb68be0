"""utils/sync: the port's lock modes against the reference's.

The reference latches its modes from the environment at import, so its
side is armed the way its own tests arm it (monkeypatching
``_ENABLED``/``_TIMEOUT``/``_LOCKGRAPH``/``_RACE``); the port's side by
``sync.configure``.  Every wait is bounded.
"""

import ast
import os
import re
import threading

import pytest

from cometbft_tpu.utils import sync as ref_sync
from cometbft_tpu_torch.utils import sync as port_sync

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_PKG = os.path.join(REPO, "cometbft_tpu_torch")
REF_PKG = os.path.join(REPO, "cometbft_tpu")


@pytest.fixture
def arm(monkeypatch):
    """arm(deadlock=, timeout_s=, lockgraph=, race=) sets both packages'
    modes; everything is off again (and the graphs empty) afterwards."""

    def _arm(deadlock=False, timeout_s=30.0, lockgraph=False, race=False):
        monkeypatch.setattr(ref_sync, "_ENABLED", deadlock)
        monkeypatch.setattr(ref_sync, "_TIMEOUT", timeout_s)
        monkeypatch.setattr(ref_sync, "_LOCKGRAPH", lockgraph)
        monkeypatch.setattr(ref_sync, "_RACE", race)
        port_sync.configure(deadlock=deadlock, timeout_s=timeout_s,
                            lockgraph=lockgraph, race=race)

    for mod in (ref_sync, port_sync):
        mod._reset_lock_graph()
        mod._reset_race_state()
    yield _arm
    port_sync.configure()
    for mod in (ref_sync, port_sync):
        mod._reset_lock_graph()
        mod._reset_race_state()


def two_locks(mod):
    a = mod.Mutex()
    b = mod.Mutex()
    return a, b


def test_every_mode_off_gives_plain_threading_locks(arm):
    arm()
    assert (port_sync._ENABLED, port_sync._TIMEOUT, port_sync._LOCKGRAPH, port_sync._RACE) == \
        (False, 30.0, False, False)
    for mod in (ref_sync, port_sync):
        assert type(mod.Mutex()) is type(threading.Lock())
        assert type(mod.RMutex()) is type(threading.RLock())
    with pytest.raises(ValueError):
        port_sync.configure(timeout_s=0.0)


@pytest.mark.parametrize("mode", ["deadlock", "lockgraph", "race"])
def test_each_mode_gives_the_watchdog_wrapper(arm, mode):
    arm(**{mode: True})
    for mod in (ref_sync, port_sync):
        m, r = mod.Mutex(), mod.RMutex()
        assert isinstance(m, mod._WatchdogLock) and isinstance(r, mod._WatchdogLock)
        with r:
            with r:             # an RMutex stays reentrant
                assert r.locked()
        assert not m.locked()


def test_planted_inversion_raises_lock_order_error_with_the_same_edges(arm):
    arm(lockgraph=True)
    got = {}
    for mod in (ref_sync, port_sync):
        a, b = two_locks(mod)
        with a:
            with b:
                pass
        with pytest.raises(mod.LockOrderError) as exc:
            with b:
                with a:
                    pass
        assert "POTENTIAL LOCK-ORDER CYCLE" in str(exc.value)
        got[mod] = mod.lock_order_edges()
    assert got[port_sync] == got[ref_sync]
    (held, acquired), = got[port_sync]
    assert held.startswith("test_torch_sync.py:") and acquired != held


def test_order_edges_are_recorded_across_threads(arm):
    arm(lockgraph=True)
    got = {}
    for mod in (ref_sync, port_sync):
        a, b = two_locks(mod)
        c = mod.RMutex()

        def first():
            with a, b, c:
                pass

        t = threading.Thread(target=first)
        t.start()
        t.join(5)
        with a, c:               # a consistent order: no cycle
            pass
        got[mod] = mod.lock_order_edges()
    assert got[port_sync] == got[ref_sync] and len(got[port_sync]) == 3


def test_planted_self_wait_raises_potential_deadlock(arm):
    arm(deadlock=True, timeout_s=0.005)
    for mod in (ref_sync, port_sync):
        lk = mod.Mutex()
        lk.acquire()
        try:
            with pytest.raises(mod.PotentialDeadlock, match="within 0.005s"):
                lk.acquire()
            # a caller's own shorter timeout keeps timed-acquire semantics
            assert lk.acquire(True, 0.001) is False
        finally:
            lk.release()


def _race_class(mod):
    class Counter:
        _GUARDED_BY = {"n": "_mtx"}

        def __init__(self):
            self._mtx = mod.Mutex()
            self.n = 0

    return Counter


def _cross_thread_writes(obj, mod):
    """A guarded write on another thread, then an unguarded one here."""

    def guarded_write():
        with obj._mtx:
            obj.n += 1

    started = threading.Event()
    done = threading.Event()

    def worker():
        guarded_write()
        started.set()
        done.wait(5)             # stay alive: a dead thread's record retires

    t = threading.Thread(target=worker)
    t.start()
    try:
        assert started.wait(5)
        with pytest.raises(mod.RaceError, match="RACE on Counter.n"):
            obj.n = 5
    finally:
        done.set()
        t.join(5)


def test_unguarded_write_to_a_guarded_field_raises_race_error(arm):
    arm(race=True)
    for mod in (ref_sync, port_sync):
        Counter = mod.guarded(_race_class(mod))
        _cross_thread_writes(Counter(), mod)


def test_port_instruments_a_class_decorated_before_race_mode(arm):
    arm()
    Counter = port_sync.guarded(_race_class(port_sync))
    assert "__setattr__" not in Counter.__dict__       # zero cost while off
    arm(race=True)
    assert "__setattr__" in Counter.__dict__
    _cross_thread_writes(Counter(), port_sync)
    arm()
    assert "__setattr__" not in Counter.__dict__ and "__init__" in Counter.__dict__
    c = Counter()
    c.n = 3                                             # no checking once off
    assert c.n == 3


def test_condition_over_an_rmutex_keeps_ownership(arm):
    arm(lockgraph=True, race=True)
    for mod in (ref_sync, port_sync):
        lk = mod.RMutex()
        cond = threading.Condition(lk)
        with lk:
            with cond:
                assert not cond.wait(0.01)
            assert sum(1 for h in mod._held_locks() if h is lk) == 1
        assert not any(h is lk for h in mod._held_locks())


def test_thread_leaks_are_reported_alike():
    for mod in (ref_sync, port_sync):
        stop = threading.Event()
        with pytest.raises(AssertionError, match="leaked non-daemon threads: leaker"):
            with mod.assert_no_thread_leaks(grace=0.1):
                threading.Thread(target=stop.wait, args=(5,), name="leaker").start()
        stop.set()
        with mod.assert_no_thread_leaks(grace=2.0):
            t = threading.Thread(target=lambda: None)
            t.start()


# -- the seams: the port's locks where the reference's are -----------------


def _lock_sites(path: str) -> list[str]:
    """'Mutex' / 'RMutex' for each cmtsync lock made in ``path``."""
    src = open(path).read()
    return re.findall(r"cmtsync\.(R?Mutex)\b(?=\(|,|\))", src)


def _guarded_classes(path: str) -> dict:
    """class name -> _GUARDED_BY, for each @cmtsync.guarded class."""
    tree = ast.parse(open(path).read())
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and any(
            ast.unparse(d) == "cmtsync.guarded" for d in node.decorator_list
        ):
            reg = {}
            for st in node.body:
                if isinstance(st, ast.Assign) and ast.unparse(st.targets[0]) == "_GUARDED_BY":
                    reg = ast.literal_eval(st.value)
            out[node.name] = reg
    return out


def _ported_files():
    for root, _, files in os.walk(PORT_PKG):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), PORT_PKG)
                if os.path.exists(os.path.join(REF_PKG, rel)):
                    yield rel


#: where the port's locks differ from its reference's, and why
LOCK_DEPARTURES = {
    # the reference's process-wide plan singleton (_Netem) is an
    # argument in the port: no lock
    "p2p/conn/netem.py",
    "utils/sync.py",
}


def test_port_locks_where_the_reference_locks_through_cmtsync():
    checked = 0
    for rel in _ported_files():
        if rel in LOCK_DEPARTURES:
            continue
        ref, port = _lock_sites(os.path.join(REF_PKG, rel)), _lock_sites(
            os.path.join(PORT_PKG, rel))
        if not ref:
            continue
        checked += 1
        assert sorted(port) == sorted(ref), rel
    assert checked >= 32


def test_port_guards_the_classes_the_reference_guards():
    seen = set()
    for rel in _ported_files():
        ref = _guarded_classes(os.path.join(REF_PKG, rel))
        port = _guarded_classes(os.path.join(PORT_PKG, rel))
        assert set(port) == set(ref), rel
        for name, reg in ref.items():
            assert port[name] == reg, (rel, name)
            seen.add(name)
    assert {"VoteSet", "EventBus", "ConsensusState", "BlockStore", "Switch",
            "CListMempool", "Pool", "VerifyQueue", "DispatchLadder"} <= seen


def test_a_port_node_lock_follows_the_modes(arm):
    from cometbft_tpu_torch.store import BlockStore
    from cometbft_tpu_torch.utils.db import MemDB

    arm()
    assert type(BlockStore(MemDB())._mtx) is type(threading.RLock())
    arm(lockgraph=True)
    lk = BlockStore(MemDB())._mtx
    assert isinstance(lk, port_sync._WatchdogLock)
    assert lk.name.startswith("__init__.py:")
