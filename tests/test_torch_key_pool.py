"""The port's key-table pool (cometbft_tpu_torch/ops/precompute.py
KeyTableCache) against the JAX reference's, and its snapshot and
concurrency guarantees.

Pages come from a stand-in for ``_build_pages`` that gives each key a
deterministic page, so nothing compiles and no EC arithmetic runs; the
real build is held to the reference in test_torch_precompute.py and to
the kernel in test_torch_build_tables_host.py.

- Policy parity: one sequence of lookups (growth, rotation, a budget
  that forces eviction and compaction, ``cap_bytes=1``) through both
  caches; slot maps, LRU order, free lists, validity, capacities,
  ``stats``, entry memoization and every entry's pages must agree.
- Snapshots: an entry keeps its pages after its keys are evicted and
  their slots reused (copy-on-write) or compacted away.
- Concurrency: a warm ``peek`` returns while a cold build is in flight,
  overlapping cold lookups build each key once, and a build fault
  reaches the caller and releases its latches.  Every wait and join has
  a timeout."""

import hashlib
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cometbft_tpu.ops import precompute as JPR
from cometbft_tpu_torch.ops import field as F
from cometbft_tpu_torch.ops import precompute as PR

KB8 = 32 * 4 * F.NLIMBS * 256 * 4  # bytes of one 8-bit key page
KB4 = 64 * 4 * F.NLIMBS * 16 * 4   # bytes of one 4-bit key page
WAIT_S = 30.0


def _key(i: int) -> bytes:
    return hashlib.sha256(b"pool-%d" % i).digest()


def _page(key: bytes, window_bits: int) -> np.ndarray:
    """The stand-in page of ``key``: (nwin, 4, 26, nent) int32."""
    nwin, nent = 256 // window_bits, 1 << window_bits
    v = int.from_bytes(key[:3], "little")
    return (v + np.arange(nwin * 4 * F.NLIMBS * nent, dtype=np.int64)).astype(
        np.int32).reshape(nwin, 4, F.NLIMBS, nent)


def _pages(missing, window_bits):
    pages = np.concatenate([_page(k, window_bits) for k in missing], axis=-1)
    return pages, np.array([k[0] & 1 == 0 for k in missing], dtype=bool)


class StandIn:
    """``_build_pages`` for a cache: deterministic pages, a record of the
    keys built, and an optional gate that holds a build in flight."""

    def __init__(self, to_device):
        self.to_device = to_device
        self.built: list[bytes] = []
        self.lock = threading.Lock()
        self.started = threading.Event()
        self.gate: threading.Event | None = None
        self.fail = False

    def __call__(self, missing, window_bits):
        with self.lock:
            self.built.extend(missing)
        self.started.set()
        if self.fail:
            self.fail = False
            raise RuntimeError("planted build fault")
        if self.gate is not None:
            assert self.gate.wait(WAIT_S), "the test never released the build"
        pages, valid = _pages(missing, window_bits)
        return self.to_device(pages), valid


def _port_cache(monkeypatch, cap_bytes=PR.TABLE_CACHE_MB << 20):
    cache = PR.KeyTableCache("cpu", cap_bytes=cap_bytes)
    standin = StandIn(torch.from_numpy)
    monkeypatch.setattr(cache, "_build_pages", standin)
    return cache, standin


def _entry_pages(table: np.ndarray, entry_index, window_bits):
    nent = 1 << window_bits
    return {k: table[..., s * nent : (s + 1) * nent] for k, s in entry_index.items()}


def _check_pages(table: np.ndarray, key_index, window_bits):
    for k, page in _entry_pages(table, key_index, window_bits).items():
        np.testing.assert_array_equal(page, _page(k, window_bits))


# Sets of key numbers; with KEY8_MAX = 2, sets of one or two keys take
# the 8-bit pool and larger ones the 4-bit pool.
SEQUENCE = [
    range(0, 5), range(0, 5), range(1, 6), (100, 101), range(10, 22), (100,),
    (*range(1, 6), *range(30, 34)), (102, 103), range(0, 5), range(40, 61),
    range(2, 7), (101, 104), range(10, 22),
]


@pytest.mark.parametrize("cap_bytes", [PR.TABLE_CACHE_MB << 20, 2 * KB8 + 16 * KB4, 1],
                         ids=["default-budget", "evict-and-compact", "one-byte"])
def test_pool_policy_matches_reference(monkeypatch, cap_bytes):
    assert PR.TABLE_CACHE_MB == JPR.TABLE_CACHE_MB
    monkeypatch.setattr(PR, "KEY8_MAX", 2)
    monkeypatch.setattr(JPR, "KEY8_MAX", 2)
    port, _ = _port_cache(monkeypatch, cap_bytes)
    ref = JPR.KeyTableCache(cap_bytes=cap_bytes)
    monkeypatch.setattr(ref, "_build_pages", StandIn(jnp.asarray))
    prev = {}
    for step, nums in enumerate(SEQUENCE):
        pubs = [_key(i) for i in nums]
        e_port, e_ref = port.lookup_or_build(pubs), ref.lookup_or_build(pubs)
        where = f"step {step} ({len(pubs)} keys)"
        assert port.stats == ref.stats, where
        for wb in (8, 4):
            pp, rp = port._pools[wb], ref._pools[wb]
            assert list(pp.slots.items()) == list(rp.slots.items()), where
            assert pp.free == rp.free and pp.cap == rp.cap, where
            assert pp.valid.tolist() == rp.valid.tolist(), where
            assert pp.nbytes() == rp.nbytes() and pp.key_bytes == rp.key_bytes, where
        assert e_port.key_index == e_ref.key_index, where
        assert e_port.valid.tolist() == e_ref.valid.tolist(), where
        assert (e_port.window_bits, e_port.nbytes, e_port.set_nbytes) == (
            e_ref.window_bits, e_ref.nbytes, e_ref.set_nbytes), where
        h = e_port.sethash
        assert (prev.get(h, (None, None))[0] is e_port) == (
            prev.get(h, (None, None))[1] is e_ref), where
        prev[h] = (e_port, e_ref)
        _check_pages(e_port.table.numpy(), e_port.key_index, e_port.window_bits)
        _check_pages(np.asarray(e_ref.table), e_ref.key_index, e_ref.window_bits)
        assert (port.peek(pubs) is None) == (ref.peek(pubs) is None), where
    if cap_bytes == 1:
        # everything but the active set is evicted at every lookup
        assert sum(len(p.slots) for p in port._pools.values()) == len(SEQUENCE[-1])
    assert port.stats["keys_evicted"] == ref.stats["keys_evicted"]
    assert (port.stats["keys_evicted"] > 0) == (cap_bytes != PR.TABLE_CACHE_MB << 20)


def test_entry_survives_eviction_and_slot_reuse(monkeypatch):
    """Budget of 7 pages against a pool of 8: each rotation evicts the
    key rotated out and the pool never compacts, so the next new key
    takes an evicted key's slot -- written into a copy of the pool, not
    into the tensor an older entry reads."""
    monkeypatch.setattr(PR, "KEY8_MAX", 1)
    cache, _ = _port_cache(monkeypatch, cap_bytes=7 * KB4)
    keys = [_key(i) for i in range(8)]
    e1 = cache.lookup_or_build(keys[0:5])
    before = {k: p.copy() for k, p in _entry_pages(e1.table.numpy(), e1.key_index, 4).items()}
    e2 = cache.lookup_or_build(keys[1:6])  # key 5 into a slot never used: in place
    assert e2.table is e1.table
    assert cache.stats == {"keys_built": 6, "keys_evicted": 1}
    e3 = cache.lookup_or_build(keys[2:7])  # key 6 into key 0's slot: a new tensor
    assert e3.key_index[keys[6]] == e1.key_index[keys[0]]
    assert e3.table is not e1.table
    assert cache.stats == {"keys_built": 7, "keys_evicted": 2}
    assert cache._pools[4].cap == 8
    after = _entry_pages(e1.table.numpy(), e1.key_index, 4)
    for k in keys[0:5]:
        np.testing.assert_array_equal(after[k], before[k])
    _check_pages(e1.table.numpy(), e1.key_index, 4)
    _check_pages(e2.table.numpy(), e2.key_index, 4)
    _check_pages(e3.table.numpy(), e3.key_index, 4)
    assert e3.valid[e3.key_index[keys[6]]] == (keys[6][0] & 1 == 0)
    assert e1.valid[e1.key_index[keys[0]]] == (keys[0][0] & 1 == 0)


def test_entry_survives_compaction(monkeypatch):
    monkeypatch.setattr(PR, "KEY8_MAX", 1)
    cache, _ = _port_cache(monkeypatch, cap_bytes=8 * KB4)
    keys = [_key(i) for i in range(12)]
    e1 = cache.lookup_or_build(keys[0:5])
    e2 = cache.lookup_or_build(keys[8:12])  # 9 keys: grow to 16, evict 1, compact to 8
    pool = cache._pools[4]
    assert pool.cap == 8 and len(pool.slots) == 8
    assert cache.stats == {"keys_built": 9, "keys_evicted": 1}
    # the least recently used: lookups touch a set's keys in sorted order
    assert sorted(keys[0:5])[0] not in pool.slots and e2.table is pool.table
    assert e1.table is not pool.table and e1.table.shape[-1] == 8 * 16
    _check_pages(e1.table.numpy(), e1.key_index, 4)
    _check_pages(e2.table.numpy(), e2.key_index, 4)
    # the memo dropped e1 (stale version): a new lookup gives a new entry
    # on the compacted pool, with the evicted key rebuilt
    e1b = cache.lookup_or_build(keys[0:5])
    assert e1b is not e1 and cache.stats["keys_built"] == 10
    _check_pages(e1b.table.numpy(), e1b.key_index, 4)


def _run(fn, out: dict, name: str) -> threading.Thread:
    def body():
        try:
            out[name] = fn()
        except BaseException as exc:  # handed to the test thread, which raises it
            out[name] = exc

    t = threading.Thread(target=body, daemon=True)
    t.start()
    return t


def _joined(t: threading.Thread, out: dict, name: str):
    t.join(WAIT_S)
    assert not t.is_alive(), f"{name} did not finish within {WAIT_S} s"
    if isinstance(out[name], BaseException):
        raise out[name]
    return out[name]


def test_warm_peek_never_waits_on_a_cold_build(monkeypatch):
    monkeypatch.setattr(PR, "KEY8_MAX", 1)
    cache, standin = _port_cache(monkeypatch)
    warm, cold = [_key(i) for i in range(5)], [_key(i) for i in range(10, 15)]
    e_warm = cache.lookup_or_build(warm)
    standin.gate, out = threading.Event(), {}
    standin.started.clear()
    t = _run(lambda: cache.lookup_or_build(cold), out, "cold")
    try:
        assert standin.started.wait(WAIT_S)
        t0 = time.monotonic()
        assert cache.peek(warm) is e_warm
        assert cache.peek(cold) is None
        assert time.monotonic() - t0 < 5.0
    finally:
        standin.gate.set()
    e_cold = _joined(t, out, "cold")
    assert sorted(e_cold.key_index) == sorted(cold)
    assert cache.peek(cold) is e_cold


def test_overlapping_cold_lookups_build_each_key_once(monkeypatch):
    monkeypatch.setattr(PR, "KEY8_MAX", 1)
    cache, standin = _port_cache(monkeypatch)
    s1, s2 = [_key(i) for i in range(0, 6)], [_key(i) for i in range(3, 9)]
    standin.gate, out = threading.Event(), {}
    ta = _run(lambda: cache.lookup_or_build(s1), out, "a")
    try:
        assert standin.started.wait(WAIT_S)
        tb = _run(lambda: cache.lookup_or_build(s2), out, "b")
        time.sleep(0.2)
        # the second lookup waits on the first's latches and has
        # registered none of its own
        with cache._lock:
            assert {k for _, k in cache._pending} == set(s1)
    finally:
        standin.gate.set()
    ea, eb = _joined(ta, out, "a"), _joined(tb, out, "b")
    assert sorted(standin.built) == sorted(set(s1) | set(s2))
    assert cache.stats["keys_built"] == 9
    assert set(ea.key_index) == set(s1) and set(eb.key_index) == set(s2)
    _check_pages(eb.table.numpy(), eb.key_index, 4)


def test_build_fault_propagates_and_releases_latches(monkeypatch):
    monkeypatch.setattr(PR, "KEY8_MAX", 1)
    cache, standin = _port_cache(monkeypatch)
    keys = [_key(i) for i in range(4)]
    standin.fail = True
    with pytest.raises(RuntimeError, match="planted build fault"):
        cache.lookup_or_build(keys)
    assert cache._pending == {} and cache.stats["keys_built"] == 0
    entry = cache.lookup_or_build(keys)
    assert sorted(entry.key_index) == sorted(keys)
    _check_pages(entry.table.numpy(), entry.key_index, 4)
