"""The port's verify queue (cometbft_tpu_torch/crypto/verify_queue.py)
against the reference's (cometbft_tpu/crypto/verify_queue.py), which
imports no jax.  The same scripted submissions go to both queues through
a gated ``launch=``: the same batches in the same order (consensus
preempting prefetch, the micro-batched lanes coalescing), the same
``stats()`` (its timing-only ``overlap_ratio`` aside), the same cache
behaviour and the same spans.  Tolerance: exact.

Where the port departs on purpose -- a batch that fails with anything
but QueueUnavailable re-raises to the caller instead of being verified
again on the host, and the verifier factory is not guarded -- the tests
say so.  Every wait is bounded and every queue stopped in a finally."""

import threading
import time

import pytest

from cometbft_tpu.crypto import ed25519 as jed
from cometbft_tpu.crypto import verify_queue as jvq
from cometbft_tpu.utils.trace import TRACER as JTRACER
from cometbft_tpu_torch.crypto import dispatch as D
from cometbft_tpu_torch.crypto import ed25519 as ed
from cometbft_tpu_torch.crypto import verify_queue as vq
from cometbft_tpu_torch.crypto.batch import create_batch_verifier
from cometbft_tpu_torch.ops import ed25519_verify as EV
from cometbft_tpu_torch.ops import precompute as PR
from cometbft_tpu_torch.utils.trace import TRACER

WAIT = 10.0


@pytest.fixture(autouse=True)
def clean():
    D.reset_for_tests()
    yield
    for mod in (vq, jvq):
        q = mod._QUEUE
        if q is not None and q.is_running():
            q.stop()
        mod.install_queue(None)
    D.reset_for_tests()


def _until(cond, what="condition"):
    deadline = time.monotonic() + WAIT
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.002)
    raise AssertionError(f"timed out waiting for {what}")


def _fake(pk_cls, tag: bytes, n: int):
    """``n`` (pub_key, msg, sig) items with made-up bytes: a gated
    launch decides their verdicts (a message ending in b"!" is
    invalid)."""
    return [(pk_cls(bytes([i + 1]) * 32), tag + b"-%d" % i + (b"!" if i == 1 else b""),
             bytes([i]) * 64) for i in range(n)]


def _verdicts(items):
    return [not m.endswith(b"!") for _, m, _ in items]


class Gate:
    """A launch that records each batch's messages, then waits until
    ``release`` is set."""

    def __init__(self) -> None:
        self.launched: list[list[bytes]] = []
        self.started = threading.Event()
        self.release = threading.Event()

    def __call__(self, items):
        self.launched.append([m for _, m, _ in items])
        self.started.set()
        assert self.release.wait(WAIT), "gate never released"
        return _verdicts(items)


def _stats(q) -> dict:
    st = q.stats()
    st.pop("overlap_ratio")
    return st


def _spans(tracer) -> list:
    return sorted((e["name"], tuple(sorted(e["args"].items())))
                  for e in tracer.events() if e["name"].startswith("verify_queue/"))


def _preemption(mod, pk_cls, tracer):
    """Prefetch batch A in flight (gated); prefetch B, an ingest batch
    (held by its gate until the drain) and consensus C queued behind it."""
    gate = Gate()
    q = mod.VerifyQueue(launch=gate, spec_cache=mod.SpeculativeCache(1024),
                        checktx_batch=256, checktx_wait_ms=60000,
                        light_batch=1024, light_wait_ms=60000)
    tracer.clear()
    q.start()
    try:
        fa = q.submit_many(_fake(pk_cls, b"a", 4), mod.PRIORITY_PREFETCH)
        assert gate.started.wait(WAIT)
        fb = q.submit_many(_fake(pk_cls, b"b", 3), mod.PRIORITY_PREFETCH)
        fi = q.submit_many(_fake(pk_cls, b"i", 2), mod.PRIORITY_INGEST)
        fc = q.submit_many(_fake(pk_cls, b"c", 2), mod.PRIORITY_CONSENSUS)
        _until(lambda: q.stats()["prepared"]["consensus"] == 1
               and q.stats()["prepared"]["prefetch"] == 1, "both buffers prepared")
        busy = q.busy()
        mid = _stats(q)
        gate.release.set()
        got = [f.result(WAIT) for f in fa + fb + fc]
    finally:
        gate.release.set()
        q.stop()
    got += [f.result(WAIT) for f in fi]
    return gate.launched, busy, mid, _stats(q), got, _spans(tracer)


def test_preemption_matches_reference():
    port = _preemption(vq, ed.Ed25519PubKey, TRACER)
    ref = _preemption(jvq, jed.Ed25519PubKey, JTRACER)
    assert port == ref
    launched = port[0]
    # A in flight, then consensus C before prefetch B; the ingest batch
    # waits for its gate until the drain
    assert [b[0][:1] for b in launched] == [b"a", b"c", b"b", b"i"]
    assert port[1] is True


def _lanes(mod, pk_cls):
    """The micro-batched lanes: ingest coalesces to its target of 4,
    light_client to 3; the rest releases at the drain."""
    gate = Gate()
    gate.release.set()
    q = mod.VerifyQueue(launch=gate, checktx_batch=4, checktx_wait_ms=60000,
                        light_batch=3, light_wait_ms=60000)
    q.start()
    try:
        items = _fake(pk_cls, b"t", 6)
        futs = [q.submit(*it, priority=mod.PRIORITY_INGEST) for it in items[:3]]
        time.sleep(0.05)
        assert gate.launched == []          # under the target: held
        futs.append(q.submit(*items[3], priority=mod.PRIORITY_INGEST))
        _until(lambda: len(gate.launched) == 1, "the ingest batch")
        lfuts = q.submit_many(_fake(pk_cls, b"l", 3), mod.PRIORITY_LIGHT)
        _until(lambda: len(gate.launched) == 2, "the light batch")
        futs += [q.submit(*it, priority=mod.PRIORITY_INGEST) for it in items[4:]]
        got = [f.result(WAIT) for f in futs[:4] + lfuts]
    finally:
        q.stop()
    got += [f.result(WAIT) for f in futs[4:]]
    return gate.launched, _stats(q), got


def test_lane_batching_matches_reference():
    port = _lanes(vq, ed.Ed25519PubKey)
    assert port == _lanes(jvq, jed.Ed25519PubKey)
    assert [len(b) for b in port[0]] == [4, 3, 2]


def _deadline(mod, pk_cls):
    gate = Gate()
    gate.release.set()
    q = mod.VerifyQueue(launch=gate, checktx_batch=1000, checktx_wait_ms=30)
    q.start()
    try:
        futs = q.submit_many(_fake(pk_cls, b"d", 2), mod.PRIORITY_INGEST)
        got = [f.result(WAIT) for f in futs]
        launched = list(gate.launched)
    finally:
        q.stop()
    return launched, _stats(q), got


def test_ingest_deadline_releases_a_half_full_batch():
    port = _deadline(vq, ed.Ed25519PubKey)
    assert port == _deadline(jvq, jed.Ed25519PubKey)
    assert [len(b) for b in port[0]] == [2]


def _cache(mod, pk_cls):
    """Valid verdicts are cached and answer a resubmission without a
    launch; the invalid one is launched again."""
    gate = Gate()
    gate.release.set()
    q = mod.VerifyQueue(launch=gate)
    q.start()
    mod.install_queue(q)
    try:
        items = _fake(pk_cls, b"k", 4)
        first = mod.verify_or_fallback(items, priority=mod.PRIORITY_PREFETCH, timeout=WAIT)
        second = mod.verify_or_fallback(items, priority=mod.PRIORITY_PREFETCH, timeout=WAIT)
        pk, m, s = items[0]
        hit = mod.cached_result(pk.bytes(), m, s)
        pk, m, s = items[1]
        miss = mod.cached_result(pk.bytes(), m, s)
        active = mod.speculation_active()
    finally:
        q.stop()
    return gate.launched, _stats(q), first, second, hit, miss, active, mod.speculation_active()


def test_speculative_cache_matches_reference():
    port = _cache(vq, ed.Ed25519PubKey)
    assert port == _cache(jvq, jed.Ed25519PubKey)
    launched, st, first, second = port[:4]
    assert first == second == [True, False, True, True]
    assert [len(b) for b in launched] == [4, 1]    # only the invalid one again
    assert st["cache_resolved"] == 3 and st["cache_entries"] == 3
    assert port[4:] == (True, None, True, False)


def test_lane_batcher_matches_reference_on_explicit_clocks():
    for target, wait_ms in ((4, 5), (1, 0), (256, 10)):
        p, r = vq._LaneBatcher(target, wait_ms), jvq._LaneBatcher(target, wait_ms)
        lane_p, lane_r = vq.deque(), jvq.deque()
        for t in (0.0, 0.001, 0.003):
            for lane, cls in ((lane_p, vq._Request), (lane_r, jvq._Request)):
                req = cls(None, b"", b"")
                req.t = t
                lane.append(req)
            for now in (0.003, 0.004, 0.006, 0.02):
                for draining in (False, True):
                    assert p.ready(lane_p, draining, now) == r.ready(lane_r, draining, now)
                assert p.deadline_wait(lane_p, now) == r.deadline_wait(lane_r, now)
        assert p.ready(vq.deque(), True) is False
        assert p.deadline_wait(vq.deque()) is None


def test_cache_key_and_speculative_cache_match_reference():
    pc, rc = vq.SpeculativeCache(3), jvq.SpeculativeCache(3)
    for i in range(6):
        key = vq.cache_key(b"p%d" % i, b"m", b"s")
        assert key == jvq.cache_key(b"p%d" % i, b"m", b"s")
        pc.store(key, i != 2)
        rc.store(key, i != 2)
        pc.lookup(vq.cache_key(b"p0", b"m", b"s"))
        rc.lookup(vq.cache_key(b"p0", b"m", b"s"))
    assert list(pc._map) == list(rc._map) and len(pc) == 3


def test_failed_batch_reaches_the_caller():
    """A launch that raises fails its futures with that exception, and
    verify_or_fallback re-raises it (the reference turns it into
    QueueUnavailable and verifies again on the host)."""
    def broken(items):
        raise RuntimeError("kernel launch failed")

    for mod, pk_cls in ((vq, ed.Ed25519PubKey), (jvq, jed.Ed25519PubKey)):
        q = mod.VerifyQueue(launch=broken)
        q.start()
        mod.install_queue(q)
        try:
            items = _fake(pk_cls, b"f", 2)
            if mod is vq:
                with pytest.raises(RuntimeError, match="kernel launch failed"):
                    mod.verify_or_fallback(items, priority=mod.PRIORITY_PREFETCH,
                                           timeout=WAIT)
                fut = q.submit(*items[0], priority=mod.PRIORITY_PREFETCH)
                with pytest.raises(RuntimeError, match="kernel launch failed"):
                    fut.result(WAIT)
                assert q.stats()["failed_batches"] == 2
            else:
                fut = q.submit(*items[0], priority=mod.PRIORITY_PREFETCH)
                with pytest.raises(jvq.QueueUnavailable):
                    fut.result(WAIT)
        finally:
            q.stop()


def _signed(n: int, tag: bytes, bad: int | None = None):
    privs = [ed.priv_key_from_secret(tag + b"%d" % i) for i in range(n)]
    items = []
    for i, p in enumerate(privs):
        m = tag + b"-vote-%d" % i
        s = p.sign(m)
        items.append((p.pub_key(), m + (b"?" if i == bad else b""), s))
    return items


def test_cpu_factory_answers_through_the_ladder():
    """With a factory on the CPU, a batch plans and executes through
    the ladder (the host tier: the CPU's threshold sentinel) and every
    future is the oracle's verdict."""
    items = _signed(4, b"vq-host", bad=2)
    q = vq.VerifyQueue(verifier_factory=lambda pk: create_batch_verifier(pk, device="cpu"))
    q.start()
    vq.install_queue(q)
    try:
        got = vq.verify_or_fallback(items, priority=vq.PRIORITY_PREFETCH, timeout=WAIT)
    finally:
        q.stop()
    assert got == [True, True, False, True]
    assert q.stats()["launched_batches"] == 1 and q.stats()["failed_batches"] == 0


def test_kernel_fault_in_execute_and_the_default_factory_reach_the_caller(monkeypatch):
    """An untyped error of a device tier inside execute() is not walked
    down the ladder and fails the batch; with no card, the default
    factory (cuda) raises, and that fails the batch too: nothing is
    verified on the host in their place."""
    items = _signed(2, b"vq-fault")
    monkeypatch.setattr(PR, "TABLE_MAX_KEYS", 0)     # the generic tier

    def raising(self, tier, plan):
        raise RuntimeError(f"{tier} kernel failed to launch")

    monkeypatch.setattr(EV.TorchBatchVerifier, "_run_tier", raising)
    factory = lambda pk: EV.TorchBatchVerifier(device="cpu", device_min_batch=0)  # noqa: E731
    for kw, match in (({"verifier_factory": factory}, "generic kernel failed"),
                      ({}, "CUDA")):
        q = vq.VerifyQueue(**kw)
        q.start()
        vq.install_queue(q)
        try:
            with pytest.raises(RuntimeError, match=match):
                vq.verify_or_fallback(items, priority=vq.PRIORITY_PREFETCH, timeout=WAIT)
        finally:
            q.stop()
        assert D.LADDER.snapshot()["transitions"] == []


def test_timeout_and_stopped_queue_fall_back_inline():
    items = _signed(2, b"vq-inline", bad=1)
    gate = Gate()
    q = vq.VerifyQueue(launch=gate)
    q.start()
    vq.install_queue(q)
    try:
        got = vq.verify_or_fallback(items, priority=vq.PRIORITY_PREFETCH, timeout=0.1)
        assert got == [True, False]
        with pytest.raises(vq.QueueUnavailable):
            q.submit(*items[0], priority=vq.PRIORITY_PREFETCH).result(0.05)
    finally:
        gate.release.set()
        q.stop()
    with pytest.raises(vq.QueueUnavailable):
        q.submit(*items[0])
    assert vq._QUEUE is None
    assert vq.verify_or_fallback(items) == [True, False]
    assert vq.checktx_verify_or_fallback(items) == ([True, False], 2)
    assert vq.light_verify_or_fallback(items) == ([True, False], 2)
    assert vq.submit_prefetch(items) == 0


def test_consensus_verifies_inline_while_a_launch_runs():
    items = _signed(2, b"vq-busy")
    gate = Gate()
    q = vq.VerifyQueue(launch=gate)
    q.start()
    vq.install_queue(q)
    try:
        assert vq.submit_prefetch(_fake(ed.Ed25519PubKey, b"p", 3)) == 3
        assert gate.started.wait(WAIT) and q.busy()
        assert vq.verify_or_fallback(items, timeout=WAIT) == [True, True]
        assert len(gate.launched) == 1           # the votes never parked
        pk, m, s = items[0]
        assert vq.cached_result(pk.bytes(), m, s) is True
        with vq.submission_lane(vq.PRIORITY_LIGHT):
            assert vq.active_submission_lane() == vq.PRIORITY_LIGHT
        assert vq.active_submission_lane() is None
    finally:
        gate.release.set()
        q.stop()
    with vq.submission_lane(vq.PRIORITY_LIGHT):
        assert vq.active_submission_lane() is None       # no queue accepting
    with pytest.raises(ValueError):
        vq.submission_lane("bulk")


def test_consensus_busy_check_and_enqueue_hold_one_lock(monkeypatch):
    """verify_or_fallback's consensus submission checks busy() under the
    lock that enqueues it, so no prefetch buffer can be popped between
    the two: while a prefetch launch runs it enqueues nothing (the pair
    is verified inline); on an idle queue it goes through the queue."""
    items = _signed(2, b"vq-lock")
    gate = Gate()
    q = vq.VerifyQueue(launch=gate, use_cache=False)
    held = []
    busy_locked = q._busy_locked

    def checked():
        held.append(q._qmtx.locked())
        return busy_locked()

    monkeypatch.setattr(q, "_busy_locked", checked)
    q.start()
    vq.install_queue(q)
    try:
        assert vq.submit_prefetch(_fake(ed.Ed25519PubKey, b"p", 3)) == 3
        assert gate.started.wait(WAIT)
        assert q.submit_many(items, unless_busy=True) is None
        assert vq.verify_or_fallback(items, timeout=WAIT) == [True, True]
        assert q.stats()["submitted"][vq.PRIORITY_CONSENSUS] == 0 and len(gate.launched) == 1
        gate.release.set()
        _until(lambda: not q.busy(), "the queue idle")
        assert vq.verify_or_fallback(items, timeout=WAIT) == [True, True]
        assert q.stats()["submitted"][vq.PRIORITY_CONSENSUS] == 2 and len(gate.launched) == 2
    finally:
        gate.release.set()
        q.stop()
    assert held and all(held)


def test_prefetch_buffers_are_capped():
    """Every lane's buffer, prefetch's included, holds at most
    ``max_batch`` requests, as in the reference: a blocksync step's
    prefetch (8 commits of 1024 signatures) coalesces into one 8192-lane
    buffer.  Both queues get one script: a prefetch batch held in the
    gate, then 5 prefetch and 6 consensus requests at ``max_batch`` 4.
    Each lane's buffers, in order, and the first buffer launched after
    the hold (consensus preempts prefetch) are the reference's."""
    assert vq.VerifyQueue()._max_batch == jvq.VerifyQueue()._max_batch == 8192

    def run(mod, pk_cls):
        gate = Gate()
        q = mod.VerifyQueue(launch=gate, max_batch=4)
        q.start()
        try:
            first = q.submit_many(_fake(pk_cls, b"a", 1), mod.PRIORITY_PREFETCH)
            assert gate.started.wait(WAIT)
            rest = q.submit_many(_fake(pk_cls, b"b", 5), mod.PRIORITY_PREFETCH)
            votes = q.submit_many(_fake(pk_cls, b"c", 6), mod.PRIORITY_CONSENSUS)
            _until(lambda: q.stats()["prepared"]["consensus"] == 1, "the votes prepared")
            gate.release.set()
            assert [f.result(WAIT) for f in first + rest + votes] == \
                _verdicts(_fake(pk_cls, b"a", 1) + _fake(pk_cls, b"b", 5)
                          + _fake(pk_cls, b"c", 6))
        finally:
            gate.release.set()
            q.stop()
        lanes = {"prefetch": [], "consensus": []}
        for batch in gate.launched:
            lanes["consensus" if batch[0].startswith(b"c") else "prefetch"].append(len(batch))
        return lanes, gate.launched[1][0][:1]

    want = ({"prefetch": [1, 4, 1], "consensus": [4, 2]}, b"c")
    assert run(jvq, jed.Ed25519PubKey) == want
    assert run(vq, ed.Ed25519PubKey) == want


def test_result_length_mismatch_fails_the_batch():
    q = vq.VerifyQueue(launch=lambda items: [True])
    q.start()
    try:
        futs = q.submit_many(_fake(ed.Ed25519PubKey, b"x", 3), vq.PRIORITY_PREFETCH)
        with pytest.raises(RuntimeError, match="1 results for 3"):
            futs[0].result(WAIT)
    finally:
        q.stop()
    assert q.stats()["failed_batches"] == 1
    assert not any(t.name.startswith("verify-queue") for t in threading.enumerate())


def test_many_submitters_lose_no_request():
    """Stress: 12 submitter threads on every lane at once, with the
    interpreter switching threads every 10 us: every future resolves
    to its verdict once, and the counters add up (a lost update in the
    queue's shared state would break either)."""
    import sys

    gate = Gate()
    gate.release.set()
    q = vq.VerifyQueue(launch=gate, max_batch=64, checktx_batch=8, checktx_wait_ms=1,
                       light_batch=8, light_wait_ms=1)
    lanes = (vq.PRIORITY_CONSENSUS, vq.PRIORITY_PREFETCH, vq.PRIORITY_LIGHT, vq.PRIORITY_INGEST)
    got: dict = {}
    errors: list = []

    def submitter(t: int):
        try:
            items = _fake(ed.Ed25519PubKey, b"s%d" % t, 40)
            futs = [q.submit(*it, priority=lanes[(t + i) % 4]) for i, it in enumerate(items)]
            got[t] = ([f.result(WAIT) for f in futs], _verdicts(items))
        except BaseException as exc:  # noqa: BLE001 -- asserted below
            errors.append(exc)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    q.start()
    try:
        threads = [threading.Thread(target=submitter, args=(t,)) for t in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
        q.stop()
    assert not errors and len(got) == 12
    assert all(a == b for a, b in got.values())
    st = q.stats()
    assert sum(st["submitted"].values()) == 480 == st["launched_sigs"] + st["cache_resolved"]
    assert st["launched_sigs"] == sum(len(b) for b in gate.launched)
    assert st["launched_batches"] == st["prepared_batches"] == len(gate.launched)
    assert st["failed_batches"] == 0 and st["cache_resolved"] == 0
