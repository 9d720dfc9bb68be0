"""The port's device-plane guard (cometbft_tpu_torch/ops/jitguard.py)
against what the reference's tests expect of cometbft_tpu/ops/jitguard.py
(tests/test_jitcheck.py): counts per seam, seal, RetraceError with both
stacks, reset, builds counted by seam, and the sync window's trip
counter.

The reference's transfer counter never counts under jax 0.9.0 (its
``_is_transfer_guard_error`` accepts only ``XlaRuntimeError``); the
port's is held to what the reference's test expects of it: one trip per
planted sync.  This CPU has no card, so the window's mode switch is a
recorder here (the real ``torch.cuda.set_sync_debug_mode`` is driven by
the gpu test in tests/test_torch_kernels_gpu.py); the seams are the real
ones, with their heavy kernels stubbed."""

import threading
import time

import numpy as np
import pytest
import torch

from cometbft_tpu_torch import metrics as M
from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import ed25519_verify as EV
from cometbft_tpu_torch.ops import jitguard
from cometbft_tpu_torch.ops import precompute as PR
from cometbft_tpu_torch.ops.jitguard import RetraceError
from cometbft_tpu_torch.utils.metrics import Registry

#: every wait in a threaded test is bounded by this
WAIT_S = 10.0


@pytest.fixture
def guard(monkeypatch):
    """The guard enabled and reset, fresh seen-key memos, real metrics."""
    monkeypatch.setattr(jitguard, "_SEEN", {})
    jitguard.enable()
    jitguard.reset()
    cm = M.CryptoMetrics(Registry())
    M.install_crypto_metrics(cm)
    yield cm
    jitguard.enable(False)
    jitguard.reset()
    M.install_crypto_metrics(None)


@pytest.fixture
def modes(monkeypatch):
    """The sync debug mode as a recorder, and CUDA reported initialised:
    the window arms as it would on a card."""
    seen = []
    monkeypatch.setattr(jitguard, "_set_mode", seen.append)
    monkeypatch.setattr(jitguard, "_cuda_ready", lambda: True)
    return seen


def _entry(window_bits=8, cap=8):
    nwin, nent = 256 // window_bits, 1 << window_bits
    return PR.KeySetTables(sethash=b"h", window_bits=window_bits, key_index={},
                           table=torch.zeros((nwin, 4, 26, cap * nent), dtype=torch.int32),
                           valid=np.ones(cap, dtype=bool), nbytes=0)


def _batch(n, msg_len=100):
    pub = np.zeros((n, 32), dtype=np.uint8)
    sig = np.zeros((n, 64), dtype=np.uint8)
    return pub, sig, [bytes(msg_len)] * n, np.zeros(n, dtype=np.int32)


@pytest.fixture
def stub_kernels(monkeypatch):
    """The seams' heavy work stubbed: the keyed slices, the generic
    kernel and the table build answer with zeros at once."""
    monkeypatch.setattr(EV, "keyed_rows",
                        lambda buf, bucket, *a: torch.ones(buf.shape[1], dtype=torch.bool))
    monkeypatch.setattr(EV, "keyed_digest",
                        lambda buf, bucket, nblocks: torch.zeros((64, buf.shape[1]),
                                                                 dtype=torch.uint8))
    monkeypatch.setattr(EV, "verify_generic_fused",
                        lambda rows, digest, bucket: torch.ones(rows.shape[1], dtype=torch.bool))

    def build(pub, window_bits):
        n, nwin, nent = pub.shape[1], 256 // window_bits, 1 << window_bits
        return (torch.zeros((nwin, 4, 26, n * nent), dtype=torch.int32),
                torch.ones(n, dtype=torch.bool))

    monkeypatch.setattr(PR, "build_tables_kernel", build)


def test_seeded_retrace_raises_with_both_stacks(guard, stub_kernels):
    """The keyed seam: a warm batch width, seal, then a new width raises
    before anything launches, naming both call sites."""
    entry = _entry()
    pub, sig, msgs, ids = _batch(8)
    assert EV.verify_arrays_keyed(entry, ids, pub, sig, msgs).all()   # warm-up
    jitguard.seal()
    assert EV.verify_arrays_keyed(entry, ids, pub, sig, msgs).all()   # same key
    pub, sig, msgs, ids = _batch(20)
    with pytest.raises(RetraceError) as exc:
        EV.verify_arrays_keyed(entry, ids, pub, sig, msgs)
    msg = str(exc.value)
    assert "RETRACE after warmup at seam 'keyed'" in msg
    assert "(32, 128, 8, 8192" in msg          # the new key: batch 32, bucket 128
    assert "(8, 128, 8, 8192" in msg           # the warm one
    assert "this note" in msg and "previous note" in msg
    assert msg.count("test_seeded_retrace_raises_with_both_stacks") >= 2
    assert guard.guard_trips.labels(kind="retrace").get() == 1.0
    # a key that raised is not remembered: it raises again
    with pytest.raises(RetraceError):
        EV.verify_arrays_keyed(entry, ids, pub, sig, msgs)


def test_compile_counts_per_seam(guard, stub_kernels):
    pub, sig, msgs, _ = _batch(8)
    EV.verify_arrays(pub, sig, msgs, "cpu")
    EV.verify_arrays(pub, sig, msgs, "cpu")          # the same signature: no note
    EV.verify_arrays(*_batch(8, msg_len=200)[:3], "cpu")   # bucket 256
    EV.verify_arrays(*_batch(EV.MAX_LAUNCH + 1)[:3], "cpu")  # two slices: chunked
    cache = PR.KeyTableCache("cpu")
    cache.lookup_or_build([bytes([i]) * 32 for i in range(3)])
    cache.lookup_or_build([bytes([i]) * 32 for i in range(3, 6)])   # 3 keys again: seen
    cache.lookup_or_build([bytes([9]) * 32])
    counts = jitguard.compile_counts()
    assert counts == {"generic": 2, "chunked": 1, "table_build": 2}
    assert guard.jit_cache_misses.labels(seam="generic").get() == 2.0
    assert guard.jit_cache_misses.labels(seam="chunked").get() == 1.0
    assert jitguard._SEEN["table_build"] == {(3, 8, ((0, 0), (0, 0))),
                                              (1, 8, ((0, 0), (0, 0)))}


def test_builds_counted_by_seam(guard, monkeypatch, tmp_path):
    """ops/_build.py notes each build or first load under its source's
    seam; after seal() a build raises before the compiler starts."""
    lib = tmp_path / "libfield.so"
    lib.write_bytes(b"")
    monkeypatch.setattr(_build, "_built", {})
    monkeypatch.setattr(_build, "_target", lambda name: ("src.cu", str(tmp_path / f"lib{name}.so")))
    monkeypatch.setattr(_build, "_load", lambda name, path, secs, log: _build.Built(
        name, path, secs, log, None))
    _build.build_all(["field"])
    _build.build_all(["field"])                      # loaded: no second note
    assert jitguard.compile_counts() == {"build:field": 1}
    jitguard.seal()
    (tmp_path / "libsha512.so").write_bytes(b"")
    with pytest.raises(RetraceError, match="seam 'build:sha512'"):
        _build.build_all(["sha512"])
    assert "sha512" not in _build._built
    assert guard.guard_trips.labels(kind="retrace").get() == 1.0


def test_reset_forgets_counts_and_seal_not_seen_keys(guard, stub_kernels):
    pub, sig, msgs, _ = _batch(8)
    EV.verify_arrays(pub, sig, msgs, "cpu")
    jitguard.seal()
    jitguard.reset()
    assert not jitguard.sealed() and jitguard.compile_counts() == {}
    EV.verify_arrays(pub, sig, msgs, "cpu")          # still seen: not noted again
    assert jitguard.compile_counts() == {}


def test_counts_but_no_stacks_no_raises_when_off(monkeypatch):
    monkeypatch.setattr(jitguard, "_SEEN", {})
    jitguard.enable(False)
    jitguard.reset()
    try:
        jitguard.note_key("generic", (8, 128))
        jitguard.seal()
        jitguard.note_key("generic", (16, 128))     # no raise when off
        assert jitguard.compile_counts()["generic"] == 2
        assert not jitguard._last_site              # stacks never recorded
        assert jitguard.transfer_window() is jitguard._NULL
        assert jitguard.audited() is jitguard._NULL
    finally:
        jitguard.reset()


def test_window_passthrough_before_seal_and_without_cuda(guard, modes, monkeypatch):
    with jitguard.transfer_window():
        pass
    assert modes == []                               # not sealed: never armed
    jitguard.seal()
    monkeypatch.setattr(jitguard, "_cuda_ready", lambda: False)
    assert jitguard.transfer_window() is jitguard._NULL
    assert modes == []


def _sync_error():
    return RuntimeError("CUDA error: called a synchronizing CUDA operation")


def test_transfer_window_trips_on_implicit_sync(guard, modes):
    """The reference's test: inside the sealed window an implicit sync
    raises, and the trip counts once."""
    jitguard.seal()
    with pytest.raises(RuntimeError, match="synchronizing"):
        with jitguard.transfer_window():
            assert modes == ["error"]
            raise _sync_error()
    assert modes == ["error", "default"]
    assert guard.guard_trips.labels(kind="transfer").get() == 1.0
    # another error in the window is not a transfer trip
    with pytest.raises(RuntimeError, match="else"):
        with jitguard.transfer_window():
            raise RuntimeError("something else")
    assert guard.guard_trips.labels(kind="transfer").get() == 1.0


def test_transfer_window_allows_the_audited_copies(guard, modes):
    """The audited copies (staging, fetch) lift the mode inside the
    window and set it again after; a nested window changes nothing."""
    jitguard.seal()
    with jitguard.transfer_window():
        with jitguard.audited():
            assert modes[-1] == "default"
            with jitguard.audited():
                pass
        assert modes[-1] == "error"
        with jitguard.transfer_window():
            pass
        assert modes[-1] == "error"
    assert modes == ["error", "default", "error", "default"]


def _in_thread(fn):
    box = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as exc:  # noqa: BLE001 -- re-raised by the caller
            box["exc"] = exc

    t = threading.Thread(target=run, name="guard-test")
    t.start()
    return t, box


def test_window_and_other_threads_audited_scopes_exclude_each_other(guard, modes):
    """The verify queue's collector copies while its launcher holds a
    window: the collector's audited copy waits for the window to close,
    and a window waits for another thread's open audited scope."""
    jitguard.seal()
    order = []
    in_window = threading.Event()
    leave_window = threading.Event()

    def launcher():
        with jitguard.transfer_window():
            order.append("window open")
            in_window.set()
            assert leave_window.wait(WAIT_S)
            order.append("window close")

    def collector():
        assert in_window.wait(WAIT_S)
        with jitguard.audited():
            order.append("collector copy")

    ta, box_a = _in_thread(launcher)
    tb, box_b = _in_thread(collector)
    assert in_window.wait(WAIT_S)
    time.sleep(0.05)
    assert order == ["window open"]              # the collector is waiting
    leave_window.set()
    ta.join(WAIT_S)
    tb.join(WAIT_S)
    assert not ta.is_alive() and not tb.is_alive()
    assert "exc" not in box_a and "exc" not in box_b
    assert order == ["window open", "window close", "collector copy"]

    # and the other way round: a window waits for an open audited scope
    order.clear()
    copying = threading.Event()
    done_copying = threading.Event()

    def slow_copy():
        with jitguard.audited():
            order.append("copy start")
            copying.set()
            assert done_copying.wait(WAIT_S)
            order.append("copy end")

    def window():
        assert copying.wait(WAIT_S)
        with jitguard.transfer_window():
            order.append("window")

    tc, _ = _in_thread(slow_copy)
    tw, _ = _in_thread(window)
    assert copying.wait(WAIT_S)
    time.sleep(0.05)
    assert order == ["copy start"]
    done_copying.set()
    tc.join(WAIT_S)
    tw.join(WAIT_S)
    assert not tc.is_alive() and not tw.is_alive()
    assert order == ["copy start", "copy end", "window"]
    assert modes[-1] == "default"


def test_verify_path_is_clean_under_the_sealed_guard(guard, modes, stub_kernels):
    """Warm the keyed tier's launch path once, seal, run it again inside
    the window: no new key, no trip (its copies are the audited ones)."""
    from cometbft_tpu_torch.crypto import dispatch as D
    from cometbft_tpu_torch.crypto import ed25519 as ed

    D.reset_for_tests()
    cache = PR.KeyTableCache("cpu")
    bv_args = dict(device="cpu", device_min_batch=0, cache=cache)
    priv = ed.priv_key_from_secret(b"jitguard")

    def run():
        bv = EV.TorchBatchVerifier(**bv_args)
        for i in range(8):
            bv.add(priv.pub_key(), b"msg-%d" % i, bytes(64))
        ok, results = bv.verify()
        assert bv.last_tier == "keyed"
        return results

    assert run() == [True] * 8          # the stubbed kernels say valid
    counts = jitguard.compile_counts()
    jitguard.seal()
    assert run() == [True] * 8
    assert jitguard.compile_counts() == counts
    assert modes and modes[0] == "error" and modes[-1] == "default"
    assert guard.guard_trips.labels(kind="transfer").get() == 0.0
    D.reset_for_tests()


def test_window_and_audited_scopes_under_contention(guard, modes):
    """More threads than cores, a short switch interval: windows on four
    threads and audited copies on eight.  No audited body on another
    thread ever runs while a window is open, and a window's own body
    always runs with the mode at "error"."""
    import sys

    jitguard.seal()
    violations = []
    opened = threading.Event()

    def windows():
        for _ in range(50):
            with jitguard.transfer_window():
                opened.set()
                time.sleep(0.001)
                if modes[-1] != "error" or jitguard._audits:
                    violations.append(("window", modes[-1], jitguard._audits))

    def copies():
        for _ in range(200):
            with jitguard.audited():
                if jitguard._owner is not None:
                    violations.append(("audited", jitguard._owner))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=fn, name=f"guard-stress-{i}")
                   for i, fn in enumerate([windows] * 4 + [copies] * 8)]
        for t in threads[:4]:
            t.start()
        assert opened.wait(WAIT_S)      # the copies start while windows run
        for t in threads[4:]:
            t.start()
        for t in threads:
            t.join(WAIT_S)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert violations == []
    assert modes[-1] == "default" and jitguard._owner is None and jitguard._audits == 0
