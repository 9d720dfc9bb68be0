"""p2p/conn/netem: the port's WAN emulation against the reference's —
plans parse alike (result, error class and message), a seed and a peer
give the same hold schedule, and with no plan the frame pump writes the
same bytes.  Delays here are a few ms; every wait is bounded."""

import threading
import time

import pytest

from cometbft_tpu.p2p.conn import netem as ref_netem
from cometbft_tpu_torch.p2p.conn import netem as port_netem

PLANS = [
    "delay=100~20;loss=0.01;rate=1048576;seed=7",
    "delay=50@10-20;loss=0.5@15-30",
    "delay=100;delay=30",
    "delay=50~10;loss=0.005;seed=7",
    " delay=3 ; ; seed=-2 ",
    "rate=2.5e5@0-1e3;seed=9",
    # malformed
    "",
    "delay=abc",
    "delay=-5",
    "delay=10~-1",
    "loss=1.5",
    "loss=-0.1",
    "loss=x",
    "rate=0",
    "rate=-1",
    "rate=fast",
    "seed=x",
    "warp=9",
    "delay",
    "delay=",
    "delay=10@5",
    "delay=10@9-3",
    "delay=10@a-b",
    "seed=4",
]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("CMT_TPU_NETEM", raising=False)
    ref_netem.NETEM._reset_for_tests()
    yield
    ref_netem.NETEM._reset_for_tests()


def _parse(mod, text, **kw):
    try:
        plan = mod.NetemPlan.parse(text, **kw)
    except mod.NetemError as exc:
        return ("error", type(exc).__name__, str(exc), isinstance(exc, ValueError))
    return ("plan", plan.seed, [(e.kind, e.p1, e.p2, e.start, e.end) for e in plan.entries],
            plan.describe(), [plan.params_at(t) for t in (0.0, 12.0, 18.0, 25.0, 1e9)])


@pytest.mark.parametrize("text", PLANS)
def test_plans_parse_alike(text):
    assert _parse(port_netem, text, source="CMT_TPU_NETEM") == _parse(ref_netem, text)


def test_errors_name_their_source():
    with pytest.raises(port_netem.NetemError, match="^netem plan: loss '2' must be in"):
        port_netem.NetemPlan.parse("loss=2")
    with pytest.raises(port_netem.NetemError, match="^--netem: unknown kind"):
        port_netem.NetemPlan.parse("warp=1", source="--netem")


SCHEDULES = [
    "delay=10~5;loss=0.2;seed=7",
    "delay=50~10;loss=0.005;seed=7",
    "rate=1000;seed=0",
    "delay=20~4;loss=0.3;rate=40000@0.5-1.5;seed=11",
    "delay=100@10-20;seed=0",
]


@pytest.mark.parametrize("text", SCHEDULES)
@pytest.mark.parametrize("peer", ["peerA", "f" * 40])
def test_one_seed_and_peer_give_one_schedule(text, peer):
    sizes = [(i * 7919) % 70000 + 12 for i in range(400)]
    got = {}
    for mod in (ref_netem, port_netem):
        stage = mod.NetemStage(mod.NetemPlan.parse(text), peer, epoch=3.0)
        got[mod] = [stage.hold_s(n, now=3.0 + i * 0.004) for i, n in enumerate(sizes)]
    assert got[port_netem] == got[ref_netem]
    assert any(h > 0 for h, _ in got[port_netem]) or "@10-20" in text


class _Capture:
    def __init__(self):
        self.writes = []
        self.closed = threading.Event()

    def write(self, b):
        self.writes.append(bytes(b))

    def read_exact(self, n):
        self.closed.wait(5)
        raise EOFError

    def close(self):
        self.closed.set()


def _mconn(pkg, netem=None):
    import importlib

    mc_mod = importlib.import_module(f"{pkg}.p2p.conn.connection")
    conn = _Capture()
    kw = {} if netem is None else {"netem": netem}
    mc = mc_mod.MConnection(conn, [mc_mod.ChannelDescriptor(id=0x01),
                                   mc_mod.ChannelDescriptor(id=0x02, priority=5)],
                            on_receive=lambda *a: None, peer_id="p" * 40, **kw)
    return mc, conn


def _stream(mc, conn, msgs, idle: float = 0.0) -> bytes:
    mc.start()
    try:
        time.sleep(idle)                         # the send routine idles first
        for ch, m in msgs:
            assert mc.send(ch, m)
        deadline = time.monotonic() + 5
        want = None
        while time.monotonic() < deadline:      # until the writes settle
            n = sum(map(len, conn.writes))
            if n and n == want:
                break
            want = n
            time.sleep(0.05)
    finally:
        mc.stop()
    return b"".join(conn.writes)


MSGS = [(0x01, b"a" * 10), (0x02, bytes(range(256)) * 9), (0x01, b"tail"), (0x02, b"")]


def test_no_plan_writes_the_references_bytes():
    ref_mc, ref_conn = _mconn("cometbft_tpu")
    port_mc, port_conn = _mconn("cometbft_tpu_torch")
    assert ref_mc._netem is None and port_mc._netem is None
    frames = [b"x" * 7, b"packet-two", bytes(range(256))]
    for mc in (ref_mc, port_mc):
        for f in frames:
            mc._flush(bytearray(f))
    assert port_conn.writes == ref_conn.writes == frames
    ref = _stream(*_mconn("cometbft_tpu"), MSGS)
    assert _stream(*_mconn("cometbft_tpu_torch"), MSGS) == ref and len(ref) > 2304


def test_a_plan_holds_frames_and_keeps_their_bytes():
    from cometbft_tpu_torch.metrics import NetemMetrics, install_netem_metrics
    from cometbft_tpu_torch.utils.metrics import Registry

    reg = Registry()
    install_netem_metrics(NetemMetrics(reg))
    try:
        plan = port_netem.NetemPlan.parse("delay=3~1;seed=5")
        stage = port_netem.NetemStage(plan, "p" * 40, time.monotonic())
        mc, conn = _mconn("cometbft_tpu_torch", netem=stage)
        t0 = time.monotonic()
        mc._flush(bytearray(b"frame"))
        assert time.monotonic() - t0 >= 0.0015 and conn.writes == [b"frame"]
        conn.writes.clear()
        ref = _stream(*_mconn("cometbft_tpu"), MSGS)
        assert _stream(mc, conn, MSGS) == ref
        assert stage.frames >= 2 and stage.injected_s > 0 and stage.dropped == 0
        text = reg.expose()
        assert 'cometbft_netem_injected_delay_seconds_count{peer_id="' not in text  # retired
    finally:
        install_netem_metrics(None)


class _Echo:
    """A one-channel reactor that records what it receives."""

    def __new__(cls):
        from cometbft_tpu_torch.p2p.base_reactor import Reactor
        from cometbft_tpu_torch.p2p.conn.connection import ChannelDescriptor

        class Echo(Reactor):
            def __init__(self):
                super().__init__(name="echo")
                self.got = []

            def get_channels(self):
                return [ChannelDescriptor(id=0x77)]

            def receive(self, env):
                self.got.append(env.message)

        return Echo()


def test_the_switch_hands_each_connection_a_stage():
    from cometbft_tpu_torch.metrics import NetemMetrics, install_netem_metrics
    from cometbft_tpu_torch.p2p.test_util import connect_switches, make_switch
    from cometbft_tpu_torch.utils.metrics import Registry

    reg = Registry()
    install_netem_metrics(NetemMetrics(reg))
    r1, r2, r3 = _Echo(), _Echo(), _Echo()
    a = make_switch(reactors={"echo": r1}, netem=port_netem.NetemPlan.parse("delay=2~1;loss=0.3;seed=3"))
    b = make_switch(reactors={"echo": r2}, netem=port_netem.NetemPlan.parse("delay=1;seed=4"))
    c = make_switch(reactors={"echo": r3})
    try:
        for sw in (a, b, c):
            sw.start()
        connect_switches(a, b)
        connect_switches(a, c)
        peer_b = next(p for p in a.peers.copy() if p.id == b.node_info().node_id)
        for i in range(6):
            assert peer_b.send(0x77, b"m%d" % i)
        deadline = time.monotonic() + 5
        while len(r2.got) < 6 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert r2.got == [b"m%d" % i for i in range(6)]
        stage = peer_b.mconn._netem
        assert isinstance(stage, port_netem.NetemStage) and stage.frames >= 1
        assert stage.injected_s > 0
        assert all(p.mconn._netem is None for p in c.peers.copy())
        text = reg.expose()
        assert f'cometbft_netem_injected_delay_seconds_count{{peer_id="{b.node_info().node_id}"}}' \
            in text
    finally:
        for sw in (a, b, c):
            sw.stop()
        install_netem_metrics(None)
    assert "cometbft_netem_injected_delay_seconds_count{" not in reg.expose()


def test_a_hold_longer_than_the_flush_throttle_keeps_frames_whole(monkeypatch):
    """The throttle counts from the end of a flush, so after a 20 ms hold
    the next frame still gathers its packets.  The reference's counts
    from before the hold, so every later packet goes out as a frame of
    its own (one packet a hold: ~20 KB/s at 50 ms)."""
    msgs = [(0x01, bytes([i]) * 8000) for i in range(3)]
    plan = "delay=20;seed=1"
    port_stage = port_netem.NetemStage(port_netem.NetemPlan.parse(plan), "p" * 40,
                                       time.monotonic())
    port_bytes = _stream(*_mconn("cometbft_tpu_torch", netem=port_stage), msgs, idle=0.05)
    monkeypatch.setenv("CMT_TPU_NETEM", plan)
    ref_netem.NETEM.reload()
    ref_mc, ref_conn = _mconn("cometbft_tpu")
    assert ref_mc._netem is not None
    ref_bytes = _stream(ref_mc, ref_conn, msgs, idle=0.05)
    assert port_bytes == ref_bytes                   # the same stream
    packets = sum(-(-len(m) // 1024) for _, m in msgs)
    assert len(ref_conn.writes) >= packets - 2        # a frame a packet
    assert port_stage.frames <= packets // 3          # 24 packets in a few frames
