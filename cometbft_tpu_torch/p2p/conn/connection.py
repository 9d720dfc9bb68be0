"""Multiplexed connection (a copy of cometbft_tpu/p2p/conn/connection.py
without its WAN-emulation stage; reference: p2p/conn/connection.go:80
MConnection).

One send thread + one recv thread per connection.  Outbound messages
are chunked into packets (max 1024-byte payload) and queued per
channel; the send thread drains channels by priority — picking the
channel with the lowest recently-sent/priority ratio, exactly the
reference's ``selectChannelToGossipOn`` discipline
(connection.go:549 sendPacketMsg).  Ping/pong keepalive, a 10 ms flush
throttle, and flowrate send/recv limits (connection.go:27-48) round out
the capability set.

Wire format: length-prefixed protobuf ``Packet`` envelopes
(proto/cometbft/p2p/v1/conn.proto) — oneof ping/pong/msg{channel, eof,
data}.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from dataclasses import dataclass

from cometbft_tpu_torch.metrics import P2PMetrics
from cometbft_tpu_torch.types.codec import as_bytes, as_int
from cometbft_tpu_torch.utils.flowrate import Monitor
from cometbft_tpu_torch.utils.log import Logger, default_logger
from cometbft_tpu_torch.utils.protoio import (
    ProtoReader,
    ProtoWriter,
    encode_uvarint,
    read_uvarint_from,
)
from cometbft_tpu_torch.utils.service import BaseService
from cometbft_tpu_torch.utils.trace import TRACER

MAX_PACKET_PAYLOAD = 1024          # connection.go defaultMaxPacketMsgPayloadSize
FLUSH_THROTTLE = 0.010             # connection.go:43 flushThrottle 10ms
PING_INTERVAL = 10.0               # connection.go pingTimeout (shortened default 60s→10s keepalive cadence)
PONG_TIMEOUT = 45.0                # connection.go:46 defaultPongTimeout
SEND_RATE = 5_120_000              # config/config.go SendRate 5.12 MB/s
RECV_RATE = 5_120_000
MAX_PACKET_OVERHEAD = 256          # framing + proto tag slack over max payload


class MConnError(ValueError):
    pass


@dataclass(frozen=True)
class ChannelDescriptor:
    """(connection.go:612 ChannelDescriptor)"""

    id: int
    priority: int = 1
    send_queue_capacity: int = 64
    recv_message_capacity: int = 22020096  # 21MB (consensus max msg)


@dataclass
class MConnConfig:
    """(connection.go:117 MConnConfig)"""

    send_rate: int = SEND_RATE
    recv_rate: int = RECV_RATE
    max_packet_msg_payload_size: int = MAX_PACKET_PAYLOAD
    flush_throttle: float = FLUSH_THROTTLE
    ping_interval: float = PING_INTERVAL
    pong_timeout: float = PONG_TIMEOUT


# -- packet wire format -------------------------------------------------

_F_PING, _F_PONG, _F_MSG = 1, 2, 3


def encode_packet_ping() -> bytes:
    w = ProtoWriter()
    w.message(_F_PING, b"")
    return w.finish()


def encode_packet_pong(wall: float | None = None) -> bytes:
    """Pong keepalive.  ``wall`` (fleet plane) piggybacks the
    responder's ``time.time()`` as a varint-ns field INSIDE the pong
    body — pre-fleet decoders ignore the body entirely (they only
    test for the pong key), so stamped and empty pongs interoperate
    both directions."""
    w = ProtoWriter()
    if wall is None:
        w.message(_F_PONG, b"")
    else:
        b = ProtoWriter()
        b.varint(1, int(wall * 1e9))
        w.message(_F_PONG, b.finish())
    return w.finish()


def encode_packet_msg(channel_id: int, eof: bool, data: bytes) -> bytes:
    m = ProtoWriter()
    m.varint(1, channel_id)
    m.bool_(2, eof)
    m.bytes_(3, data)
    w = ProtoWriter()
    w.message(_F_MSG, m.finish())
    return w.finish()


def decode_packet(data: bytes):
    """Returns ('ping',), ('pong', wall_ns | None) or
    ('msg', channel_id, eof, payload).  ``wall_ns`` is the responder's
    piggybacked wall clock (None from pre-fleet peers' empty pongs)."""
    f = ProtoReader(data).to_dict()
    if _F_PING in f:
        return ("ping",)
    if _F_PONG in f:
        wall_ns = None
        try:
            body = as_bytes(f[_F_PONG][0])
            if body:
                pf = ProtoReader(body).to_dict()
                if 1 in pf:
                    wall_ns = as_int(pf[1][0]) or None
        except Exception:  # noqa: BLE001 — a garbled stamp is no stamp
            wall_ns = None
        return ("pong", wall_ns)
    if _F_MSG in f:
        m = ProtoReader(as_bytes(f[_F_MSG][0])).to_dict()
        return (
            "msg",
            as_int(m.get(1, [0])[0]),
            bool(m.get(2, [0])[0]),
            as_bytes(m.get(3, [b""])[0]),
        )
    raise MConnError("unknown packet")


class _Channel:
    """(connection.go:640 channel) — send queue + recv reassembly.

    Tracks ``queued_bytes`` (queue contents + the unsent remainder of
    the in-flight message) and mirrors queue depth/bytes into the
    per-(peer, channel) gauges — the backpressure signal the wire
    plane exposes on /metrics and /net_info.
    """

    def __init__(self, desc: ChannelDescriptor, metrics, peer_id: str):
        self.desc = desc
        self.send_queue: queue.Queue[bytes] = queue.Queue(
            desc.send_queue_capacity
        )
        self.sending: bytes | None = None  # message currently being chunked
        self.sent_pos = 0
        self.recently_sent = 0  # decayed by send routine
        self.recving = bytearray()
        self.queued_bytes = 0
        # enqueue paths race the send routine on the byte ledger; the
        # qsize-only reads (fill_ratio, status) stay lock-free
        self._qb_mtx = threading.Lock()
        # label children resolved once: the hot path updates plain
        # counters/gauges, never a labels() dict lookup
        lbl = {"peer_id": peer_id, "chID": f"{desc.id:#x}"}
        self.m_send_queue_size = metrics.send_queue_size.labels(**lbl)
        self.m_send_queue_bytes = metrics.send_queue_bytes.labels(**lbl)
        self.m_send_timeouts = metrics.send_timeouts.labels(**lbl)
        self.m_try_send_failures = metrics.try_send_failures.labels(**lbl)

    def is_send_pending(self) -> bool:
        return self.sending is not None or not self.send_queue.empty()

    def note_enqueued(self, nbytes: int) -> None:
        """Account ``nbytes`` (negative to revert a failed put).  Must
        run BEFORE the queue put: the send routine wakes on a timer,
        so a post-put accounting could land after the message was
        already popped, sent, and clamp-decremented — permanently
        inflating the gauge.  Callers refresh the gauges after the
        put, when qsize() is accurate."""
        with self._qb_mtx:
            self.queued_bytes = max(self.queued_bytes + nbytes, 0)

    def _note_sent(self, nbytes: int, final: bool) -> None:
        with self._qb_mtx:
            self.queued_bytes = max(self.queued_bytes - nbytes, 0)
        # per-chunk gauge writes are pure overhead at scrape cadence;
        # refresh once per completed message
        if final:
            self._update_gauges()

    def _update_gauges(self) -> None:
        self.m_send_queue_size.set(self.send_queue.qsize())
        self.m_send_queue_bytes.set(self.queued_bytes)  # unguarded: gauge snapshot, int read can't tear

    def fill_ratio(self) -> float:
        cap = max(self.desc.send_queue_capacity, 1)
        return self.send_queue.qsize() / cap

    def next_packet(self, max_payload: int) -> tuple[bool, bytes]:
        """Pop the next chunk of the in-flight message -> (eof, data)."""
        if self.sending is None:
            self.sending = self.send_queue.get_nowait()
            self.sent_pos = 0
        chunk = self.sending[self.sent_pos : self.sent_pos + max_payload]
        self.sent_pos += len(chunk)
        eof = self.sent_pos >= len(self.sending)
        if eof:
            self.sending = None
            self.sent_pos = 0
        self._note_sent(len(chunk), eof)
        return eof, chunk


class MConnection(BaseService):
    """(connection.go:80 MConnection)

    ``conn`` needs write(bytes)/read_exact(n)/close().  ``on_receive``
    is called from the recv thread as ``on_receive(ch_id, msg_bytes)``;
    ``on_error`` is called once when the connection dies.
    """

    def __init__(
        self,
        conn,
        channels: list[ChannelDescriptor],
        on_receive,
        on_error=None,
        config: MConnConfig | None = None,
        metrics=None,
        peer_id: str = "",
        logger: Logger | None = None,
    ):
        super().__init__(
            name="mconn", logger=logger or default_logger().with_fields(module="mconn")
        )
        self.conn = conn
        self.config = config or MConnConfig()
        self.on_receive = on_receive
        self.on_error = on_error
        self.metrics = metrics if metrics is not None else P2PMetrics()
        self.peer_id = peer_id
        self.channels: dict[int, _Channel] = {
            d.id: _Channel(d, self.metrics, peer_id) for d in channels
        }
        self._m_pending = self.metrics.peer_pending_send_bytes.labels(
            peer_id=peer_id
        )
        self._m_rtt = self.metrics.ping_rtt_seconds.labels(peer_id=peer_id)
        self._m_send_rate = self.metrics.send_rate_bytes.labels(
            peer_id=peer_id
        )
        self._m_recv_rate = self.metrics.recv_rate_bytes.labels(
            peer_id=peer_id
        )
        self._send_signal = threading.Event()
        self._last_pong = time.monotonic()
        # FIFO of outstanding-ping send times: TCP ordering means the
        # nth pong answers the nth ping, so popping the OLDEST stamp
        # attributes RTTs correctly even when RTT > ping_interval (a
        # single latest-stamp slot would report RTT mod ping_interval
        # on exactly the degraded links the metric exists to expose)
        self._ping_sent_q: deque[float] = deque()
        self.last_rtt: float | None = None
        #: fleet plane: estimated ``remote_wall - local_wall`` from the
        #: pong piggyback (NTP-style midpoint: the responder's stamp
        #: lands half an RTT before the pong arrives).  None until the
        #: first stamped pong (pre-fleet peers never produce one).
        self.clock_offset: float | None = None
        self._offset_rtt: float | None = None  # RTT quality of the estimate
        self._offset_at: float = 0.0           # monotonic acceptance time
        self._m_clock_offset = self.metrics.peer_clock_offset_seconds.labels(
            peer_id=peer_id
        )
        self.last_error: str | None = None
        self._send_monitor = Monitor()
        self._recv_monitor = Monitor()
        self._send_thread: threading.Thread | None = None
        self._recv_thread: threading.Thread | None = None
        self._ping_thread: threading.Thread | None = None
        self._errored = threading.Event()

    # -- lifecycle ------------------------------------------------------

    def on_start(self) -> None:
        self._send_thread = threading.Thread(
            target=self._send_routine, name="mconn-send", daemon=True
        )
        self._recv_thread = threading.Thread(
            target=self._recv_routine, name="mconn-recv", daemon=True
        )
        self._ping_thread = threading.Thread(
            target=self._ping_routine, name="mconn-ping", daemon=True
        )
        self._send_thread.start()
        self._recv_thread.start()
        self._ping_thread.start()

    def on_stop(self) -> None:
        self._send_monitor.done()
        self._recv_monitor.done()
        self._send_signal.set()
        # a dead connection must not leave stale backpressure gauges
        # pointing at queues nobody will ever drain
        self._m_pending.set(0)
        for ch in self.channels.values():
            ch.m_send_queue_size.set(0)
            ch.m_send_queue_bytes.set(0)
        self.conn.close()

    def _stop_for_error(self, err: Exception) -> None:
        if self._errored.is_set():
            return
        self._errored.set()
        self.last_error = repr(err)
        self.logger.debug("connection error", err=repr(err))
        try:
            if self.is_running():
                self.stop()
        except Exception:
            pass
        if self.on_error is not None:
            self.on_error(err)

    # -- sending (connection.go:320 Send) -------------------------------

    def send(self, ch_id: int, msg: bytes, timeout: float | None = 10.0) -> bool:
        """Queue ``msg`` on channel; blocks up to ``timeout`` if full."""
        ch = self.channels.get(ch_id)
        if ch is None:
            raise MConnError(f"unknown channel {ch_id:#x}")
        if not self.is_running():
            return False
        with TRACER.span(
            "channel_enqueue", cat="p2p", ch=f"{ch_id:#x}", bytes=len(msg)
        ) as sp:
            ch.note_enqueued(len(msg))
            try:
                ch.send_queue.put(msg, timeout=timeout)
            except queue.Full:
                ch.note_enqueued(-len(msg))
                ch.m_send_timeouts.inc()
                sp.set(dropped="timeout")
                return False
        ch._update_gauges()
        self._update_pending_gauge()
        self._send_signal.set()
        return True

    def try_send(self, ch_id: int, msg: bytes) -> bool:
        """Non-blocking send (connection.go:356 TrySend)."""
        ch = self.channels.get(ch_id)
        if ch is None:
            raise MConnError(f"unknown channel {ch_id:#x}")
        if not self.is_running():
            return False
        with TRACER.span(
            "channel_enqueue", cat="p2p", ch=f"{ch_id:#x}", bytes=len(msg)
        ) as sp:
            ch.note_enqueued(len(msg))
            try:
                ch.send_queue.put_nowait(msg)
            except queue.Full:
                ch.note_enqueued(-len(msg))
                ch.m_try_send_failures.inc()
                sp.set(dropped="full")
                return False
        ch._update_gauges()
        self._update_pending_gauge()
        self._send_signal.set()
        return True

    def pending_send_bytes(self) -> int:
        """Bytes across all channels still awaiting the send routine."""
        return sum(ch.queued_bytes for ch in self.channels.values())

    def _update_pending_gauge(self) -> None:
        self._m_pending.set(self.pending_send_bytes())

    def _select_channel(self) -> _Channel | None:
        """Lowest recently-sent/priority ratio wins (connection.go:549)."""
        best, best_ratio = None, None
        for ch in self.channels.values():
            if not ch.is_send_pending():
                continue
            ratio = ch.recently_sent / ch.desc.priority
            if best_ratio is None or ratio < best_ratio:
                best, best_ratio = ch, ratio
        return best

    def _send_routine(self) -> None:
        cfg = self.config
        buf = bytearray()
        last_flush = time.monotonic()
        try:
            while not self._quit.is_set():
                ch = self._select_channel()
                if ch is None:
                    # flush whatever is buffered, then wait for work
                    if buf:
                        self._flush(buf)
                        buf.clear()
                    fired = self._send_signal.wait(timeout=0.05)
                    if fired:
                        self._send_signal.clear()
                    self._decay_recently_sent()
                    continue
                eof, chunk = ch.next_packet(cfg.max_packet_msg_payload_size)
                pkt = encode_packet_msg(ch.desc.id, eof, chunk)
                framed = encode_uvarint(len(pkt)) + pkt
                buf += framed
                ch.recently_sent += len(framed)
                if eof:
                    # per-chunk gauge refresh is O(channels) locked
                    # work in the frame pump; once per message loses
                    # nothing at Prometheus scrape cadence
                    self._update_pending_gauge()
                self._send_monitor.limit(len(framed), cfg.send_rate)
                self._send_monitor.update(len(framed))
                now = time.monotonic()
                # flush on throttle expiry or when buffer is large
                if now - last_flush >= cfg.flush_throttle or len(buf) >= 65536:
                    self._flush(buf)
                    buf.clear()
                    last_flush = now
        except Exception as exc:  # noqa: BLE001 — any I/O error kills the conn
            self._stop_for_error(exc)

    def _flush(self, buf: bytearray) -> None:
        if buf:
            with TRACER.span("frame_pump", cat="p2p", bytes=len(buf)):
                self.conn.write(bytes(buf))

    def _decay_recently_sent(self) -> None:
        for ch in self.channels.values():
            ch.recently_sent = int(ch.recently_sent * 0.8)

    def send_ping(self) -> None:
        pkt = encode_packet_ping()
        self.conn.write(encode_uvarint(len(pkt)) + pkt)

    def _send_pong(self) -> None:
        # stamp as close to the write as possible: the responder-side
        # delay between stamp and wire is part of the RTT the receiver
        # halves, so a late stamp biases the offset estimate
        pkt = encode_packet_pong(time.time())
        self.conn.write(encode_uvarint(len(pkt)) + pkt)

    def _note_clock_offset(self, remote_wall: float, rtt: float) -> None:
        """Fold one pong's piggybacked wall clock into the per-peer
        offset estimate.  Prefer low-RTT samples (their midpoint
        assumption is tightest) but never let the estimate go stale:
        a sample is accepted if it is comparable quality to the one
        we hold, or the held one is older than ~2 minutes."""
        sample = remote_wall - (time.time() - rtt / 2.0)
        now = time.monotonic()
        held = self._offset_rtt
        if (
            held is None
            or rtt <= held * 1.25 + 0.002
            or now - self._offset_at > 120.0
        ):
            self.clock_offset = sample
            self._offset_rtt = rtt
            self._offset_at = now
            self._m_clock_offset.set(sample)

    def _ping_routine(self) -> None:
        cfg = self.config
        while not self._quit.wait(cfg.ping_interval):
            try:
                # stamp BEFORE the write so socket backpressure on
                # the ping itself counts into the observed RTT
                self._ping_sent_q.append(time.monotonic())
                self.send_ping()
            except Exception as exc:  # noqa: BLE001
                self._stop_for_error(exc)
                return
            self._sample_flowrate()
            if time.monotonic() - self._last_pong > cfg.pong_timeout:
                self._stop_for_error(MConnError("pong timeout"))
                return

    def _sample_flowrate(self) -> None:
        """Mirror the flowrate monitors into the per-peer throughput
        gauges (Monitor.status() EMA, sampled at keepalive cadence)."""
        self._m_send_rate.set(self._send_monitor.status()["rate_avg"])
        self._m_recv_rate.set(self._recv_monitor.status()["rate_avg"])

    # -- receiving (connection.go:590 recvRoutine) ----------------------

    def _recv_routine(self) -> None:
        cfg = self.config
        max_len = cfg.max_packet_msg_payload_size + MAX_PACKET_OVERHEAD
        try:
            while not self._quit.is_set():
                try:
                    length = read_uvarint_from(
                        self.conn.read_exact, max_value=max_len
                    )
                except ValueError as exc:
                    raise MConnError(f"packet length: {exc}") from exc
                data = self.conn.read_exact(length)
                self._recv_monitor.limit(length, cfg.recv_rate)
                self._recv_monitor.update(length)
                pkt = decode_packet(data)
                if pkt[0] == "ping":
                    self._send_pong()
                elif pkt[0] == "pong":
                    self._last_pong = time.monotonic()
                    if self._ping_sent_q:
                        self.last_rtt = (
                            self._last_pong - self._ping_sent_q.popleft()
                        )
                        self._m_rtt.observe(self.last_rtt)
                        wall_ns = pkt[1] if len(pkt) > 1 else None
                        if wall_ns:
                            self._note_clock_offset(
                                wall_ns / 1e9, self.last_rtt
                            )
                else:
                    _, ch_id, eof, payload = pkt
                    ch = self.channels.get(ch_id)
                    if ch is None:
                        raise MConnError(f"peer sent unknown channel {ch_id:#x}")
                    ch.recving += payload
                    if len(ch.recving) > ch.desc.recv_message_capacity:
                        raise MConnError(
                            f"recv msg exceeds capacity on {ch_id:#x}"
                        )
                    if eof:
                        msg = bytes(ch.recving)
                        ch.recving.clear()
                        self.on_receive(ch_id, msg)
        except Exception as exc:  # noqa: BLE001
            self._stop_for_error(exc)

    # -- introspection --------------------------------------------------

    def status(self) -> dict:
        """(connection.go Status) — live connection snapshot: flowrate
        monitors, ping RTT, queue state per channel, and — so
        /net_info shows WHY a peer connection died, not just that it
        did — the last error recorded by ``_stop_for_error``."""
        return {
            "send": self._send_monitor.status(),
            "recv": self._recv_monitor.status(),
            "ping_rtt": self.last_rtt,
            "clock_offset": self.clock_offset,
            "pending_send_bytes": self.pending_send_bytes(),
            "last_error": self.last_error,
            "channels": [
                {
                    "id": ch.desc.id,
                    "priority": ch.desc.priority,
                    "recently_sent": ch.recently_sent,
                    "send_queue_size": ch.send_queue.qsize(),
                    "send_queue_capacity": ch.desc.send_queue_capacity,
                    "send_queue_bytes": ch.queued_bytes,
                    "fill_ratio": round(ch.fill_ratio(), 4),
                }
                for ch in self.channels.values()
            ],
        }


__all__ = [
    "MConnection",
    "MConnConfig",
    "MConnError",
    "ChannelDescriptor",
    "encode_packet_msg",
    "decode_packet",
]
