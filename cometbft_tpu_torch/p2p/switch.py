"""Switch — the reactor multiplexer and peer lifecycle manager (a copy
of cometbft_tpu/p2p/switch.py; reference: p2p/switch.go:72).

Owns the transport, the peer set, and all reactors.  Every upgraded
connection becomes a Peer whose inbound messages are dispatched by
channel id to the owning reactor (switch.go:269 Broadcast fan-out,
switch.go:322 StopPeerForError, reconnect-with-backoff for persistent
peers switch.go:389).  The address book stays None until PEX is
ported.

Where the port departs from its reference: a stop that finds a peer
between its add and its start (its receive thread made but not yet
started) does not join that thread; the reference's join raises
``RuntimeError`` out of ``stop()`` there.
"""

from __future__ import annotations

import random
import threading
import time

from cometbft_tpu_torch.metrics import P2PMetrics
from cometbft_tpu_torch.p2p.base_reactor import Envelope, Reactor
from cometbft_tpu_torch.p2p.conn.connection import ChannelDescriptor, MConnConfig
from cometbft_tpu_torch.p2p.netaddr import NetAddress
from cometbft_tpu_torch.p2p.peer import Peer, PeerSet
from cometbft_tpu_torch.p2p.transport import MultiplexTransport
from cometbft_tpu_torch.utils.flight import FLIGHT
from cometbft_tpu_torch.utils.log import Logger, default_logger
from cometbft_tpu_torch.utils.service import BaseService
from cometbft_tpu_torch.utils.trace import TRACER

RECONNECT_ATTEMPTS = 20          # switch.go reconnectAttempts
RECONNECT_BASE_INTERVAL = 0.5    # (shortened from 5s for test cadence; prod sets via config)


class SwitchError(Exception):
    pass


class Switch(BaseService):
    """(p2p/switch.go:72 Switch)

    ``_mtx`` guards ``_dialing``, ``_reconnecting`` and
    ``_persistent_addrs``."""

    def __init__(
        self,
        transport: MultiplexTransport,
        mconn_config: MConnConfig | None = None,
        max_inbound: int = 40,
        max_outbound: int = 10,
        metrics=None,
        logger: Logger | None = None,
    ):
        super().__init__(
            name="switch",
            logger=logger or default_logger().with_fields(module="switch"),
        )
        self.transport = transport
        self.mconn_config = mconn_config or MConnConfig()
        self.max_inbound = max_inbound
        self.max_outbound = max_outbound
        self.peers = PeerSet()
        self.reactors: dict[str, Reactor] = {}
        self._channels: list[ChannelDescriptor] = []
        self._reactor_by_channel: dict[int, Reactor] = {}
        #: channel id -> owning reactor's registration name; the
        #: message_type label on the byte counters (per-channel
        #: granularity — the closest analog to the reference's
        #: per-proto-message label without decoding payloads here)
        self.channel_names: dict[int, str] = {}
        self._dialing: set[str] = set()
        self._reconnecting: set[str] = set()
        self._persistent_addrs: dict[str, NetAddress] = {}
        self._mtx = threading.Lock()
        self.addr_book = None  # PEX's address book; None until PEX is ported
        self.metrics = metrics if metrics is not None else P2PMetrics()

    # -- reactor registration (switch.go:134 AddReactor) ----------------

    def add_reactor(self, name: str, reactor: Reactor) -> Reactor:
        for desc in reactor.get_channels():
            if desc.id in self._reactor_by_channel:
                raise SwitchError(
                    f"channel {desc.id:#x} claimed by two reactors"
                )
            self._channels.append(desc)
            self._reactor_by_channel[desc.id] = reactor
            self.channel_names[desc.id] = name
        self.reactors[name] = reactor
        reactor.set_switch(self)
        return reactor

    def reactor(self, name: str) -> Reactor | None:
        return self.reactors.get(name)

    def node_info(self):
        return self.transport.node_info

    # -- lifecycle ------------------------------------------------------

    def on_start(self) -> None:
        if not self.transport.is_running():
            self.transport.start()
        for reactor in self.reactors.values():
            reactor.start()
        threading.Thread(
            target=self._accept_routine, name="switch-accept", daemon=True
        ).start()

    def on_stop(self) -> None:
        for peer in self.peers.copy():
            self.stop_peer_gracefully(peer)
        for reactor in self.reactors.values():
            if reactor.is_running():
                reactor.stop()
        if self.transport.is_running():
            self.transport.stop()

    # -- inbound (switch.go:817 acceptRoutine) --------------------------

    def _accept_routine(self) -> None:
        while not self._quit.is_set():
            accepted = self.transport.accept(timeout=0.2)
            if accepted is None:
                continue
            conn, ni, addr = accepted
            inbound = sum(1 for p in self.peers.copy() if not p.outbound)
            if inbound >= self.max_inbound:
                self.logger.debug("rejecting inbound: at capacity")
                conn.close()
                continue
            # one bad peer admission must not kill the accept loop
            # (switch.go acceptRoutine recovers and keeps accepting)
            try:
                self._add_peer_conn(conn, ni, addr, outbound=False)
            except Exception as exc:  # noqa: BLE001
                self.logger.error(
                    "failed to add inbound peer",
                    peer=ni.node_id[:10], err=repr(exc),
                )
                conn.close()

    # -- dialing (switch.go:500 DialPeersAsync) -------------------------

    def dial_peers_async(self, addrs: list[NetAddress],
                         persistent: bool = False) -> None:
        for addr in addrs:
            if persistent and addr.id:
                with self._mtx:
                    self._persistent_addrs[addr.id] = addr
            threading.Thread(
                target=self.dial_peer_with_address,
                args=(addr, persistent),
                daemon=True,
            ).start()

    def dial_peer_with_address(self, addr: NetAddress,
                               persistent: bool = False,
                               _from_reconnect: bool = False) -> bool:
        """(switch.go:614 DialPeerWithAddress)"""
        if addr.id:
            with self._mtx:
                if addr.id in self._dialing or self.peers.has(addr.id):
                    return False
                self._dialing.add(addr.id)
        try:
            conn, ni = self.transport.dial(addr)
        except Exception as exc:  # noqa: BLE001 — dial failures feed reconnect
            self.logger.debug("dial failed", addr=str(addr), err=repr(exc))
            if persistent and not _from_reconnect:
                self._schedule_reconnect(addr)
            return False
        finally:
            if addr.id:
                with self._mtx:
                    self._dialing.discard(addr.id)
        return self._add_peer_conn(conn, ni, addr, outbound=True,
                                   persistent=persistent)

    def is_dialing_or_connected(self, node_id: str) -> bool:
        with self._mtx:
            return node_id in self._dialing or self.peers.has(node_id)

    def _schedule_reconnect(self, addr: NetAddress) -> None:
        """(switch.go:389 reconnectToPeer) — exponential backoff + jitter.
        One attempt chain owns ``addr.id`` for its whole lifetime; dial
        failures inside the chain do NOT spawn new chains, so the
        backoff actually grows and the attempt cap holds."""
        if not addr.id:
            return
        with self._mtx:
            if addr.id in self._reconnecting:
                return
            self._reconnecting.add(addr.id)

        def attempt() -> None:
            try:
                for i in range(RECONNECT_ATTEMPTS):
                    if self._quit.is_set():
                        return
                    wait = RECONNECT_BASE_INTERVAL * (1.5 ** min(i, 10))
                    time.sleep(wait * (0.8 + 0.4 * random.random()))
                    if self.peers.has(addr.id):
                        return
                    if self.dial_peer_with_address(
                        addr, persistent=True, _from_reconnect=True
                    ):
                        return
                self.logger.info(
                    "giving up reconnecting", peer=addr.id[:10]
                )
            finally:
                with self._mtx:
                    self._reconnecting.discard(addr.id)

        threading.Thread(target=attempt, daemon=True).start()

    # -- peer lifecycle (switch.go:727 addPeer) -------------------------

    def _add_peer_conn(self, conn, ni, addr: NetAddress,
                       outbound: bool, persistent: bool = False) -> bool:
        with self._mtx:
            persistent = persistent or ni.node_id in self._persistent_addrs
        peer = Peer(
            conn,
            ni,
            self._channels,
            on_receive=self._dispatch,
            on_error=self._on_peer_error,
            outbound=outbound,
            persistent=persistent,
            socket_addr=addr,
            mconn_config=self.mconn_config,
            metrics=self.metrics,
            channel_names=self.channel_names,
            logger=self.logger.with_fields(peer=ni.node_id[:8]),
        )
        for reactor in self.reactors.values():
            reactor.init_peer(peer)
        try:
            self.peers.add(peer)
        except KeyError:
            self.logger.debug("duplicate peer", peer=ni.node_id[:10])
            conn.close()
            return False
        peer.start()
        self.metrics.peers.set(self.peers.size())
        for reactor in self.reactors.values():
            reactor.add_peer(peer)
        if outbound and self.addr_book is not None:
            # a completed outbound handshake proves the address good
            # (addrbook.go MarkGood promotion to an old bucket)
            self.addr_book.add_address(addr, addr)
            self.addr_book.mark_good(ni.node_id)
        self.logger.info(
            "added peer", peer=ni.node_id[:10],
            direction="out" if outbound else "in",
        )
        return True

    def _dispatch(self, peer: Peer, ch_id: int, msg: bytes) -> None:
        reactor = self._reactor_by_channel.get(ch_id)
        if reactor is None:
            # don't count first: an unregistered chID would mint a
            # counter child _drop_peer_gauges can never retire (it
            # iterates channel_names), letting a byzantine peer leak
            # one series per bogus channel
            self.stop_peer_for_error(peer, f"unknown channel {ch_id:#x}")
            return
        name = self.channel_names.get(ch_id, "")
        self.metrics.message_receive_bytes_total.labels(
            chID=f"{ch_id:#x}", message_type=name, peer_id=peer.id
        ).inc(len(msg))
        with TRACER.span(
            "switch_dispatch", cat="p2p", ch=f"{ch_id:#x}",
            reactor=name, bytes=len(msg),
        ):
            reactor.receive(
                Envelope(channel_id=ch_id, src=peer, message=msg)
            )

    def _on_peer_error(self, peer: Peer, err) -> None:
        self.stop_peer_for_error(peer, err)

    def stop_peer_for_error(self, peer: Peer, reason) -> None:
        """(switch.go:322 StopPeerForError)"""
        if not self.peers.has(peer.id):
            return
        FLIGHT.record(
            "peer_error", peer=peer.id[:10], reason=str(reason)[:120]
        )
        self.logger.info("stopping peer for error", peer=peer.id[:10],
                         err=str(reason))
        self._stop_and_remove_peer(peer, reason)
        if peer.is_persistent():
            addr = peer.socket_addr
            with self._mtx:
                addr = self._persistent_addrs.get(peer.id, addr)
            if addr is not None:
                self._schedule_reconnect(addr)

    def stop_peer_gracefully(self, peer: Peer) -> None:
        self._stop_and_remove_peer(peer, None)

    def _stop_and_remove_peer(self, peer: Peer, reason) -> None:
        if not self.peers.remove(peer):
            return
        self.metrics.peers.set(self.peers.size())
        try:
            if not peer.is_running():
                # the add->start window: _add_peer_conn publishes the
                # peer to the set BEFORE peer.start() runs, so a
                # concurrent switch stop can observe a not-yet-running
                # peer here — leaving the TCP socket OPEN and the
                # remote side's disconnect detection waiting on an EOF
                # that never comes (the test_peer_disconnect_detected
                # flake under concurrent pytest load).  Close the raw
                # connection directly: remote disconnect detection
                # must not depend on this thread winning that race.
                peer.mconn.conn.close()
            # stop() unconditionally, not just when running: start()
            # may complete between the check above and here (the same
            # race, one window narrower), and an error-path stop via
            # the recv loop would early-return on the already-removed
            # peer — leaving a started service never stopped.  A
            # never-started peer raises NotStartedError into the
            # best-effort catch; the conn close above already covered
            # the remote side for that case.
            peer.stop()
        except Exception:  # noqa: BLE001 — teardown is best-effort
            pass
        self._drop_peer_gauges(peer)
        for reactor in self.reactors.values():
            reactor.remove_peer(peer, reason)

    def _drop_peer_gauges(self, peer: Peer) -> None:
        """Retire EVERY peer_id-labeled child of the departed peer — a
        reconnect re-creates them; leaving any (gauges, the RTT
        histogram, the per-channel counters) would grow label
        cardinality forever under peer churn.  Counter removal reads
        as a reset to Prometheus, which rate() already tolerates."""
        # the recv thread may still be mid-dispatch for an already-read
        # message; let it exit first or its .labels() calls re-mint the
        # children removed below (skip when we ARE that thread — the
        # error path stops the peer from inside its own recv loop).
        # MConnection.on_start assigns the thread before it starts it,
        # so a stop in that window finds one not yet started: join only
        # a started thread (the reference joins it and raises).
        t = peer.mconn._recv_thread
        if (
            t is not None
            and t.ident is not None
            and t is not threading.current_thread()
        ):
            t.join(timeout=0.5)
        m = self.metrics
        m.peer_pending_send_bytes.remove(peer_id=peer.id)
        m.send_rate_bytes.remove(peer_id=peer.id)
        m.recv_rate_bytes.remove(peer_id=peer.id)
        m.num_txs.remove(peer_id=peer.id)
        m.ping_rtt_seconds.remove(peer_id=peer.id)
        m.peer_clock_offset_seconds.remove(peer_id=peer.id)
        for ch_id, name in self.channel_names.items():
            cid = f"{ch_id:#x}"
            m.send_queue_size.remove(peer_id=peer.id, chID=cid)
            m.send_queue_bytes.remove(peer_id=peer.id, chID=cid)
            m.send_timeouts.remove(peer_id=peer.id, chID=cid)
            m.try_send_failures.remove(peer_id=peer.id, chID=cid)
            m.message_send_bytes_total.remove(
                peer_id=peer.id, chID=cid, message_type=name
            )
            m.message_receive_bytes_total.remove(
                peer_id=peer.id, chID=cid, message_type=name
            )

    # -- fan-out (switch.go:269 Broadcast) ------------------------------

    def broadcast(self, ch_id: int, msg: bytes) -> None:
        """Fire-and-forget to every peer via the per-channel send
        queues — a full queue drops rather than blocks, matching the
        reference's async Broadcast semantics.  Byte accounting lives
        in Peer._count_send so only peers that actually accepted the
        message count (a dropped try_send is a try_send_failure)."""
        peers = self.peers.copy()
        with TRACER.span(
            "switch_broadcast", cat="p2p", ch=f"{ch_id:#x}",
            bytes=len(msg), peers=len(peers),
        ):
            for peer in peers:
                peer.try_send(ch_id, msg)

    def num_peers(self) -> dict:
        peers = self.peers.copy()
        with self._mtx:
            dialing = len(self._dialing)
        return {
            "outbound": sum(1 for p in peers if p.outbound),
            "inbound": sum(1 for p in peers if not p.outbound),
            "dialing": dialing,
        }


__all__ = ["Switch", "SwitchError"]
