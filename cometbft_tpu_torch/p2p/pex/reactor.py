"""PEX reactor — peer discovery over channel 0x00 (a copy of
cometbft_tpu/p2p/pex/reactor.py; reference: p2p/pex/pex_reactor.go:22).

Outbound peers get a PexRequest when the book wants more addresses;
every peer may request our selection at a bounded rate.  An ensure-peers
loop dials book picks (seeds as bootstrap when the book is dry) until
the switch reaches its outbound target.  Seed-mode nodes serve their
book and disconnect after a short exchange (crawler-lite).

Where the port departs from its reference: the seed shuffle and the
pick of a peer to ask draw from ``rng`` (a constructor argument; an
unseeded ``random.Random()`` when omitted) where the reference uses the
``random`` module; adding the reactor to a switch sets
``Switch.addr_book`` (the reference's node assembly does that), so a
completed outbound dial marks its address good; and a seed hangs up on
a peer it served only once its reply is written (pex_reactor.go
``FlushStop``), where the reference stops the peer at once and usually
drops its own reply.
"""

from __future__ import annotations

import random
import threading
import time

from cometbft_tpu_torch.p2p.base_reactor import ChannelDescriptor, Envelope, Reactor
from cometbft_tpu_torch.p2p.netaddr import NetAddress
from cometbft_tpu_torch.p2p.pex.addrbook import AddrBook
from cometbft_tpu_torch.utils.log import default_logger
from cometbft_tpu_torch.utils.protoio import ProtoReader, ProtoWriter
from cometbft_tpu_torch.types.codec import as_bytes as _bz, as_int as _iv
from cometbft_tpu_torch.utils import sync as cmtsync
from cometbft_tpu_torch.utils import trustguard
from cometbft_tpu_torch.utils.flight import FLIGHT

PEX_CHANNEL = 0x00

_ENSURE_PEERS_INTERVAL = 30.0   # pex_reactor.go ensurePeersPeriod
_MIN_RECV_REQUEST_INTERVAL = 30.0  # minReceiveRequestInterval ~ cadence
_MAX_ADDRS_PER_MSG = 250


def encode_pex_request() -> bytes:
    w = ProtoWriter()
    w.message(1, b"")
    return w.finish()


def encode_pex_addrs(addrs: list[NetAddress]) -> bytes:
    inner = ProtoWriter()
    for a in addrs[:_MAX_ADDRS_PER_MSG]:
        aw = ProtoWriter()
        aw.string(1, a.id)
        aw.string(2, a.host)
        aw.varint(3, a.port)
        inner.message(1, aw.finish())
    w = ProtoWriter()
    w.message(2, inner.finish())
    return w.finish()


def decode_pex_msg(raw: bytes):
    """-> ("request", None) | ("addrs", [NetAddress])"""
    f = ProtoReader(bytes(raw)).to_dict()
    if 1 in f:
        return "request", None
    if 2 in f:
        addrs = []
        inner = ProtoReader(_bz(f[2][0])).to_dict()
        for araw in inner.get(1, []):
            af = ProtoReader(_bz(araw)).to_dict()
            addrs.append(
                NetAddress(
                    id=_bz(af.get(1, [b""])[0]).decode(),
                    host=_bz(af.get(2, [b""])[0]).decode(),
                    port=_iv(af.get(3, [0])[0]),
                )
            )
        return "addrs", addrs
    raise ValueError("unknown pex message")


class PexReactor(Reactor):
    """(p2p/pex/pex_reactor.go:22 Reactor)"""

    def __init__(
        self,
        book: AddrBook,
        seeds: list[NetAddress] | None = None,
        seed_mode: bool = False,
        ensure_interval: float = _ENSURE_PEERS_INTERVAL,
        logger=None,
        rng: random.Random | None = None,
    ):
        super().__init__(name="pex")
        self.logger = logger or default_logger().with_fields(module="pex")
        self.book = book
        self.seeds = list(seeds or [])
        self.seed_mode = seed_mode
        self.ensure_interval = ensure_interval
        self._rng = rng if rng is not None else random.Random()
        self._mtx = cmtsync.Mutex()
        self._last_request_from: dict[str, float] = {}
        self._last_request_to: dict[str, float] = {}
        self._requested_of: set[str] = set()

    def set_switch(self, switch) -> None:
        super().set_switch(switch)
        switch.addr_book = self.book

    def get_channels(self) -> list[ChannelDescriptor]:
        return [
            ChannelDescriptor(
                id=PEX_CHANNEL,
                priority=1,
                send_queue_capacity=10,
                recv_message_capacity=64 * 1024,
            )
        ]

    # -- lifecycle -------------------------------------------------------

    def on_start(self) -> None:
        if not self.book.is_running():
            self.book.start()
        threading.Thread(
            target=self._ensure_peers_routine,
            name="pex-ensure",
            daemon=True,
        ).start()

    def on_stop(self) -> None:
        if self.book.is_running():
            self.book.stop()

    # -- peer hooks ------------------------------------------------------

    def add_peer(self, peer) -> None:
        if peer.outbound:
            # learned a good dialable address; ask it for more if thin
            if self.book.need_more_addrs():
                self._request_addrs(peer)
        else:
            # record the inbound peer's self-reported listen address
            addr = self._peer_self_addr(peer)
            if addr is not None:
                self.book.add_address(addr, addr)

    def remove_peer(self, peer, reason=None) -> None:
        with self._mtx:
            self._requested_of.discard(peer.id)
            self._last_request_from.pop(peer.id, None)

    def _peer_self_addr(self, peer) -> NetAddress | None:
        try:
            ni = peer.node_info
            host, _, port = ni.listen_addr.rpartition(":")
            host = host.split("//")[-1]
            remote = peer.socket_addr.host if peer.socket_addr else ""
            if host in ("0.0.0.0", ""):
                host = remote
            return NetAddress(id=ni.node_id, host=host, port=int(port))
        except Exception as exc:  # noqa: BLE001 — malformed listen addr
            # swallowed on a wire-ingress path: breadcrumb, never
            # silent
            FLIGHT.record(
                "pex_self_addr_rejected",
                peer=getattr(peer, "id", "?"),
                err=type(exc).__name__,
            )
            return None

    # -- receive ---------------------------------------------------------

    @trustguard.guarded_seam("pex_reactor")
    def receive(self, envelope: Envelope) -> None:
        try:
            kind, addrs = decode_pex_msg(envelope.message)
        except ValueError as exc:
            self.switch.stop_peer_for_error(envelope.src, exc)
            return
        if kind == "request":
            self._handle_request(envelope.src)
        else:
            self._handle_addrs(envelope.src, addrs)

    def _handle_request(self, peer) -> None:
        now = time.monotonic()
        with self._mtx:
            last = self._last_request_from.get(peer.id, 0.0)
            # receiver tolerance is 1/3 of the sender cadence so normal
            # delivery jitter can't look like spam (reference:
            # minReceiveRequestInterval = ensurePeersPeriod / 3)
            if (
                not self.seed_mode
                and now - last < _MIN_RECV_REQUEST_INTERVAL / 3
            ):
                # reference disconnects peers that spam requests
                self.switch.stop_peer_for_error(
                    peer, "pex request too soon"
                )
                return
            self._last_request_from[peer.id] = now
        peer.send(PEX_CHANNEL, encode_pex_addrs(self.book.get_selection()))
        if self.seed_mode and not peer.outbound:
            # seeds serve the book then hang up, freeing inbound slots
            # (pex_reactor.go seed-mode disconnect), once the reply is
            # written (FlushStop), off the receive thread
            threading.Thread(
                target=self._hang_up, args=(peer,), name="pex-hangup",
                daemon=True,
            ).start()

    def _hang_up(self, peer) -> None:
        peer.flush()
        self.switch.stop_peer_gracefully(peer)

    def _handle_addrs(self, peer, addrs: list[NetAddress]) -> None:
        with self._mtx:
            if peer.id not in self._requested_of:
                self.switch.stop_peer_for_error(
                    peer, "unsolicited pex addrs"
                )
                return
            self._requested_of.discard(peer.id)
        if len(addrs) > _MAX_ADDRS_PER_MSG:
            self.switch.stop_peer_for_error(peer, "pex addrs overflow")
            return
        src = self._peer_self_addr(peer) or NetAddress(
            id=peer.id,
            host=peer.socket_addr.host if peer.socket_addr else "",
            port=0,
        )
        for addr in addrs:
            try:
                self.book.add_address(addr, src)
            except Exception:  # noqa: BLE001 — one bad addr is not fatal
                continue

    def _request_addrs(self, peer) -> None:
        now = time.monotonic()
        with self._mtx:
            if peer.id in self._requested_of:
                return
            # never out-pace the receiver's spam threshold, or it will
            # disconnect us (sender-side of minReceiveRequestInterval)
            if (
                now - self._last_request_to.get(peer.id, -1e9)
                < _MIN_RECV_REQUEST_INTERVAL
            ):
                return
            self._requested_of.add(peer.id)
            self._last_request_to[peer.id] = now
        peer.send(PEX_CHANNEL, encode_pex_request())

    # -- ensure peers (pex_reactor.go:352 ensurePeers) -------------------

    def _ensure_peers_routine(self) -> None:
        # fast first pass so a fresh node dials out immediately
        self._ensure_peers()
        while not self._quit.wait(self.ensure_interval):
            self._ensure_peers()

    def _ensure_peers(self) -> None:
        sw = self.switch
        if sw is None or not sw.is_running():
            return
        out = sum(1 for p in sw.peers.copy() if p.outbound)
        dialing = len(sw._dialing)
        need = sw.max_outbound - out - dialing
        if need <= 0:
            return
        # bias toward new addresses while under-connected (reference
        # biasTowardsNewAddrs based on connected-peer ratio)
        bias = max(30, 100 - out * 10)
        dialed = 0
        for _ in range(need * 3):
            if dialed >= need:
                break
            addr = self.book.pick_address(bias)
            if addr is None:
                break
            if sw.is_dialing_or_connected(addr.id):
                continue
            self.book.mark_attempt(addr)
            dialed += 1
            threading.Thread(
                target=self._dial,
                args=(addr,),
                name="pex-dial",
                daemon=True,
            ).start()
        total_peers = sw.peers.size()
        if dialed == 0 and total_peers == 0 and self.seeds:
            # nothing dialable (empty book OR all entries bad/stale):
            # bootstrap from seeds (reference falls back on no-peers,
            # not on book-emptiness)
            self._dial_seeds()
        # keep the book topped up: ask a random connected peer
        if self.book.need_more_addrs():
            peers = [p for p in sw.peers.copy() if p.outbound]
            if peers:
                self._request_addrs(self._rng.choice(peers))

    def _dial(self, addr: NetAddress) -> None:
        # success-side mark_good happens in the switch's addr-book hook
        # on handshake completion; dial_peer_with_address reports
        # failure as a False return, NOT an exception
        try:
            ok = self.switch.dial_peer_with_address(addr, persistent=False)
        except Exception as exc:  # noqa: BLE001
            ok = False
            self.logger.debug(
                "pex dial failed", addr=str(addr), err=repr(exc)
            )
        if not ok:
            self.logger.debug("pex dial failed", addr=str(addr))

    def _dial_seeds(self) -> None:
        seeds = self.seeds[:]
        self._rng.shuffle(seeds)
        for seed in seeds:
            if self.switch.is_dialing_or_connected(seed.id):
                continue
            try:
                self.switch.dial_peer_with_address(seed, persistent=False)
                # a live seed will answer our request; record it
                self.book.add_address(seed, seed)
                return
            except Exception as exc:  # noqa: BLE001
                self.logger.debug(
                    "seed dial failed", seed=str(seed), err=repr(exc)
                )


__all__ = [
    "PEX_CHANNEL",
    "PexReactor",
    "decode_pex_msg",
    "encode_pex_addrs",
    "encode_pex_request",
]
