"""Peer — a connected remote node (a copy of cometbft_tpu/p2p/peer.py;
reference: p2p/peer.go:25,137).

Wraps an MConnection plus the peer's authenticated NodeInfo.  Routing:
the switch registers one ``on_receive`` that dispatches by channel id
to the owning reactor.  Reactors attach per-peer state via ``set``/
``get`` (peer.go Set/Get — used by consensus PeerState).
"""

from __future__ import annotations

import threading

from cometbft_tpu_torch.metrics import P2PMetrics
from cometbft_tpu_torch.p2p.conn.connection import (
    ChannelDescriptor,
    MConnConfig,
    MConnection,
)
from cometbft_tpu_torch.p2p.netaddr import NetAddress
from cometbft_tpu_torch.p2p.node_info import NodeInfo
from cometbft_tpu_torch.utils.log import Logger, default_logger
from cometbft_tpu_torch.utils.service import BaseService


class Peer(BaseService):
    """(p2p/peer.go:137 peer)"""

    def __init__(
        self,
        conn,  # SecretConnection (or test pipe) under the mconn
        node_info: NodeInfo,
        channels: list[ChannelDescriptor],
        on_receive,  # (peer, ch_id, msg) -> None
        on_error=None,  # (peer, err) -> None
        outbound: bool = False,
        persistent: bool = False,
        socket_addr: NetAddress | None = None,
        mconn_config: MConnConfig | None = None,
        metrics=None,
        channel_names: dict[int, str] | None = None,
        logger: Logger | None = None,
    ):
        super().__init__(
            name=f"peer-{node_info.node_id[:8]}",
            logger=logger
            or default_logger().with_fields(module="peer", peer=node_info.node_id[:8]),
        )
        self.node_info = node_info
        self.outbound = outbound
        self.persistent = persistent
        self.socket_addr = socket_addr
        self.metrics = metrics if metrics is not None else P2PMetrics()
        self._channel_names = channel_names or {}
        self._data: dict[str, object] = {}
        self._data_mtx = threading.Lock()
        self.mconn = MConnection(
            conn,
            channels,
            on_receive=lambda ch_id, msg: on_receive(self, ch_id, msg),
            on_error=(lambda err: on_error(self, err)) if on_error else None,
            config=mconn_config,
            metrics=self.metrics,
            peer_id=node_info.node_id,
            logger=self.logger,
        )

    # -- identity -------------------------------------------------------

    @property
    def id(self) -> str:
        return self.node_info.node_id

    def is_outbound(self) -> bool:
        return self.outbound

    def is_persistent(self) -> bool:
        return self.persistent

    # -- lifecycle ------------------------------------------------------

    def on_start(self) -> None:
        self.mconn.start()

    def on_stop(self) -> None:
        if self.mconn.is_running():
            self.mconn.stop()

    # -- messaging (peer.go Send/TrySend) -------------------------------

    def send(self, ch_id: int, msg: bytes) -> bool:
        if not self.is_running() or not self.node_info.has_channel(ch_id):
            return False
        ok = self.mconn.send(ch_id, msg)
        if ok:
            self._count_send(ch_id, len(msg))
        return ok

    def try_send(self, ch_id: int, msg: bytes) -> bool:
        if not self.is_running() or not self.node_info.has_channel(ch_id):
            return False
        ok = self.mconn.try_send(ch_id, msg)
        if ok:
            self._count_send(ch_id, len(msg))
        return ok

    def _count_send(self, ch_id: int, nbytes: int) -> None:
        """Only successful enqueues count: a dropped try_send shows up
        in try_send_failures, not in bytes the peer never got."""
        self.metrics.message_send_bytes_total.labels(
            chID=f"{ch_id:#x}",
            message_type=self._channel_names.get(ch_id, ""),
            peer_id=self.id,
        ).inc(nbytes)

    # -- per-reactor annotations (peer.go Set/Get) ----------------------

    def set(self, key: str, value: object) -> None:
        with self._data_mtx:
            self._data[key] = value

    def get(self, key: str) -> object:
        with self._data_mtx:
            return self._data.get(key)

    def status(self) -> dict:
        return self.mconn.status()

    def __repr__(self) -> str:
        direction = "out" if self.outbound else "in"
        return f"<Peer {self.id[:10]} {direction}>"


class PeerSet:
    """Thread-safe peer registry (p2p/peer_set.go)."""

    def __init__(self) -> None:
        self._mtx = threading.Lock()
        self._by_id: dict[str, Peer] = {}

    def add(self, peer: Peer) -> None:
        with self._mtx:
            if peer.id in self._by_id:
                raise KeyError(f"duplicate peer {peer.id}")
            self._by_id[peer.id] = peer

    def has(self, peer_id: str) -> bool:
        with self._mtx:
            return peer_id in self._by_id

    def get(self, peer_id: str) -> Peer | None:
        with self._mtx:
            return self._by_id.get(peer_id)

    def remove(self, peer: Peer) -> bool:
        with self._mtx:
            return self._by_id.pop(peer.id, None) is not None

    def size(self) -> int:
        with self._mtx:
            return len(self._by_id)

    def copy(self) -> list[Peer]:
        with self._mtx:
            return list(self._by_id.values())


__all__ = ["Peer", "PeerSet"]
