"""TCP transport with connection upgrade (a copy of
cometbft_tpu/p2p/transport.py; reference: p2p/transport.go:137).

``MultiplexTransport`` listens/dials raw TCP, then upgrades every
connection: SecretConnection handshake (authenticates the remote node
key) → NodeInfo exchange → compatibility + ID checks + connection
filters.  Successful upgrades yield (conn, NodeInfo) pairs consumed by
the switch, which wraps them into Peers.
"""

from __future__ import annotations

import queue
import socket
import threading

from cometbft_tpu_torch.p2p.conn.secret_connection import SecretConnection
from cometbft_tpu_torch.p2p.key import NodeKey, pub_key_to_id
from cometbft_tpu_torch.p2p.netaddr import NetAddress
from cometbft_tpu_torch.p2p.node_info import MAX_NODE_INFO_SIZE, NodeInfo
from cometbft_tpu_torch.utils.log import Logger, default_logger
from cometbft_tpu_torch.utils.protoio import encode_uvarint, read_uvarint_from
from cometbft_tpu_torch.utils.service import BaseService


class TransportError(Exception):
    pass


class RejectedError(TransportError):
    """Connection rejected during upgrade (transport.go ErrRejected)."""

    def __init__(self, msg: str, is_auth_failure: bool = False,
                 is_incompatible: bool = False, is_filtered: bool = False):
        super().__init__(msg)
        self.is_auth_failure = is_auth_failure
        self.is_incompatible = is_incompatible
        self.is_filtered = is_filtered


def _exchange_node_info(sconn: SecretConnection, ours: NodeInfo) -> NodeInfo:
    """Both sides send, then receive (transport.go handshake;
    length-prefixed wire)."""
    payload = ours.encode()
    sconn.write(encode_uvarint(len(payload)) + payload)
    # length is attacker-controlled: cap it BEFORE allocating
    # (node_info.go:19 MaxNodeInfoSize enforced at read time)
    try:
        length = read_uvarint_from(
            sconn.read_exact, max_value=MAX_NODE_INFO_SIZE
        )
    except ValueError as exc:
        raise TransportError(f"node info length: {exc}") from exc
    theirs = NodeInfo.decode(sconn.read_exact(length))
    theirs.validate()
    return theirs


class MultiplexTransport(BaseService):
    """(p2p/transport.go:137 MultiplexTransport)"""

    def __init__(
        self,
        node_info: NodeInfo,
        node_key: NodeKey,
        handshake_timeout: float = 20.0,
        dial_timeout: float = 3.0,
        conn_filters=None,  # list of (node_info) -> None | raise to reject
        logger: Logger | None = None,
    ):
        super().__init__(
            name="transport",
            logger=logger or default_logger().with_fields(module="transport"),
        )
        self.node_info = node_info
        self.node_key = node_key
        self.handshake_timeout = handshake_timeout
        self.dial_timeout = dial_timeout
        self.conn_filters = conn_filters or []
        self._listener: socket.socket | None = None
        self.listen_addr: NetAddress | None = None
        self._accept_queue: queue.Queue = queue.Queue(maxsize=64)

    # -- listening (transport.go:206 Listen / :174 Accept) --------------

    def listen(self, addr: NetAddress) -> None:
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((addr.host, addr.port))
        sock.listen(64)
        host, port = sock.getsockname()[:2]
        self._listener = sock
        self.listen_addr = NetAddress(
            id=self.node_info.node_id, host=host, port=port
        )
        threading.Thread(
            target=self._accept_routine, name="transport-accept", daemon=True
        ).start()

    def _accept_routine(self) -> None:
        while not self._quit.is_set():
            try:
                raw, peer_addr = self._listener.accept()
            except OSError:
                return  # listener closed
            threading.Thread(
                target=self._upgrade_inbound,
                args=(raw, peer_addr),
                daemon=True,
            ).start()

    def _upgrade_inbound(self, raw: socket.socket, peer_addr) -> None:
        try:
            conn, ni = self._upgrade(raw, dial_target=None)
        except Exception as exc:  # noqa: BLE001 — rejected conns are logged
            self.logger.debug("inbound upgrade failed", err=repr(exc))
            try:
                raw.close()
            except OSError:
                pass
            return
        addr = NetAddress(id=ni.node_id, host=peer_addr[0], port=peer_addr[1])
        try:
            self._accept_queue.put_nowait((conn, ni, addr))
        except queue.Full:
            conn.close()

    def accept(self, timeout: float | None = None):
        """Blocking: next upgraded inbound (conn, node_info, addr)."""
        try:
            return self._accept_queue.get(timeout=timeout)
        except queue.Empty:
            return None

    # -- dialing (transport.go:152 Dial) --------------------------------

    def dial(self, addr: NetAddress):
        """Dial + upgrade; returns (SecretConnection, NodeInfo)."""
        raw = socket.create_connection(
            (addr.host, addr.port), timeout=self.dial_timeout
        )
        try:
            return self._upgrade(raw, dial_target=addr)
        except Exception:
            try:
                raw.close()
            except OSError:
                pass
            raise

    # -- upgrade (transport.go:359 upgrade) -----------------------------

    def _upgrade(self, raw: socket.socket, dial_target: NetAddress | None):
        raw.settimeout(self.handshake_timeout)
        sconn = SecretConnection(raw, self.node_key.priv_key)
        remote_id = pub_key_to_id(sconn.remote_pubkey)
        if dial_target is not None and dial_target.id and remote_id != dial_target.id:
            raise RejectedError(
                f"dialed {dial_target.id[:10]} but peer is {remote_id[:10]}",
                is_auth_failure=True,
            )
        ni = _exchange_node_info(sconn, self.node_info)
        if ni.node_id != remote_id:
            raise RejectedError(
                "node info ID does not match connection key",
                is_auth_failure=True,
            )
        if ni.node_id == self.node_info.node_id:
            raise RejectedError("connected to self", is_filtered=True)
        try:
            self.node_info.compatible_with(ni)
        except Exception as exc:
            raise RejectedError(str(exc), is_incompatible=True) from exc
        for flt in self.conn_filters:
            flt(ni)
        raw.settimeout(None)
        return sconn, ni

    # -- lifecycle ------------------------------------------------------

    def on_stop(self) -> None:
        if self._listener is not None:
            # shutdown before close: close() alone leaves a thread
            # blocked in accept() holding the fd, leaking the thread
            # and the port
            try:
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._listener.close()
            except OSError:
                pass
        # drain queued-but-unclaimed inbound connections
        while True:
            try:
                conn, _, _ = self._accept_queue.get_nowait()
                conn.close()
            except queue.Empty:
                break


__all__ = ["MultiplexTransport", "TransportError", "RejectedError"]
