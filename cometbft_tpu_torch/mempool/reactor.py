"""Mempool reactor — flood-gossips transactions (a copy of
cometbft_tpu/mempool/reactor.py; reference: mempool/reactor.go).

Channel 0x30 (mempool/mempool.go:14).  One broadcast thread per peer
(reactor.go:209 broadcastTxRoutine) walks the mempool in arrival order
via a sequence cursor — the idiomatic replacement for the reference's
CList pointer-chasing — skipping txs the peer itself sent us, and
waiting on the mempool's condition variable when caught up.

Its lock is ``utils/sync``'s ``Mutex()`` and ``receive`` is the
``mempool_reactor`` trust-guard seam.  Where the port departs from its
reference: ``on_stop`` joins the broadcast threads (bounded), so a
stopped node leaves none behind.
"""

from __future__ import annotations

import threading

from cometbft_tpu_torch.mempool import CListMempool
from cometbft_tpu_torch.p2p.base_reactor import Envelope, Reactor
from cometbft_tpu_torch.p2p.conn.connection import ChannelDescriptor
from cometbft_tpu_torch.utils.log import Logger, default_logger
from cometbft_tpu_torch.utils.protoio import ProtoReader, ProtoWriter
from cometbft_tpu_torch.types.codec import as_bytes
from cometbft_tpu_torch.utils.flight import FLIGHT
from cometbft_tpu_torch.utils import sync as cmtsync
from cometbft_tpu_torch.utils import trustguard

MEMPOOL_CHANNEL = 0x30

_MAX_TXS_PER_MSG = 64
_MAX_MSG_BYTES = 1048576 + 1024


def encode_txs(txs: list[bytes]) -> bytes:
    """(proto/cometbft/mempool/v1/types.proto Txs)"""
    w = ProtoWriter()
    for tx in txs:
        w.bytes_(1, tx)
    return w.finish()


def decode_txs(data: bytes) -> list[bytes]:
    f = ProtoReader(data).to_dict()
    return [as_bytes(v) for v in f.get(1, [])]


class MempoolReactor(Reactor):
    """(mempool/reactor.go:27 Reactor)"""

    def __init__(
        self,
        mempool: CListMempool,
        broadcast: bool = True,
        logger: Logger | None = None,
    ):
        super().__init__(
            name="mempool-reactor",
            logger=logger or default_logger().with_fields(module="mempool-reactor"),
        )
        self.mempool = mempool
        self.broadcast = broadcast
        self._wait_sync = threading.Event()
        # cumulative txs submitted per peer, mirrored into the p2p
        # num_txs gauge (p2p/metrics.go NumTxs)
        self._peer_tx_counts: dict[str, int] = {}
        self._peer_tx_mtx = cmtsync.Mutex()
        self._threads: list[threading.Thread] = []

    def enable_in_out_txs(self) -> None:
        """Called after state sync completes (reactor.go EnableInOutTxs)."""
        self._wait_sync.clear()

    def get_channels(self) -> list[ChannelDescriptor]:
        return [
            ChannelDescriptor(
                id=MEMPOOL_CHANNEL,
                priority=5,
                send_queue_capacity=128,
                recv_message_capacity=_MAX_MSG_BYTES,
            )
        ]

    def add_peer(self, peer) -> None:
        if self.broadcast:
            t = threading.Thread(
                target=self._broadcast_tx_routine,
                args=(peer,),
                name=f"mempool-bcast-{peer.id[:8]}",
                daemon=True,
            )
            with self._peer_tx_mtx:
                self._threads = [x for x in self._threads if x.is_alive()]
                self._threads.append(t)
            t.start()

    def on_stop(self) -> None:
        with self._peer_tx_mtx:
            threads, self._threads = self._threads, []
        for t in threads:
            t.join(timeout=2.0)

    def remove_peer(self, peer, reason) -> None:
        with self._peer_tx_mtx:
            self._peer_tx_counts.pop(peer.id, None)

    @trustguard.guarded_seam("mempool_reactor")
    def receive(self, env: Envelope) -> None:
        """CheckTx every received tx, remembering the sender so we never
        echo a tx back (reactor.go:184 Receive)."""
        try:
            txs = decode_txs(env.message)
        except Exception as exc:  # noqa: BLE001
            self.logger.error("malformed txs msg", err=repr(exc))
            if self.switch is not None:
                self.switch.stop_peer_for_error(env.src, exc)
            return
        if txs and self.switch is not None:
            with self._peer_tx_mtx:
                count = self._peer_tx_counts.get(env.src.id, 0) + len(txs)
                self._peer_tx_counts[env.src.id] = count
            self.switch.metrics.num_txs.labels(peer_id=env.src.id).set(
                count
            )
        for tx in txs:
            try:
                self.mempool.check_tx(tx, sender=env.src.id)
            except Exception as exc:  # noqa: BLE001
                # invalid/duplicate txs are normal at the gossip edge,
                # but a swallowed rejection on a wire-ingress path must
                # leave a breadcrumb, or a byzantine
                # flood of bad txs is indistinguishable from silence
                FLIGHT.record(
                    "mempool_gossip_tx_rejected",
                    peer=env.src.id,
                    err=type(exc).__name__,
                )

    def _broadcast_tx_routine(self, peer) -> None:
        """(mempool/reactor.go:209 broadcastTxRoutine)"""
        seq = 0
        while (
            peer.is_running()
            and self.is_running()
            and not self._quit.is_set()
        ):
            if not self.mempool.wait_for_txs_after(seq, timeout=0.2):
                continue
            batch = self.mempool.txs_after(
                seq, exclude_sender=peer.id, max_txs=_MAX_TXS_PER_MSG
            )
            if not batch:
                # the watermark moved but those txs are already gone
                # (committed/evicted) — jump the cursor so we don't spin
                seq = max(seq, self.mempool.current_seq())
                continue
            seq = batch[-1][0]
            txs = [tx for _, tx in batch if tx]
            if not txs:
                continue
            if not peer.send(MEMPOOL_CHANNEL, encode_txs(txs)):
                # peer backed up: retry the same batch after a beat
                seq = batch[0][0] - 1
                self._quit.wait(0.05)


__all__ = ["MempoolReactor", "MEMPOOL_CHANNEL", "encode_txs", "decode_txs"]
