"""Statesync reactor (a copy of cometbft_tpu/statesync/reactor.py;
reference: statesync/reactor.go:32).

Serving side: answers SnapshotsRequest from the app's ListSnapshots
and ChunkRequest from LoadSnapshotChunk.  Syncing side: feeds peer
advertisements and chunks into the Syncer, runs ``sync_any`` in a
background thread, and hands the bootstrapped state to the node's
completion callback (node/setup.go:557 startStateSync).

``receive`` is the ``statesync_reactor`` trust-guard seam.  Where the
port departs from its reference: ``on_stop`` joins the sync thread
(bounded) once the sync has ended, so a stopped node leaves none behind.
"""

from __future__ import annotations

import threading

from cometbft_tpu_torch.abci.types import LoadSnapshotChunkRequest
from cometbft_tpu_torch.p2p.base_reactor import Envelope, Reactor
from cometbft_tpu_torch.p2p.conn.connection import ChannelDescriptor
from cometbft_tpu_torch.statesync.messages import (
    CHUNK_CHANNEL,
    ChunkRequest,
    ChunkResponse,
    SNAPSHOT_CHANNEL,
    SnapshotsRequest,
    SnapshotsResponse,
    decode_ss_message,
    encode_ss_message,
)
from cometbft_tpu_torch.statesync.syncer import Snapshot, Syncer
from cometbft_tpu_torch.utils.log import Logger, default_logger
from cometbft_tpu_torch.utils import trustguard

_MAX_MSG_BYTES = 16 * 1024 * 1024 + 1024
RECENT_SNAPSHOTS = 10  # reactor.go recentSnapshots


class StatesyncReactor(Reactor):
    """(statesync/reactor.go:32 Reactor)"""

    def __init__(
        self,
        app_conn_snapshot,
        enabled: bool = False,
        state_provider=None,
        on_complete=None,  # (state, commit) -> None
        discovery_time: float = 5.0,
        logger: Logger | None = None,
        metrics=None,
    ):
        super().__init__(
            name="statesync",
            logger=logger or default_logger().with_fields(module="statesync"),
        )
        from cometbft_tpu_torch.metrics import StateSyncMetrics

        self.app = app_conn_snapshot
        self.enabled = enabled
        self.on_complete = on_complete
        self.discovery_time = discovery_time
        self.metrics = metrics if metrics is not None else StateSyncMetrics()
        self.syncer: Syncer | None = None
        if enabled:
            if state_provider is None:
                raise ValueError("statesync enabled but no state provider")
            self.syncer = Syncer(
                app_conn_snapshot,
                state_provider,
                request_snapshots=self._broadcast_snapshots_request,
                request_chunk=self._request_chunk,
                logger=self.logger,
                metrics=self.metrics,
            )
        self._thread: threading.Thread | None = None
        self.sync_done = threading.Event()
        self.sync_error: Exception | None = None
        if not enabled:
            self.sync_done.set()

    def get_channels(self) -> list[ChannelDescriptor]:
        return [
            ChannelDescriptor(
                id=SNAPSHOT_CHANNEL, priority=5,
                send_queue_capacity=10,
                recv_message_capacity=_MAX_MSG_BYTES,
            ),
            ChannelDescriptor(
                id=CHUNK_CHANNEL, priority=3,
                send_queue_capacity=16,
                recv_message_capacity=_MAX_MSG_BYTES,
            ),
        ]

    def on_start(self) -> None:
        if self.enabled and self.syncer is not None:
            self._thread = threading.Thread(
                target=self._sync_routine, name="statesync-run", daemon=True
            )
            self._thread.start()

    def on_stop(self) -> None:
        if self._thread is not None and self.sync_done.is_set():
            self._thread.join(timeout=2.0)

    def _sync_routine(self) -> None:
        self.metrics.syncing.set(1)
        try:
            state, commit = self.syncer.sync_any(
                discovery_time=self.discovery_time
            )
        except Exception as exc:  # noqa: BLE001 — surfaced via sync_error
            self.logger.error("state sync failed", err=repr(exc))
            self.sync_error = exc
            self.metrics.syncing.set(0)
            self.sync_done.set()
            return
        try:
            if self.on_complete is not None:
                self.on_complete(state, commit)
        except Exception as exc:  # noqa: BLE001 — bootstrap failed:
            # waiters must see the error, not a false success
            self.logger.error("state sync bootstrap failed", err=repr(exc))
            self.sync_error = exc
        finally:
            self.enabled = False
            self.metrics.syncing.set(0)
            self.sync_done.set()

    # -- peer lifecycle ---------------------------------------------------

    def add_peer(self, peer) -> None:
        if self.enabled:
            peer.try_send(
                SNAPSHOT_CHANNEL, encode_ss_message(SnapshotsRequest())
            )

    def remove_peer(self, peer, reason=None) -> None:
        if self.syncer is not None:
            self.syncer.remove_peer(peer.id)

    # -- receive ----------------------------------------------------------

    @trustguard.guarded_seam("statesync_reactor")
    def receive(self, env: Envelope) -> None:
        try:
            msg = decode_ss_message(env.message)
        except Exception as exc:  # noqa: BLE001
            self.logger.error("malformed statesync msg", err=repr(exc))
            if self.switch is not None:
                self.switch.stop_peer_for_error(env.src, exc)
            return
        if isinstance(msg, SnapshotsRequest):
            self._serve_snapshots(env.src)
        elif isinstance(msg, SnapshotsResponse):
            if self.syncer is not None:
                self.syncer.add_snapshot(
                    env.src.id,
                    Snapshot(
                        height=msg.height, format=msg.format,
                        chunks=msg.chunks, hash=msg.hash,
                        metadata=msg.metadata,
                    ),
                )
        elif isinstance(msg, ChunkRequest):
            self._serve_chunk(env.src, msg)
        elif isinstance(msg, ChunkResponse):
            if self.syncer is not None and not msg.missing:
                self.syncer.add_chunk(
                    msg.height, msg.format, msg.index, msg.chunk
                )

    # -- serving (reactor.go:160 handleSnapshotRequest) --------------------

    def _serve_snapshots(self, peer) -> None:
        resp = self.app.list_snapshots()
        for snapshot in resp.snapshots[-RECENT_SNAPSHOTS:]:
            peer.try_send(
                SNAPSHOT_CHANNEL,
                encode_ss_message(
                    SnapshotsResponse(
                        height=snapshot.height, format=snapshot.format,
                        chunks=snapshot.chunks, hash=snapshot.hash,
                        metadata=snapshot.metadata,
                    )
                ),
            )

    def _serve_chunk(self, peer, msg: ChunkRequest) -> None:
        resp = self.app.load_snapshot_chunk(
            LoadSnapshotChunkRequest(
                height=msg.height, format=msg.format, chunk=msg.index
            )
        )
        peer.try_send(
            CHUNK_CHANNEL,
            encode_ss_message(
                ChunkResponse(
                    height=msg.height, format=msg.format, index=msg.index,
                    chunk=resp.chunk, missing=not resp.chunk,
                )
            ),
        )

    # -- syncer callbacks --------------------------------------------------

    def _broadcast_snapshots_request(self) -> None:
        if self.switch is not None:
            self.switch.broadcast(
                SNAPSHOT_CHANNEL, encode_ss_message(SnapshotsRequest())
            )

    def _request_chunk(self, peer_id: str, snapshot, index: int) -> None:
        if self.switch is None:
            return
        peer = self.switch.peers.get(peer_id)
        if peer is None:
            return
        peer.try_send(
            CHUNK_CHANNEL,
            encode_ss_message(
                ChunkRequest(
                    height=snapshot.height, format=snapshot.format,
                    index=index,
                )
            ),
        )


__all__ = ["StatesyncReactor", "RECENT_SNAPSHOTS"]
