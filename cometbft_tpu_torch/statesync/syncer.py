"""Statesync syncer — bootstrap a node from an app snapshot (a copy of
cometbft_tpu/statesync/syncer.py; reference: statesync/syncer.go:144
SyncAny).

Discovery: peers advertise snapshots (snapshotPool, snapshots.go).
For the best candidate: ABCI OfferSnapshot → fetch chunks from the
peers that have them (chunkQueue, chunks.go) → ApplySnapshotChunk →
verify the restored app hash against the light-client state provider →
hand back the trusted state + commit for the node to bootstrap with.

The locks are ``utils/sync``'s ``Mutex()`` and ``add_chunk`` is the
``statesync_chunk`` trust-guard seam, as in the reference.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from cometbft_tpu_torch.abci.types import (
    ApplySnapshotChunkRequest,
    InfoRequest,
    ApplySnapshotChunkResult,
    OfferSnapshotRequest,
    OfferSnapshotResult,
    Snapshot as ABCISnapshot,
)
from cometbft_tpu_torch.statesync.stateprovider import (
    StateProvider,
    StateProviderError,
)
from cometbft_tpu_torch.utils.flight import FLIGHT
from cometbft_tpu_torch.utils.log import Logger, default_logger
from cometbft_tpu_torch.utils.trace import TRACER
from cometbft_tpu_torch.utils import sync as cmtsync
from cometbft_tpu_torch.utils import trustguard

CHUNK_TIMEOUT = 10.0        # config chunk_request_timeout
RETRIES_PER_CHUNK = 3


class SyncError(Exception):
    pass


class SnapshotRejectedError(SyncError):
    pass


class NoSnapshotsError(SyncError):
    pass


@dataclass(frozen=True)
class Snapshot:
    """A peer-advertised snapshot (statesync/snapshots.go snapshot)."""

    height: int
    format: int
    chunks: int
    hash: bytes
    metadata: bytes = b""

    def key(self) -> tuple:
        # chunks is part of the identity: a same-hash advertisement with
        # a different chunk count is a DIFFERENT (and bogus) snapshot
        return (self.height, self.format, self.chunks, self.hash,
                self.metadata)


class SnapshotPool:
    """Snapshots and which peers can serve them (snapshots.go:37)."""

    def __init__(self) -> None:
        self._mtx = cmtsync.Mutex()
        self._snapshots: dict[tuple, Snapshot] = {}
        self._peers: dict[tuple, set[str]] = {}
        self._rejected: set[tuple] = set()

    def add(self, peer_id: str, snapshot: Snapshot) -> bool:
        with self._mtx:
            key = snapshot.key()
            if key in self._rejected:
                return False
            fresh = key not in self._snapshots
            self._snapshots[key] = snapshot
            self._peers.setdefault(key, set()).add(peer_id)
            return fresh

    def best(self) -> Snapshot | None:
        """Highest height, then most peers (snapshots.go Best)."""
        with self._mtx:
            ranked = sorted(
                self._snapshots.values(),
                key=lambda s: (s.height, len(self._peers.get(s.key(), ()))),
                reverse=True,
            )
            return ranked[0] if ranked else None

    def peers_for(self, snapshot: Snapshot) -> list[str]:
        with self._mtx:
            return list(self._peers.get(snapshot.key(), ()))

    def reject(self, snapshot: Snapshot) -> None:
        with self._mtx:
            key = snapshot.key()
            self._rejected.add(key)
            self._snapshots.pop(key, None)
            self._peers.pop(key, None)

    def remove_peer(self, peer_id: str) -> None:
        with self._mtx:
            for key in list(self._peers):
                self._peers[key].discard(peer_id)
                if not self._peers[key]:
                    del self._peers[key]
                    self._snapshots.pop(key, None)

    def size(self) -> int:
        with self._mtx:
            return len(self._snapshots)


class ChunkQueue:
    """Assembles fetched chunks for one snapshot (chunks.go:27)."""

    def __init__(self, snapshot: Snapshot):
        self.snapshot = snapshot
        self._mtx = cmtsync.Mutex()
        self._chunks: dict[int, bytes] = {}
        self._arrived = threading.Condition(self._mtx)

    def add(self, index: int, chunk: bytes) -> bool:
        with self._mtx:
            if index in self._chunks or not (
                0 <= index < self.snapshot.chunks
            ):
                return False
            self._chunks[index] = chunk
            self._arrived.notify_all()
            return True

    def get(self, index: int) -> bytes | None:
        with self._mtx:
            return self._chunks.get(index)

    def wait_for(self, index: int, timeout: float) -> bytes | None:
        deadline = time.monotonic() + timeout
        with self._mtx:
            while index not in self._chunks:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._arrived.wait(remaining):
                    return self._chunks.get(index)
            return self._chunks[index]

    def discard(self, index: int) -> None:
        with self._mtx:
            self._chunks.pop(index, None)


class Syncer:
    """(statesync/syncer.go:42 syncer)

    ``request_snapshots()`` and ``request_chunk(peer_id, snapshot,
    index)`` are reactor callbacks doing the actual p2p sends.
    """

    def __init__(
        self,
        app_conn_snapshot,
        state_provider: StateProvider,
        request_snapshots,
        request_chunk,
        logger: Logger | None = None,
        metrics=None,
    ):
        from cometbft_tpu_torch.metrics import StateSyncMetrics

        self.app = app_conn_snapshot
        self.state_provider = state_provider
        self.request_snapshots = request_snapshots
        self.request_chunk = request_chunk
        self.logger = logger or default_logger().with_fields(module="statesync")
        self.metrics = metrics if metrics is not None else StateSyncMetrics()
        self.pool = SnapshotPool()
        self._chunk_queue: ChunkQueue | None = None
        self._mtx = cmtsync.Mutex()

    # -- inbound from reactor --------------------------------------------

    def add_snapshot(self, peer_id: str, snapshot: Snapshot) -> None:
        if self.pool.add(peer_id, snapshot):
            self.metrics.total_snapshots.inc()
            FLIGHT.record(
                "statesync_snapshot", peer=peer_id,
                height=snapshot.height, chunks=snapshot.chunks,
            )
            self.logger.info(
                "discovered snapshot", height=snapshot.height,
                fmt=snapshot.format, chunks=snapshot.chunks,
            )

    @trustguard.guarded_seam("statesync_chunk")
    def add_chunk(self, height: int, fmt: int, index: int,
                  chunk: bytes) -> None:
        with self._mtx:
            q = self._chunk_queue
        if q is None or q.snapshot.height != height or q.snapshot.format != fmt:
            return
        q.add(index, chunk)

    def remove_peer(self, peer_id: str) -> None:
        self.pool.remove_peer(peer_id)

    # -- the sync driver (syncer.go:144 SyncAny) --------------------------

    def sync_any(self, discovery_time: float = 5.0,
                 deadline: float | None = None):
        """Discover → offer → fetch → apply → verify.  Returns
        (state, commit) for the node to bootstrap with."""
        self.request_snapshots()
        start = time.monotonic()
        while self.pool.size() == 0:
            if deadline is not None and time.monotonic() > deadline:
                raise NoSnapshotsError("no snapshots discovered in time")
            if time.monotonic() - start > discovery_time:
                self.request_snapshots()
                start = time.monotonic()
            time.sleep(0.1)

        while True:
            snapshot = self.pool.best()
            if snapshot is None:
                raise NoSnapshotsError("all discovered snapshots failed")
            try:
                return self._sync_one(snapshot)
            except SnapshotRejectedError as exc:
                self.logger.info(
                    "snapshot rejected", height=snapshot.height,
                    err=str(exc),
                )
                self.pool.reject(snapshot)
            except StateProviderError as exc:
                # transient provider trouble (e.g. header H+1 races
                # the chain head, a primary briefly unreachable) must
                # not abort the whole sync — reject THIS snapshot and
                # try the next-best (syncer.go treats provider errors
                # per-snapshot the same way)
                self.logger.error(
                    "state provider failed for snapshot",
                    height=snapshot.height,
                    err=str(exc),
                )
                self.pool.reject(snapshot)

    def _sync_one(self, snapshot: Snapshot):
        """(syncer.go:234 Sync)"""
        self.metrics.snapshot_height.set(snapshot.height)
        self.metrics.snapshot_chunk_total.set(snapshot.chunks)
        self.metrics.snapshot_chunk.set(0)
        FLIGHT.record(
            "statesync_offer", height=snapshot.height,
            chunks=snapshot.chunks,
        )
        # trusted app hash BEFORE offering (syncer.go verifies upfront)
        trusted_app_hash = self.state_provider.app_hash(snapshot.height)

        resp = self.app.offer_snapshot(
            OfferSnapshotRequest(
                snapshot=ABCISnapshot(
                    height=snapshot.height,
                    format=snapshot.format,
                    chunks=snapshot.chunks,
                    hash=snapshot.hash,
                    metadata=snapshot.metadata,
                ),
                app_hash=trusted_app_hash,
            )
        )
        if resp.result != OfferSnapshotResult.ACCEPT:
            raise SnapshotRejectedError(f"app returned {resp.result!r}")

        # fetch the bootstrap state + commit BEFORE restoring chunks
        # (syncer.go:294): a provider failure must reject the snapshot
        # while the app is still untouched — after restore there is no
        # clean way to offer a different snapshot to the app
        state = self.state_provider.state(snapshot.height)
        commit = self.state_provider.commit(snapshot.height)

        with self._mtx:
            self._chunk_queue = ChunkQueue(snapshot)
        try:
            self._fetch_and_apply_chunks(snapshot)
        finally:
            with self._mtx:
                self._chunk_queue = None

        # verify the restored app against the trusted hash (syncer.go:459)
        info = self.app.info(InfoRequest())
        if info.last_block_app_hash != trusted_app_hash:
            raise SnapshotRejectedError(
                f"restored app hash {info.last_block_app_hash.hex()[:12]} "
                f"!= trusted {trusted_app_hash.hex()[:12]}"
            )
        if info.last_block_height != snapshot.height:
            raise SnapshotRejectedError(
                f"restored app height {info.last_block_height} "
                f"!= snapshot {snapshot.height}"
            )

        self.logger.info(
            "snapshot restored and verified", height=snapshot.height
        )
        return state, commit

    def _fetch_and_apply_chunks(self, snapshot: Snapshot) -> None:
        q = self._chunk_queue
        peers = self.pool.peers_for(snapshot)
        if not peers:
            raise SnapshotRejectedError("no peers serve this snapshot")
        applied = 0
        index = 0
        while applied < snapshot.chunks:
            chunk = q.get(index)
            if chunk is None:
                chunk = self._fetch_chunk(snapshot, index, peers)
            t0 = time.perf_counter()
            with TRACER.span(
                "statesync/apply_chunk", cat="statesync",
                height=snapshot.height, index=index,
            ):
                result = self.app.apply_snapshot_chunk(
                    ApplySnapshotChunkRequest(
                        index=index, chunk=chunk, sender=""
                    )
                )
            self.metrics.chunk_process_time.observe(
                time.perf_counter() - t0
            )
            FLIGHT.record(
                "statesync_chunk", height=snapshot.height, index=index,
                result=str(result.result),
            )
            if result.result == ApplySnapshotChunkResult.ACCEPT:
                applied += 1
                index += 1
                self.metrics.snapshot_chunk.set(applied)
            elif result.result == ApplySnapshotChunkResult.RETRY:
                q.discard(index)
            elif result.result == ApplySnapshotChunkResult.RETRY_SNAPSHOT:
                raise SnapshotRejectedError("app asked to retry snapshot")
            else:
                raise SnapshotRejectedError(
                    f"chunk {index} -> {result.result!r}"
                )

    def _fetch_chunk(self, snapshot: Snapshot, index: int,
                     peers: list[str]) -> bytes:
        for attempt in range(RETRIES_PER_CHUNK):
            peer_id = peers[(index + attempt) % len(peers)]
            self.request_chunk(peer_id, snapshot, index)
            chunk = self._chunk_queue.wait_for(index, CHUNK_TIMEOUT)
            if chunk is not None:
                return chunk
        raise SnapshotRejectedError(
            f"chunk {index} unavailable after {RETRIES_PER_CHUNK} tries"
        )


__all__ = [
    "ChunkQueue",
    "NoSnapshotsError",
    "Snapshot",
    "SnapshotPool",
    "SnapshotRejectedError",
    "SyncError",
    "Syncer",
]
