"""Blocksync pool — the pipelined block fetcher (a copy of
cometbft_tpu/blocksync/pool.py; reference: internal/blocksync/pool.go:72).

Keeps up to 400 block requests in flight across peers
(pool.go:36 maxPendingRequests window), tracks each peer's advertised
[base, height] range, retries timed-out requests on other peers, and
hands the sync loop consecutive block pairs: block H is validated with
block H+1's LastCommit before being applied.

The pool locks with ``utils/sync``'s ``Mutex()`` and takes the
``random.Random`` its peer pick draws from as an optional constructor
argument, so a test can seed it.
"""

from __future__ import annotations

import random
import threading
import time

from cometbft_tpu_torch.types.block import Block
from cometbft_tpu_torch.utils.flight import FLIGHT
from cometbft_tpu_torch.utils.log import Logger, default_logger
from cometbft_tpu_torch.utils import sync as cmtsync

REQUEST_WINDOW = 400          # pool.go:36 maxPendingRequests
REQUEST_TIMEOUT = 15.0        # pool.go requestTimeout


class PoolError(Exception):
    pass


class _BSPeer:
    """(pool.go bpPeer)"""

    def __init__(self, peer_id: str, base: int, height: int):
        self.id = peer_id
        self.base = base
        self.height = height
        self.num_pending = 0
        self.recv_bytes = 0
        self.first_request_time: float | None = None

    def recv_rate(self) -> float:
        if self.first_request_time is None:
            return float("inf")
        dur = max(time.monotonic() - self.first_request_time, 1e-9)
        return self.recv_bytes / dur


class _Requester:
    """(pool.go bpRequester) — one outstanding height."""

    def __init__(self, height: int, peer_id: str):
        self.height = height
        self.peer_id = peer_id
        self.block: Block | None = None
        self.ext_votes = None  # extended precommit votes, when carried
        self.request_time = time.monotonic()


class BlockPool:
    """(internal/blocksync/pool.go:72 BlockPool)

    Callbacks: ``send_request(peer_id, height)`` asks the reactor to
    transmit a BlockRequest; ``send_error(peer_id, reason)`` asks the
    switch to drop a misbehaving/slow peer.
    """

    def __init__(
        self,
        start_height: int,
        send_request,
        send_error,
        logger: Logger | None = None,
        metrics=None,
        rng: random.Random | None = None,
    ):
        from cometbft_tpu_torch.metrics import BlockSyncMetrics

        self.logger = logger or default_logger().with_fields(module="blockpool")
        self.metrics = metrics if metrics is not None else BlockSyncMetrics()
        self._mtx = cmtsync.Mutex()
        self.height = start_height  # next height to pop
        self.start_height = start_height
        self._peers: dict[str, _BSPeer] = {}
        self._requesters: dict[int, _Requester] = {}
        self._send_request = send_request
        self._send_error = send_error
        self._rng = rng if rng is not None else random.Random()
        self.last_advance = time.monotonic()
        self.sync_started = time.monotonic()
        self.blocks_synced = 0

    # -- peer bookkeeping (pool.go SetPeerRange/RemovePeer) -------------

    def set_peer_range(self, peer_id: str, base: int, height: int) -> None:
        with self._mtx:
            peer = self._peers.get(peer_id)
            if peer is None:
                self._peers[peer_id] = _BSPeer(peer_id, base, height)
            else:
                peer.base, peer.height = base, height

    def remove_peer(self, peer_id: str) -> None:
        with self._mtx:
            self._peers.pop(peer_id, None)
            for req in self._requesters.values():
                if req.peer_id == peer_id and req.block is None:
                    req.peer_id = ""  # reassign on next tick

    def num_peers(self) -> int:
        with self._mtx:
            return len(self._peers)

    def max_peer_height(self) -> int:
        with self._mtx:
            return max((p.height for p in self._peers.values()), default=0)

    # -- request scheduling (pool.go makeNextRequests) -------------------

    def make_next_requests(self) -> None:
        """Fill the request window; retry timed-out or orphaned
        requests on other peers."""
        now = time.monotonic()
        to_send: list[tuple[str, int]] = []
        to_error: list[str] = []  # callbacks run OUTSIDE the lock: the
        # error path re-enters pool.remove_peer via the switch
        with self._mtx:
            max_height = max(
                (p.height for p in self._peers.values()), default=0
            )
            window_top = min(self.height + REQUEST_WINDOW, max_height + 1)
            for h in range(self.height, window_top):
                req = self._requesters.get(h)
                if req is not None and req.block is None:
                    expired = now - req.request_time > REQUEST_TIMEOUT
                    if req.peer_id and not expired:
                        continue
                    if req.peer_id and expired:
                        # report each dead peer once; its other pending
                        # requests are orphaned silently
                        if req.peer_id in self._peers:
                            to_error.append(req.peer_id)
                            self._peers.pop(req.peer_id, None)
                        req.peer_id = ""
                if req is not None and req.block is not None:
                    continue
                peer = self._pick_peer_locked(h)
                if peer is None:
                    continue
                if req is None:
                    req = _Requester(h, peer.id)
                    self._requesters[h] = req
                else:
                    req.peer_id = peer.id
                    req.request_time = now
                peer.num_pending += 1
                if peer.first_request_time is None:
                    peer.first_request_time = now
                to_send.append((peer.id, h))
            self.metrics.request_pipeline_depth.set(
                sum(
                    1
                    for r in self._requesters.values()
                    if r.block is None and r.peer_id
                )
            )
        for peer_id in to_error:
            self.metrics.peer_timeouts.inc()
            FLIGHT.record("blocksync_timeout", peer=peer_id)
            self._send_error(peer_id, "block request timeout")
        for peer_id, h in to_send:
            FLIGHT.record("blocksync_request", peer=peer_id, height=h)
            self._send_request(peer_id, h)

    def _pick_peer_locked(self, height: int) -> _BSPeer | None:
        """Random available peer whose range covers ``height``
        (pool.go pickIncrAvailablePeer)."""
        candidates = [
            p
            for p in self._peers.values()
            if p.base <= height <= p.height and p.num_pending < 20
        ]
        if not candidates:
            return None
        return self._rng.choice(candidates)

    # -- block arrival (pool.go AddBlock) --------------------------------

    def add_block(self, peer_id: str, block: Block, size: int,
                  ext_votes=None) -> bool:
        with self._mtx:
            req = self._requesters.get(block.header.height)
            if req is None or req.peer_id != peer_id:
                # unsolicited or late duplicate — ignore (pool.go:244)
                return False
            if req.block is not None:
                return False
            req.block = block
            req.ext_votes = ext_votes
            peer = self._peers.get(peer_id)
            if peer is not None:
                peer.num_pending = max(0, peer.num_pending - 1)
                peer.recv_bytes += size
            return True

    def no_block(self, peer_id: str, height: int) -> None:
        """Peer said it doesn't have the block it advertised."""
        with self._mtx:
            req = self._requesters.get(height)
            if req is not None and req.peer_id == peer_id and req.block is None:
                req.peer_id = ""
                req.request_time = 0.0

    # -- the sync loop's view (pool.go PeekTwoBlocks/PopRequest) ---------

    def first_extended_votes(self):
        """Extended votes carried with the first (pool.height) block's
        response, if the serving peer had them (pool.go analog of the
        ExtendedCommit ferried in bcproto BlockResponse)."""
        with self._mtx:
            req = self._requesters.get(self.height)
            return req.ext_votes if req else None

    def peek_blocks_from(self, start: int, count: int) -> list:
        """Blocks already received for heights [start, start+count) —
        ``None`` holes included.  Read-only prefetch peek for the
        verify-ahead plane (blocksync/reactor.py submits the peeked
        blocks' commit signatures to the verify queue while the
        current block applies); the requesters stay owned by the
        pool."""
        with self._mtx:
            out = []
            for h in range(start, start + count):
                req = self._requesters.get(h)
                out.append(req.block if req else None)
            return out

    def peek_two_blocks(self) -> tuple[Block | None, Block | None]:
        with self._mtx:
            first = self._requesters.get(self.height)
            second = self._requesters.get(self.height + 1)
            return (
                first.block if first else None,
                second.block if second else None,
            )

    def pop_request(self) -> None:
        with self._mtx:
            self._requesters.pop(self.height, None)
            self.height += 1
            self.blocks_synced += 1
            self.last_advance = time.monotonic()

    def redo_request(self, height: int) -> str:
        """First block failed validation: both blocks' peers are suspect
        (pool.go RedoRequest). Returns the offending peer id."""
        with self._mtx:
            req = self._requesters.get(height)
            if req is None:
                return ""
            peer_id = req.peer_id
            if peer_id and peer_id in self._peers:
                self.metrics.peer_evictions.inc()
                FLIGHT.record(
                    "blocksync_evict", peer=peer_id, height=height
                )
            self._peers.pop(peer_id, None)
            # orphan every in-flight request assigned to the removed
            # peer, or they'd sit out the full request timeout
            # (reference RemovePeer redoes all of a peer's requests)
            for r in self._requesters.values():
                if r.peer_id == peer_id:
                    r.peer_id = ""
                    r.block = None
                    r.request_time = 0.0
            return peer_id

    # -- progress (pool.go IsCaughtUp) -----------------------------------

    def is_caught_up(self) -> bool:
        with self._mtx:
            if not self._peers:
                return False
            max_height = max(p.height for p in self._peers.values())
            return self.height >= max_height

    def status(self) -> dict:
        with self._mtx:
            return {
                "height": self.height,
                "num_peers": len(self._peers),
                "num_pending": sum(
                    1
                    for r in self._requesters.values()
                    if r.block is None
                ),
                "blocks_synced": self.blocks_synced,
            }


__all__ = ["BlockPool", "PoolError", "REQUEST_WINDOW"]
