"""Blocksync reactor — fast chain catch-up (a copy of
cometbft_tpu/blocksync/reactor.py; reference:
internal/blocksync/reactor.go:55, channel 0x40 at reactor.go:20).

Serves blocks from the store to lagging peers and, when started in
sync mode, drives the BlockPool: request blocks pipelined 400 ahead,
validate each block H with block H+1's LastCommit
(``verify_commit_light`` — the card's batch plane; reactor.go:550),
apply through the shared BlockExecutor, and hand off to consensus once
caught up (reactor.go SwitchToConsensus).

Where the port departs from its reference:
- ``BlocksyncReactor`` takes a keyword ``device`` (``cuda`` unless the
  caller names another; without a card only ``device="cpu"`` runs) and
  passes it to ``verify_commit_light``, and takes the prefetch depth as
  ``prefetch_depth`` (default ``verify_queue.DEFAULT_PREFETCH_DEPTH``);
  the reference reads ``CMT_TPU_VERIFY_PREFETCH``;
- ``_try_sync_step`` reads a block as a peer's bad block only on a
  verification error (``CommitError``, or a ``LastCommit`` for another
  block): then it redoes both heights and stops both peers, as the
  reference does.  The reference takes every exception that way, so a
  fault of the card or of a kernel's build would ban an honest peer;
  in the port it reaches ``_pool_routine``, which logs it and retries
  as the reference does, and also records it in ``FLIGHT`` and in
  ``pool_routine_errors``;
- ``receive`` decodes in a ``blocksync/decode`` span (kind, bytes), and
  a block pair is validated and applied in a ``blocksync/sync_step``
  span (height) holding ``blocksync/part_set`` and
  ``blocksync/prefetch`` (sigs) (utils/trace.py); the reference has
  none of them.
"""

from __future__ import annotations

import threading
import time

from cometbft_tpu_torch.blocksync.pool import BlockPool
from cometbft_tpu_torch.crypto.verify_queue import DEFAULT_PREFETCH_DEPTH
from cometbft_tpu_torch.p2p.base_reactor import Envelope, Reactor
from cometbft_tpu_torch.p2p.conn.connection import ChannelDescriptor
from cometbft_tpu_torch.state import State
from cometbft_tpu_torch.types import codec
from cometbft_tpu_torch.types.block import BlockID
from cometbft_tpu_torch.types.part_set import BLOCK_PART_SIZE_BYTES, PartSet
from cometbft_tpu_torch.types.validation import CommitError, verify_commit_light
from cometbft_tpu_torch.utils.env import resolve_device
from cometbft_tpu_torch.utils.flight import FLIGHT
from cometbft_tpu_torch.utils.log import Logger, default_logger
from cometbft_tpu_torch.utils.protoio import ProtoReader, ProtoWriter
from cometbft_tpu_torch.utils.trace import TRACER
from cometbft_tpu_torch.types.codec import as_bytes as _bz, as_int as _iv
from cometbft_tpu_torch.utils import trustguard

BLOCKSYNC_CHANNEL = 0x40

_MAX_MSG_BYTES = 10485760 + 1024  # a max-size block + framing slack

STATUS_UPDATE_INTERVAL = 10.0     # reactor.go statusUpdateIntervalSeconds
SWITCH_TO_CONSENSUS_INTERVAL = 1.0
POOL_TICK = 0.02


class WrongLastCommitError(ValueError):
    """Block H+1's LastCommit is for another block than the block H it
    arrived with: the peers' fault, like a failed verification."""


# -- wire messages (proto/cometbft/blocksync/v1/types.proto) ------------

_F_BLOCK_REQUEST = 1
_F_NO_BLOCK_RESPONSE = 2
_F_BLOCK_RESPONSE = 3
_F_STATUS_REQUEST = 4
_F_STATUS_RESPONSE = 5


def encode_block_request(height: int) -> bytes:
    m = ProtoWriter()
    m.varint(1, height)
    w = ProtoWriter()
    w.message(_F_BLOCK_REQUEST, m.finish())
    return w.finish()


def encode_no_block_response(height: int) -> bytes:
    m = ProtoWriter()
    m.varint(1, height)
    w = ProtoWriter()
    w.message(_F_NO_BLOCK_RESPONSE, m.finish())
    return w.finish()


def encode_block_response(block, ext_votes_blob: bytes | None = None) -> bytes:
    m = ProtoWriter()
    m.message(1, codec.encode_block(block))
    if ext_votes_blob:
        # field 2 mirrors bcproto BlockResponse.ext_commit: the
        # precommit votes (with extensions) for this block, so a node
        # syncing through an extension-enabled height can later
        # propose with a populated local_last_commit
        m.message(2, ext_votes_blob)
    w = ProtoWriter()
    w.message(_F_BLOCK_RESPONSE, m.finish())
    return w.finish()


def encode_status_request() -> bytes:
    w = ProtoWriter()
    w.message(_F_STATUS_REQUEST, b"")
    return w.finish()


def encode_status_response(height: int, base: int) -> bytes:
    m = ProtoWriter()
    m.varint(1, height)
    m.varint(2, base)
    w = ProtoWriter()
    w.message(_F_STATUS_RESPONSE, m.finish())
    return w.finish()


def decode_bs_message(data: bytes):
    f = ProtoReader(data).to_dict()
    if _F_BLOCK_REQUEST in f:
        m = ProtoReader(_bz(f[_F_BLOCK_REQUEST][0])).to_dict()
        return ("block_request", _iv(m.get(1, [0])[0]))
    if _F_NO_BLOCK_RESPONSE in f:
        m = ProtoReader(_bz(f[_F_NO_BLOCK_RESPONSE][0])).to_dict()
        return ("no_block", _iv(m.get(1, [0])[0]))
    if _F_BLOCK_RESPONSE in f:
        m = ProtoReader(_bz(f[_F_BLOCK_RESPONSE][0])).to_dict()
        ext_votes = None
        if 2 in m:
            from cometbft_tpu_torch.store import BlockStore

            ext_votes = BlockStore.decode_extended_votes(_bz(m[2][0]))
        return ("block", codec.decode_block(_bz(m[1][0])), ext_votes)
    if _F_STATUS_REQUEST in f:
        return ("status_request",)
    if _F_STATUS_RESPONSE in f:
        m = ProtoReader(_bz(f[_F_STATUS_RESPONSE][0])).to_dict()
        return ("status", _iv(m.get(1, [0])[0]), _iv(m.get(2, [0])[0]))
    raise ValueError("unknown blocksync message")


class BlocksyncReactor(Reactor):
    """(internal/blocksync/reactor.go:55 Reactor)"""

    def __init__(
        self,
        state: State,
        block_exec,
        block_store,
        block_sync: bool,
        consensus_reactor=None,  # for SwitchToConsensus
        local_addr=b"",  # bytes | Callable[[], bytes] (lazy resolver)
        logger: Logger | None = None,
        metrics=None,
        statesync_metrics=None,
        prefetch_depth: int = DEFAULT_PREFETCH_DEPTH,
        *,
        device=None,
    ):
        super().__init__(
            name="blocksync",
            logger=logger or default_logger().with_fields(module="blocksync"),
        )
        from cometbft_tpu_torch.metrics import BlockSyncMetrics, StateSyncMetrics

        self.metrics = metrics if metrics is not None else BlockSyncMetrics()
        #: blocks applied after a statesync handoff close the
        #: snapshot-to-head gap — they count as that plane's
        #: backfilled_blocks (statesync/metrics.go BackFilledBlocks,
        #: loose mapping: ours counts forward gap-fill, not the
        #: evidence-window backfill the reference runs)
        self.statesync_metrics = (
            statesync_metrics
            if statesync_metrics is not None
            else StateSyncMetrics()
        )
        self._backfilling = False
        self.device = resolve_device(device)
        #: exceptions _pool_routine caught (each also a FLIGHT event): a
        #: healthy sync counts none
        self.pool_routine_errors = 0
        self._pool_thread: threading.Thread | None = None
        self.initial_state = state
        self.state = state
        self.local_addr = local_addr
        self.block_exec = block_exec
        self.block_store = block_store
        self.block_sync = threading.Event()
        if block_sync:
            self.block_sync.set()
        self.consensus_reactor = consensus_reactor
        start_height = block_store.height() + 1
        if start_height == 1 and state.initial_height > 1:
            start_height = state.initial_height
        self.pool = BlockPool(
            start_height,
            send_request=self._send_block_request,
            send_error=self._on_pool_error,
            logger=self.logger,
            metrics=self.metrics,
        )
        self._caught_up_since: float | None = None
        self.metrics.syncing.set(1 if block_sync else 0)
        # verify-ahead prefetch (crypto/verify_queue.py): while block H
        # applies, the next N blocks' commit signatures go to the
        # verify queue as one prefetch-priority batch, so their
        # verify_commit_light is a speculative-cache hit and catch-up
        # is bounded by store I/O, not crypto (ROADMAP item 2).
        from cometbft_tpu_torch.metrics import crypto_metrics

        if prefetch_depth < 0:
            raise ValueError(f"prefetch_depth must be >= 0, got {prefetch_depth}")
        self._prefetch_depth = prefetch_depth
        self._prefetched_height = 0
        crypto_metrics().verify_queue_prefetch_depth.set(
            self._prefetch_depth
        )

    def is_syncing(self) -> bool:
        return self.block_sync.is_set()

    def get_channels(self) -> list[ChannelDescriptor]:
        return [
            ChannelDescriptor(
                id=BLOCKSYNC_CHANNEL,
                priority=5,
                send_queue_capacity=1000,
                recv_message_capacity=_MAX_MSG_BYTES,
            )
        ]

    # -- lifecycle ------------------------------------------------------

    def on_start(self) -> None:
        if self.block_sync.is_set():
            self._start_pool_routine()

    def _start_pool_routine(self) -> None:
        self._pool_thread = threading.Thread(
            target=self._pool_routine, name="blocksync-pool", daemon=True
        )
        self._pool_thread.start()

    def start_sync(self, state: State) -> None:
        """Enter sync mode post-statesync (reactor.go SwitchToBlockSync).
        Idempotent: a no-op if the pool routine is already running."""
        if self.block_sync.is_set():
            return
        self.state = state
        self.pool.height = state.last_block_height + 1
        self._backfilling = True  # closing the statesync gap
        self.block_sync.set()
        self.metrics.syncing.set(1)
        FLIGHT.record(
            "blocksync_start", height=self.pool.height, backfill=True
        )
        self._start_pool_routine()

    # -- peer lifecycle --------------------------------------------------

    def add_peer(self, peer) -> None:
        peer.send(
            BLOCKSYNC_CHANNEL,
            encode_status_response(
                self.block_store.height(), self.block_store.base()
            ),
        )

    def remove_peer(self, peer, reason=None) -> None:
        self.pool.remove_peer(peer.id)

    # -- receive ---------------------------------------------------------

    @trustguard.guarded_seam("blocksync_reactor")
    def receive(self, env: Envelope) -> None:
        try:
            with TRACER.span("blocksync/decode", cat="blocksync",
                             bytes=len(env.message)) as sp:
                msg = decode_bs_message(env.message)
                sp.set(kind=msg[0])
        except Exception as exc:  # noqa: BLE001
            self.logger.error("malformed blocksync msg", err=repr(exc))
            if self.switch is not None:
                self.switch.stop_peer_for_error(env.src, exc)
            return
        kind = msg[0]
        if kind == "block_request":
            self._respond_to_block_request(env.src, msg[1])
        elif kind == "block":
            block = msg[1]
            self.pool.add_block(
                env.src.id, block, len(env.message),
                ext_votes=msg[2] if len(msg) > 2 else None,
            )
        elif kind == "no_block":
            self.pool.no_block(env.src.id, msg[1])
        elif kind == "status_request":
            env.src.try_send(
                BLOCKSYNC_CHANNEL,
                encode_status_response(
                    self.block_store.height(), self.block_store.base()
                ),
            )
        elif kind == "status":
            _, height, base = msg
            self.pool.set_peer_range(env.src.id, base, height)

    def _respond_to_block_request(self, peer, height: int) -> None:
        block = self.block_store.load_block(height)
        if block is None:
            peer.try_send(BLOCKSYNC_CHANNEL, encode_no_block_response(height))
            return
        blob = self.block_store.load_seen_extended_votes_raw(height)
        peer.send(BLOCKSYNC_CHANNEL, encode_block_response(block, blob))

    # -- pool callbacks ---------------------------------------------------

    def _send_block_request(self, peer_id: str, height: int) -> None:
        if self.switch is None:
            return
        peer = self.switch.peers.get(peer_id)
        if peer is None:
            self.pool.remove_peer(peer_id)
            return
        peer.try_send(BLOCKSYNC_CHANNEL, encode_block_request(height))

    def _on_pool_error(self, peer_id: str, reason) -> None:
        if self.switch is None:
            return
        peer = self.switch.peers.get(peer_id)
        if peer is not None:
            self.switch.stop_peer_for_error(peer, reason)

    # -- the sync loop (reactor.go:374 poolRoutine) -----------------------

    def _pool_routine(self) -> None:
        last_status = 0.0
        last_switch_check = 0.0
        while not self._quit.is_set() and self.block_sync.is_set():
            now = time.monotonic()
            try:
                if now - last_status > STATUS_UPDATE_INTERVAL:
                    last_status = now
                    if self.switch is not None:
                        self.switch.broadcast(
                            BLOCKSYNC_CHANNEL, encode_status_request()
                        )
                self.pool.make_next_requests()
                made_progress = self._try_sync_step()
                if now - last_switch_check > SWITCH_TO_CONSENSUS_INTERVAL:
                    last_switch_check = now
                    if self._maybe_switch_to_consensus():
                        return
                if not made_progress:
                    self._quit.wait(POOL_TICK)
            except Exception as exc:  # noqa: BLE001
                self.logger.error("pool routine error", err=repr(exc))
                self.pool_routine_errors += 1
                FLIGHT.record("blocksync_pool_error", err=repr(exc))
                self._quit.wait(POOL_TICK)

    def _try_sync_step(self) -> bool:
        """Validate + apply the next block pair (reactor.go:536)."""
        first, second = self.pool.peek_two_blocks()
        if first is None or second is None:
            return False
        with TRACER.span("blocksync/sync_step", cat="blocksync",
                         height=first.header.height):
            return self._sync_step(first, second)

    def _sync_step(self, first, second) -> bool:
        with TRACER.span("blocksync/part_set", cat="blocksync"):
            first_bytes = codec.encode_block(first)
            first_parts = PartSet.from_bytes(first_bytes, BLOCK_PART_SIZE_BYTES)
        first_id = BlockID(
            hash=first.hash(), part_set_header=first_parts.header
        )
        try:
            # block H verified with H+1's LastCommit — the batch-verify
            # hot path (reactor.go:550 VerifyCommitLight)
            verify_commit_light(
                self.state.chain_id,
                self.state.validators,
                first_id,
                first.header.height,
                second.last_commit,
                device=self.device,
            )
            if second.last_commit.block_id.hash != first.hash():
                raise WrongLastCommitError(
                    "second block's LastCommit is for a different block"
                )
        except (CommitError, WrongLastCommitError) as exc:
            self.logger.error(
                "invalid block during sync",
                height=first.header.height, err=repr(exc),
            )
            peer1 = self.pool.redo_request(first.header.height)
            peer2 = self.pool.redo_request(first.header.height + 1)
            for pid in (peer1, peer2):
                if pid:
                    self._on_pool_error(pid, "sent invalid block")
            return False
        if self.block_store.height() < first.header.height:
            ext = None
            if self.state.consensus_params.vote_extensions_enabled(
                first.header.height
            ):
                ext = self.pool.first_extended_votes()
                if ext is not None and not self._extended_votes_valid(
                    first, first_id, ext
                ):
                    # fabricated blob: the peer is malicious — drop it
                    pid = self.pool.redo_request(first.header.height)
                    if pid:
                        self._on_pool_error(pid, "invalid extended votes")
                    return False
                if ext is None:
                    # without the extended votes this node could never
                    # propose height+1 (the reference panics on the
                    # missing extended commit).  The peer may simply be
                    # an honest pre-upgrade node whose store lacks
                    # them, so rotate to another peer WITHOUT banning;
                    # if no peer ever serves them, sync stalls loudly
                    # rather than silently breaking future proposals.
                    self.logger.error(
                        "peer served extension-enabled block without "
                        "extended votes; retrying elsewhere",
                        height=first.header.height,
                    )
                    self.pool.redo_request(first.header.height)
                    return False
            self.block_store.save_block(
                first, first_parts, second.last_commit,
                extended_votes=ext,
            )
        # verify-ahead: queue the NEXT blocks' commit signatures before
        # the (store-I/O-heavy) apply below, so their crypto runs on
        # the verify queue's launcher while this block applies
        self._prefetch_commit_verifies()
        self.state = self.block_exec.apply_block(
            self.state, first_id, first,
            syncing_to_height=self.pool.max_peer_height(),
        )
        self.pool.pop_request()
        m = self.metrics
        m.latest_block_height.set(first.header.height)
        m.num_txs.set(len(first.data.txs))
        m.total_txs.inc(len(first.data.txs))
        m.block_size_bytes.set(len(first_bytes))
        if self._backfilling:
            self.statesync_metrics.backfilled_blocks.inc()
        FLIGHT.record(
            "blocksync_apply", height=first.header.height,
            num_txs=len(first.data.txs),
        )
        return True

    def _prefetch_commit_verifies(self) -> None:
        """Submit the next ``prefetch_depth`` received blocks'
        commit signatures (block H's commit rides in block H+1's
        LastCommit) to the verify queue at prefetch priority — one
        coalesced device batch per sync step.  Pubkeys come from the
        CURRENT validator set: if the set rotates inside the window,
        the stale entries are wasted prefetch (cache misses at verify
        time, strictly re-verified), never wrong verdicts — cached
        facts are keyed by (pubkey, sign bytes, signature), not by
        height.  Each height is submitted once (``_prefetched_height``
        watermark); holes in the pool truncate the window."""
        from cometbft_tpu_torch.crypto import verify_queue as _vq

        if self._prefetch_depth <= 0 or not _vq.speculation_active():
            return
        with TRACER.span("blocksync/prefetch", cat="blocksync") as sp:
            sp.set(sigs=self._prefetch_window())

    def _prefetch_window(self) -> int:
        """``_prefetch_commit_verifies``' body -> the signatures
        submitted."""
        from cometbft_tpu_torch.crypto import verify_queue as _vq

        start = self.pool.height + 1
        blocks = self.pool.peek_blocks_from(
            start, self._prefetch_depth + 1
        )
        vals = self.state.validators
        chain_id = self.state.chain_id
        items = []
        heights = []
        for j in range(len(blocks) - 1):
            blk, nxt = blocks[j], blocks[j + 1]
            if blk is None or nxt is None:
                break  # hole: later blocks would verify out of order
            height = blk.header.height
            if height <= self._prefetched_height:
                continue
            commit = nxt.last_commit
            if commit is None or commit.size() != len(vals):
                break  # validator set rotated: stop, never guess
            mark = len(items)
            rotated = False
            for i, cs in enumerate(commit.signatures):
                if not cs.is_commit():
                    continue  # verify_commit_light checks commit votes
                if commit.is_aggregated(i):
                    # proven by the commit-level BLS aggregate (one
                    # pairing at verify time) — there is no per-sig
                    # signature to prefetch
                    continue
                val = vals.get_by_index(i)
                if val is None or val.address != cs.validator_address:
                    rotated = True
                    break
                items.append((
                    val.pub_key,
                    commit.vote_sign_bytes(chain_id, i),
                    cs.signature,
                ))
            if rotated:
                del items[mark:]  # drop this height's partial batch
                break
            heights.append(height)
        if items and _vq.submit_prefetch(items):
            # watermark advances ONLY on a successful enqueue: a
            # queue hiccup (draining/restart race) must retry these
            # heights next step, not silently skip them forever
            self._prefetched_height = heights[-1]
            FLIGHT.record(
                "blocksync_prefetch", first_height=heights[0],
                blocks=len(heights), sigs=len(items),
            )
            return len(items)
        return 0

    def _extended_votes_valid(self, block, block_id, votes) -> bool:
        """A blocksync peer's ferried extended votes are UNTRUSTED:
        every present vote must be a precommit for THIS block at this
        height by the right validator, with valid vote AND extension
        signatures — otherwise a malicious peer could plant
        never-verified extension bytes that a later PrepareProposal
        hands to the application."""
        from cometbft_tpu_torch.types import PRECOMMIT_TYPE

        vals = self.state.validators
        if len(votes) != len(vals):
            return False
        chain_id = self.state.chain_id
        for i, vote in enumerate(votes):
            if vote is None:
                continue
            val = vals.get_by_index(i)
            if (
                vote.type != PRECOMMIT_TYPE
                or vote.height != block.header.height
                or vote.validator_index != i
                or vote.validator_address != val.address
            ):
                return False
            if not vote.block_id.is_nil() and vote.block_id != block_id:
                return False
            if not val.pub_key.verify_signature(
                vote.sign_bytes(chain_id), vote.signature
            ):
                return False
            if vote.block_id.is_nil():
                if vote.extension or vote.extension_signature:
                    return False
                continue
            if not vote.extension_signature:
                return False
            if not val.pub_key.verify_signature(
                vote.extension_sign_bytes(chain_id),
                vote.extension_signature,
            ):
                return False
        return True

    def _local_node_blocks_the_chain(self) -> bool:
        """(reactor.go:509 localNodeBlocksTheChain) — with >= 1/3 of
        the voting power, the chain cannot have advanced without this
        node, so waiting on peers to sync from is a deadlock."""
        if not self.local_addr:
            return False
        try:
            addr = (
                self.local_addr()
                if callable(self.local_addr)
                else self.local_addr
            )
        except Exception:  # noqa: BLE001 — resolver failure
            return False
        if not addr:
            return False
        _, val = self.state.validators.get_by_address(addr)
        if val is None:
            return False
        # reference (reactor.go:509) compares power >= total/3 with Go
        # integer floor division, so e.g. power=3 of total=10 counts as
        # blocking; match that boundary exactly (3*power >= total is
        # mathematically stricter and diverges at non-multiples of 3)
        total = self.state.validators.total_voting_power()
        return val.voting_power >= total // 3

    def _maybe_switch_to_consensus(self) -> bool:
        """(reactor.go poolRoutine switch check)"""
        if self._local_node_blocks_the_chain():
            self.logger.info(
                "own voting power blocks the chain: switching to consensus"
            )
            self._switch_now()
            return True
        if not self.pool.is_caught_up():
            self._caught_up_since = None
            return False
        if self._caught_up_since is None:
            self._caught_up_since = time.monotonic()
            return False
        if time.monotonic() - self._caught_up_since < 0.5:
            return False
        self.logger.info(
            "caught up — switching to consensus",
            height=self.pool.height,
            blocks_synced=self.pool.blocks_synced,
        )
        self._switch_now()
        return True

    def _switch_now(self) -> None:
        self.block_sync.clear()
        self.metrics.syncing.set(0)
        self._backfilling = False
        FLIGHT.record(
            "blocksync_done", height=self.pool.height,
            blocks_synced=self.pool.blocks_synced,
        )
        if self.consensus_reactor is not None:
            self.consensus_reactor.switch_to_consensus(self.state)


__all__ = [
    "BlocksyncReactor",
    "BLOCKSYNC_CHANNEL",
    "decode_bs_message",
    "encode_status_response",
]
