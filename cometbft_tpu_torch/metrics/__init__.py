"""The metrics structs the port writes: consensus's
(``ConsensusMetrics``) and the mempool's (``MempoolMetrics``), the
event bus's, state execution's, blocksync's, statesync's, the ABCI
proxy's, the WAL's (``WALMetrics``), the block store's
(``StoreMetrics``), the evidence pool's (``EvidenceMetrics``), and the
crypto plane's ``CryptoMetrics`` and ``HealthMetrics``, and the wire
plane's ``P2PMetrics``, with their process-wide sinks (a copy of
cometbft_tpu/metrics/__init__.py: 40-298, 352-535, 537-925 and
1051-1060).

Each struct takes a ``utils.metrics.Registry``, or None for no-op
metrics (the reference's NopMetrics).  The sinks are no-ops until a
caller installs a real struct (``install_crypto_metrics``,
``install_health_metrics``, ``install_p2p_metrics``); the last one
installed wins.  Names and labels are the reference's, so a dashboard
reads both packages alike.
"""

from __future__ import annotations

from cometbft_tpu_torch.utils.metrics import DEFAULT_TIME_BUCKETS, Registry


class _Nop:
    def inc(self, amount: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass

    def labels(self, **kv):
        return self

    def child(self, *values):
        return self

    def remove(self, **kv) -> None:
        pass

    def __bool__(self) -> bool:
        # falsy so hot paths can skip work that only feeds gauges
        # (e.g. EventBus queue-depth mirroring) when metrics are off
        return False


_NOP = _Nop()


class ConsensusMetrics:
    """(internal/consensus/metrics.go:23 Metrics)"""

    def __init__(self, reg: Registry | None = None):
        if reg is None:
            self.height = self.rounds = self.validators = _NOP
            self.validators_power = self.byzantine_validators = _NOP
            self.num_txs = self.total_txs = self.block_size_bytes = _NOP
            self.block_interval_seconds = self.committed_height = _NOP
            self.block_parts = self.quorum_prevote_delay = _NOP
            self.step_duration_seconds = _NOP
            self.replay_divergence_total = _NOP
            self.trust_guard_trips_total = _NOP
            return
        s = "consensus"
        self.height = reg.gauge(s, "height", "Height of the chain.")
        self.rounds = reg.gauge(
            s, "rounds", "Number of rounds at the latest height."
        )
        self.validators = reg.gauge(
            s, "validators", "Number of validators."
        )
        self.validators_power = reg.gauge(
            s, "validators_power", "Total voting power of validators."
        )
        self.byzantine_validators = reg.gauge(
            s, "byzantine_validators",
            "Number of validators who tried to double sign.",
        )
        self.num_txs = reg.gauge(
            s, "num_txs", "Number of transactions in the latest block."
        )
        self.total_txs = reg.counter(
            s, "total_txs", "Total number of transactions committed."
        )
        self.block_size_bytes = reg.gauge(
            s, "block_size_bytes", "Size of the latest block in bytes."
        )
        self.block_interval_seconds = reg.histogram(
            s, "block_interval_seconds",
            "Time between this and the last block.",
            buckets=(0.5, 1, 2, 3, 5, 10, 30, 60),
        )
        self.committed_height = reg.gauge(
            s, "latest_block_height", "Latest committed block height."
        )
        self.block_parts = reg.counter(
            s, "block_parts",
            "Block parts transmitted per peer.",
            labels=("peer_id",),
        )
        self.quorum_prevote_delay = reg.gauge(
            s, "quorum_prevote_delay",
            "Seconds from proposal timestamp to +2/3 prevote quorum.",
            labels=("proposer_address",),
        )
        self.step_duration_seconds = reg.histogram(
            s, "step_duration_seconds",
            "Seconds spent in each consensus step "
            "(metrics.go StepDurationSeconds).",
            buckets=DEFAULT_TIME_BUCKETS,
            labels=("step",),
        )
        self.replay_divergence_total = reg.counter(
            s, "replay_divergence_total",
            "Transition-digest mismatches caught by the "
            "CMT_TPU_DETERMINISM replay guard, by surface "
            "(wal_replay|handshake|startup).",
            labels=("surface",),
        )
        self.trust_guard_trips_total = reg.counter(
            s, "trust_guard_trips_total",
            "Wire-derived values that reached a registered consensus "
            "sink with no validator run in the active wire context, "
            "caught by the CMT_TPU_TRUSTGUARD runtime guard, by sink "
            "(utils/trustguard.py; static half tools/trustcheck.py).",
            labels=("sink",),
        )


class MempoolMetrics:
    """(mempool/metrics.go Metrics)"""

    def __init__(self, reg: Registry | None = None):
        if reg is None:
            self.size = self.size_bytes = self.tx_size_bytes = _NOP
            self.failed_txs = self.evicted_txs = self.recheck_times = _NOP
            self.checktx_total = self.checktx_sig_seconds = _NOP
            self.checktx_batched = self.checktx_inline = _NOP
            return
        s = "mempool"
        self.size = reg.gauge(s, "size", "Number of uncommitted txs.")
        self.size_bytes = reg.gauge(
            s, "size_bytes", "Total size of the mempool in bytes."
        )
        self.tx_size_bytes = reg.histogram(
            s, "tx_size_bytes", "Tx sizes in bytes.",
            buckets=(16, 64, 256, 1024, 4096, 16384, 65536, 262144),
        )
        self.failed_txs = reg.counter(
            s, "failed_txs", "Number of failed CheckTx."
        )
        self.evicted_txs = reg.counter(
            s, "evicted_txs", "Number of evicted txs."
        )
        self.recheck_times = reg.counter(
            s, "recheck_times", "Number of recheck passes."
        )
        # -- ingest plane: every admission outcome lands in
        # exactly one checktx_total bucket, so rate(accepted) vs
        # rate(full+duplicate) IS the shed-not-stall liveness signal
        # the sustained-load harness asserts
        self.checktx_total = reg.counter(
            s, "checktx_total",
            "CheckTx admissions by outcome (accepted | duplicate | "
            "full | sig | app | precheck | too_large).",
            labels=("result",),
        )
        self.checktx_sig_seconds = reg.histogram(
            s, "checktx_sig_seconds",
            "Admission signature-verification wall per tx, queue wait "
            "included (signed-envelope txs only).",
            buckets=(.0005, .001, .0025, .005, .01, .025, .05, .1, .5),
        )
        self.checktx_batched = reg.counter(
            s, "checktx_batched",
            "Signed-tx admissions verified through the VerifyQueue "
            "ingest lane (device-batched).",
        )
        self.checktx_inline = reg.counter(
            s, "checktx_inline",
            "Signed-tx admissions verified inline on the host (queue "
            "off/draining — the strict sync fallback).",
        )


class EventBusMetrics:
    """Event-bus publish latency and subscriber backpressure (no
    reference analog; event_bus.go publishes unmeasured)."""

    def __init__(self, reg: Registry | None = None):
        if reg is None:
            self.publish_duration_seconds = _NOP
            self.subscriber_queue_depth = _NOP
            self.subscriber_dropped_total = _NOP
            return
        s = "event_bus"
        self.publish_duration_seconds = reg.histogram(
            s, "publish_duration_seconds",
            "Wall seconds per event publish (query matching + "
            "delivery to every subscriber queue).",
            buckets=DEFAULT_TIME_BUCKETS,
        )
        self.subscriber_queue_depth = reg.gauge(
            s, "subscriber_queue_depth",
            "Deepest undelivered-message queue per subscriber client.",
            labels=("client_id",),
        )
        self.subscriber_dropped_total = reg.counter(
            s, "subscriber_dropped_total",
            "Subscriptions canceled out-of-capacity (slow consumer). "
            "Label-less on purpose: client ids are per-connection, so "
            "labeling would leak counter children under WS churn — "
            "the canceled client is named in the event-bus log line.",
        )


class StateMetrics:
    """(state/metrics.go Metrics)"""

    def __init__(self, reg: Registry | None = None):
        if reg is None:
            self.block_processing_time = _NOP
            self.consensus_param_updates = _NOP
            self.validator_set_updates = _NOP
            self.pruned_blocks = _NOP
            self.process_proposal_total = _NOP
            return
        s = "state"
        self.block_processing_time = reg.histogram(
            s, "block_processing_time",
            "Seconds spent processing a block (FinalizeBlock).",
            buckets=DEFAULT_TIME_BUCKETS,
        )
        self.pruned_blocks = reg.counter(
            s, "pruned_blocks", "Blocks removed by the background pruner."
        )
        self.consensus_param_updates = reg.counter(
            s, "consensus_param_updates",
            "Number of consensus parameter updates by the app.",
        )
        self.validator_set_updates = reg.counter(
            s, "validator_set_updates",
            "Number of validator set updates by the app.",
        )
        self.process_proposal_total = reg.counter(
            s, "process_proposal_total",
            "ProcessProposal verdicts by result (accept, reject) — a "
            "nonzero reject count on an honest node is the observable "
            "proof that a forged proposal was refused before any "
            "prevote endorsed it.",
            labels=("result",),
        )


class BlockSyncMetrics:
    """(internal/blocksync/metrics.go Metrics) — the fast-sync plane.

    Reference parity (syncing, num_txs, total_txs, block_size_bytes,
    latest_block_height) plus the request-pipeline depth and peer
    timeout/evict counters the reference keeps internal to BlockPool.
    """

    def __init__(self, reg: Registry | None = None):
        if reg is None:
            self.syncing = self.latest_block_height = _NOP
            self.num_txs = self.total_txs = self.block_size_bytes = _NOP
            self.request_pipeline_depth = _NOP
            self.peer_timeouts = self.peer_evictions = _NOP
            return
        s = "blocksync"
        self.syncing = reg.gauge(
            s, "syncing",
            "1 while the node is fast-syncing blocks, 0 otherwise.",
        )
        self.latest_block_height = reg.gauge(
            s, "latest_block_height",
            "Latest height applied by the block syncer.",
        )
        self.num_txs = reg.gauge(
            s, "num_txs",
            "Transactions in the latest synced block.",
        )
        self.total_txs = reg.counter(
            s, "total_txs",
            "Total transactions applied by the block syncer.",
        )
        self.block_size_bytes = reg.gauge(
            s, "block_size_bytes",
            "Size of the latest synced block in bytes.",
        )
        self.request_pipeline_depth = reg.gauge(
            s, "request_pipeline_depth",
            "Block requests currently in flight across peers "
            "(pool.go maxPendingRequests window occupancy).",
        )
        self.peer_timeouts = reg.counter(
            s, "peer_timeouts",
            "Peers dropped for letting a block request exceed the "
            "request timeout.",
        )
        self.peer_evictions = reg.counter(
            s, "peer_evictions",
            "Peers evicted from the pool for serving an invalid "
            "block (RedoRequest path).",
        )


class StateSyncMetrics:
    """(statesync/metrics.go Metrics) — the snapshot-restore plane."""

    def __init__(self, reg: Registry | None = None):
        if reg is None:
            self.syncing = self.total_snapshots = _NOP
            self.chunk_process_time = _NOP
            self.snapshot_height = self.snapshot_chunk = _NOP
            self.snapshot_chunk_total = self.backfilled_blocks = _NOP
            return
        s = "statesync"
        self.syncing = reg.gauge(
            s, "syncing",
            "1 while the node is restoring a state snapshot, 0 "
            "otherwise.",
        )
        self.total_snapshots = reg.counter(
            s, "total_snapshots",
            "Distinct snapshots discovered from peers.",
        )
        self.chunk_process_time = reg.histogram(
            s, "chunk_process_time",
            "Seconds per ApplySnapshotChunk round-trip to the app.",
            buckets=DEFAULT_TIME_BUCKETS,
        )
        self.snapshot_height = reg.gauge(
            s, "snapshot_height", "Height of the snapshot being restored."
        )
        self.snapshot_chunk = reg.gauge(
            s, "snapshot_chunk", "Chunks applied so far."
        )
        self.snapshot_chunk_total = reg.gauge(
            s, "snapshot_chunk_total",
            "Total chunks in the snapshot being restored "
            "(metrics.go SnapshotChunkTotal).",
        )
        self.backfilled_blocks = reg.counter(
            s, "backfilled_blocks",
            "Blocks fetched to close the snapshot-to-head gap after a "
            "snapshot restore (blocksync running in the post-statesync "
            "handoff).",
        )


class ProxyMetrics:
    """(proxy/metrics.go Metrics) — every ABCI call on all four
    logical connections, timed at the proxy seam."""

    def __init__(self, reg: Registry | None = None):
        if reg is None:
            self.method_timing_seconds = _NOP
            return
        self.method_timing_seconds = reg.histogram(
            "abci", "method_timing_seconds",
            "Wall seconds per ABCI call, by method and logical "
            "connection (consensus | mempool | query | snapshot) — "
            "proxy/metrics.go MethodTiming.",
            buckets=(0.0001, 0.0004, 0.002, 0.009, 0.02, 0.1, 0.65, 2,
                     6, 25),
            labels=("method", "connection"),
        )


class WALMetrics:
    """Consensus WAL accounting (no metricsgen analog: wal.go logs
    unmeasured) — write volume, fsync latency, and group rotations."""

    def __init__(self, reg: Registry | None = None):
        if reg is None:
            self.write_bytes = _NOP
            self.fsync_duration_seconds = _NOP
            self.rotations = _NOP
            return
        s = "wal"
        self.write_bytes = reg.counter(
            s, "write_bytes",
            "Framed record bytes appended to the consensus WAL.",
        )
        self.fsync_duration_seconds = reg.histogram(
            s, "fsync_duration_seconds",
            "Seconds per WAL fsync (our own votes/proposals and "
            "height boundaries sync; a slow disk shows up here "
            "before it shows up as commit latency).",
            buckets=DEFAULT_TIME_BUCKETS,
        )
        self.rotations = reg.counter(
            s, "rotations",
            "Autofile group head rotations (size-limit reached).",
        )


class StoreMetrics:
    """Block-store persistence timings (no metricsgen analog; the
    reference leaves store/store.go unmeasured)."""

    def __init__(self, reg: Registry | None = None):
        if reg is None:
            self.block_save_seconds = _NOP
            self.block_load_seconds = _NOP
            self.block_prune_seconds = _NOP
            return
        s = "store"
        self.block_save_seconds = reg.histogram(
            s, "block_save_seconds",
            "Seconds per SaveBlock batch (parts + meta + commits, "
            "one atomic write group).",
            buckets=DEFAULT_TIME_BUCKETS,
        )
        self.block_load_seconds = reg.histogram(
            s, "block_load_seconds",
            "Seconds per LoadBlock (meta + parts + decode).",
            buckets=DEFAULT_TIME_BUCKETS,
        )
        self.block_prune_seconds = reg.histogram(
            s, "block_prune_seconds",
            "Seconds per PruneBlocks batch.",
            buckets=DEFAULT_TIME_BUCKETS,
        )


class EvidenceMetrics:
    """Evidence pool occupancy (no metricsgen analog)."""

    def __init__(self, reg: Registry | None = None):
        if reg is None:
            self.pool_size = _NOP
            self.oldest_age_seconds = _NOP
            self.pool_detected_total = _NOP
            self.committed_total = _NOP
            return
        s = "evidence"
        self.pool_size = reg.gauge(
            s, "pool_size", "Pending (uncommitted) evidence items."
        )
        self.oldest_age_seconds = reg.gauge(
            s, "oldest_age_seconds",
            "Age of the oldest pending evidence (0 when the pool is "
            "empty) — evidence aging toward the expiry window without "
            "being committed means proposers are not reaping it.",
        )
        self.pool_detected_total = reg.counter(
            s, "pool_detected_total",
            "Evidence items admitted to the pending pool, by type "
            "(duplicate_vote, light_client_attack) — DETECTION; "
            "pool_size alone cannot distinguish detection from "
            "commitment.",
            labels=("type",),
        )
        self.committed_total = reg.counter(
            s, "committed_total",
            "Evidence items marked committed because a block carrying "
            "them was applied — the byzantine drive's proof that "
            "detected misbehavior actually landed on chain.",
        )


class CryptoMetrics:
    """What the verify path did: launches, routing decisions, the
    dispatch ladder's tiers and transitions, kernel and host-verify
    wall time, the bytes across the link, the key-table pool's
    occupancy and the verify queue's lanes."""

    def __init__(self, reg: Registry | None = None):
        if reg is None:
            self.verify_queue_depth = self.verify_queue_inflight = _NOP
            self.verify_queue_submitted = self.verify_queue_batch_size = _NOP
            self.verify_queue_spec_cache = self.verify_queue_prefetch_depth = _NOP
            self.bytes_transferred = _NOP
            self.jit_cache_misses = self.guard_trips = _NOP
            self.batch_verify_launches = _NOP
            self.batch_verify_batch_size = _NOP
            self.dispatch_decisions = _NOP
            self.dispatch_tier = _NOP
            self.dispatch_route = _NOP
            self.route_reorders_total = _NOP
            self.dispatch_demotions_total = _NOP
            self.dispatch_promotions_total = _NOP
            self.dispatch_current_tier = _NOP
            self.kernel_time_seconds = _NOP
            self.host_verify_time_seconds = _NOP
            self.key_pool_keys = self.key_pool_capacity = _NOP
            self.key_pool_builds = self.key_pool_evictions = _NOP
            return
        s = "crypto"
        self.batch_verify_launches = reg.counter(
            s, "batch_verify_launches",
            "Batch-verify launches by kernel (host_rlc: one native RLC check).",
            labels=("kernel",))
        self.batch_verify_batch_size = reg.histogram(
            s, "batch_verify_batch_size", "Signatures per batch-verify call.",
            buckets=(8, 16, 32, 64, 128, 256, 512, 1024, 4096, 16384))
        self.dispatch_decisions = reg.counter(
            s, "dispatch_decisions",
            "Device-vs-host routing decisions, by route and reason "
            "(calibration | batch_size | keyed_warm | msg_too_large | ladder_demoted).",
            labels=("route", "reason"))
        self.dispatch_tier = reg.counter(
            s, "dispatch_tier",
            "Dispatch-ladder tier that answered each batch (keyed | generic | host | "
            "python), recorded at the ladder's one per-batch accounting point.",
            labels=("tier",))
        self.dispatch_route = reg.counter(
            s, "dispatch_route",
            "The tier plan() placed first in the walk, per pow2 shape bucket, and "
            "where that placement came from (static | learned | resample).",
            labels=("tier", "bucket", "source"))
        self.route_reorders_total = reg.counter(
            s, "route_reorders_total",
            "Cost-model order adoptions per shape bucket.",
            labels=("bucket",))
        self.dispatch_demotions_total = reg.counter(
            s, "dispatch_demotions_total",
            "Dispatch-ladder demotions: `from` the demoted tier, `to` the next "
            "admissible rung, `reason` the failure class (watchdog | probe_failures | "
            "chaos:<kind> | launch:<ExcType> | table_lookup:<ExcType>).",
            labels=("from", "to", "reason"))
        self.dispatch_promotions_total = reg.counter(
            s, "dispatch_promotions_total",
            "Dispatch-ladder re-admissions of a demoted tier.",
            labels=("tier",))
        self.dispatch_current_tier = reg.gauge(
            s, "dispatch_current_tier",
            "One-hot gauge of the best currently admissible tier known to this process.",
            labels=("tier",))
        self.kernel_time_seconds = reg.histogram(
            s, "kernel_time_seconds",
            "Wall seconds per device batch verification (launch through the "
            "verdicts' copy to the host).",
            buckets=DEFAULT_TIME_BUCKETS)
        self.host_verify_time_seconds = reg.histogram(
            s, "host_verify_time_seconds", "Wall seconds per host batch verification.",
            buckets=DEFAULT_TIME_BUCKETS)
        self.key_pool_keys = reg.gauge(
            s, "key_pool_keys", "Validator keys resident in the device comb-table pool.",
            labels=("window_bits",))
        self.key_pool_capacity = reg.gauge(
            s, "key_pool_capacity", "Slot capacity of the device comb-table pool.",
            labels=("window_bits",))
        self.key_pool_builds = reg.counter(
            s, "key_pool_builds", "Per-key comb-table pages built on the device.")
        self.key_pool_evictions = reg.counter(
            s, "key_pool_evictions", "Key pages evicted from the device comb-table pool.")
        self.bytes_transferred = reg.counter(
            s, "bytes_transferred", "Bytes moved across the host-device link (h2d | d2h).",
            labels=("direction",))
        self.jit_cache_misses = reg.counter(
            s, "jit_cache_misses",
            "New launch signatures and library builds per seam (generic | chunked | keyed "
            "| table_build | sharded | keyed_mesh | build:<source>); steady state should "
            "add zero (ops/jitguard.py).",
            labels=("seam",))
        self.guard_trips = reg.counter(
            s, "guard_trips",
            "Device-plane guard trips: a new launch signature or build after seal(), or "
            "an implicit host-device sync in the launch window (kind: retrace | transfer).",
            labels=("kind",))
        self.verify_queue_depth = reg.gauge(
            s, "verify_queue_depth",
            "Requests waiting in the verify queue, by priority lane (consensus | prefetch "
            "| light_client | ingest); strict preemption in that order.",
            labels=("priority",))
        self.verify_queue_inflight = reg.gauge(
            s, "verify_queue_inflight",
            "Buffers in flight in the verify queue (prepared + launching); 2 means the "
            "double buffer is full: host prep of buffer N+1 overlaps buffer N's launch.")
        self.verify_queue_submitted = reg.counter(
            s, "verify_queue_submitted",
            "Verification requests submitted to the verify queue, by priority lane "
            "(consensus | prefetch | light_client | ingest).",
            labels=("priority",))
        self.verify_queue_batch_size = reg.histogram(
            s, "verify_queue_batch_size",
            "Signatures per coalesced verify-queue buffer (after speculative-cache dedupe).",
            buckets=(1, 2, 8, 32, 128, 512, 2048, 8192))
        self.verify_queue_spec_cache = reg.counter(
            s, "verify_queue_spec_cache",
            "Speculative-result cache consults (hit | miss): a hit is a signature that "
            "skipped its launch because the queue verified it earlier.",
            labels=("result",))
        self.verify_queue_prefetch_depth = reg.gauge(
            s, "verify_queue_prefetch_depth",
            "Configured blocksync verify-prefetch depth in blocks (0 = prefetch disabled).")


class HealthMetrics:
    """Whether the device is healthy enough to keep verifying: per-tier
    canary latency and health, launch watchdog overruns, busy and idle
    time between launches, the queue-wait half of the launch split and
    the host/device overlap the pipelined paths buy."""

    def __init__(self, reg: Registry | None = None):
        if reg is None:
            self.tier_probe_seconds = self.tier_healthy = _NOP
            self.tier_probe_failures_total = _NOP
            self.host_device_overlap_ratio = _NOP
            self.device_hangs_total = _NOP
            self.device_busy_seconds_total = _NOP
            self.device_idle_seconds_total = _NOP
            self.launch_queue_wait_seconds = _NOP
            return
        s = "crypto"
        self.tier_probe_seconds = reg.histogram(
            s, "tier_probe_seconds",
            "Wall seconds per canary probe of a dispatch tier (keyed | generic | host).",
            buckets=DEFAULT_TIME_BUCKETS, labels=("tier",))
        self.tier_healthy = reg.gauge(
            s, "tier_healthy",
            "1 while the tier's last canary probe verified correctly within its budget, 0 "
            "after a failed, hung or mis-verifying probe.",
            labels=("tier",))
        self.tier_probe_failures_total = reg.counter(
            s, "tier_probe_failures_total",
            "Canary probes that failed (exception, mis-verify or timeout), by tier.",
            labels=("tier",))
        self.device_hangs_total = reg.counter(
            s, "device_hangs_total",
            "Device launches that exceeded the launch watchdog's budget.")
        self.device_busy_seconds_total = reg.counter(
            s, "device_busy_seconds_total",
            "Wall seconds inside batch-verify launches (launch through the verdicts' "
            "copy to the host), per device.",
            labels=("device",))
        self.device_idle_seconds_total = reg.counter(
            s, "device_idle_seconds_total",
            "Wall seconds the device sat idle between batch-verify launches, per device.",
            labels=("device",))
        self.launch_queue_wait_seconds = reg.histogram(
            s, "launch_queue_wait_seconds",
            "Host seconds between a batch's plan and its device launch.",
            buckets=DEFAULT_TIME_BUCKETS)
        self.host_device_overlap_ratio = reg.gauge(
            s, "host_device_overlap_ratio",
            "Share of launch wall time the host spent not blocked in the result fetch "
            "(a verifier's launch) or spent preparing the next batch (the verify queue's "
            "cumulative ratio): ~0 lockstep, ->1 host work overlaps the device.")


class P2PMetrics:
    """(p2p/metrics.go Metrics) — wire-plane telemetry.

    Reference parity (peers, per-peer/per-type message bytes, pending
    send bytes, per-peer txs) plus the queue-depth/backpressure series
    the reference keeps internal to MConnection: per-channel send-queue
    gauges, send timeout/failure counters, ping RTT, flowrate
    throughput, and SecretConnection handshake/frame accounting.
    """

    def __init__(self, reg: Registry | None = None):
        if reg is None:
            self.peers = _NOP
            self.message_receive_bytes_total = _NOP
            self.message_send_bytes_total = _NOP
            self.peer_pending_send_bytes = _NOP
            self.num_txs = _NOP
            self.ping_rtt_seconds = _NOP
            self.gossip_hop_seconds = _NOP
            self.peer_clock_offset_seconds = _NOP
            self.send_queue_size = self.send_queue_bytes = _NOP
            self.send_timeouts = self.try_send_failures = _NOP
            self.send_rate_bytes = self.recv_rate_bytes = _NOP
            self.handshake_duration_seconds = _NOP
            self.secret_frames_total = _NOP
            return
        s = "p2p"
        self.peers = reg.gauge(s, "peers", "Number of connected peers.")
        self.message_receive_bytes_total = reg.counter(
            s, "message_receive_bytes_total",
            "Bytes received per message type (channel owner), channel "
            "and peer.",
            labels=("chID", "message_type", "peer_id"),
        )
        self.message_send_bytes_total = reg.counter(
            s, "message_send_bytes_total",
            "Bytes enqueued for send per message type (channel owner), "
            "channel and peer.",
            labels=("chID", "message_type", "peer_id"),
        )
        self.peer_pending_send_bytes = reg.gauge(
            s, "peer_pending_send_bytes",
            "Bytes queued (all channels + in-flight message remainder) "
            "awaiting the peer's send routine.",
            labels=("peer_id",),
        )
        self.num_txs = reg.gauge(
            s, "num_txs",
            "Transactions submitted by each peer.",
            labels=("peer_id",),
        )
        self.ping_rtt_seconds = reg.histogram(
            s, "ping_rtt_seconds",
            "Round-trip of the keepalive ping (sent in _ping_routine, "
            "observed on the matching pong).",
            buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                     1.0, 2.5),
            labels=("peer_id",),
        )
        self.gossip_hop_seconds = reg.histogram(
            s, "gossip_hop_seconds",
            "Per-hop gossip latency of trace-context-stamped consensus "
            "messages (origin send wall to local receive, peer "
            "clock-offset corrected, clamped at zero).",
            buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                     0.1, 0.25, 0.5, 1.0, 2.5),
            labels=("message_type",),
        )
        self.peer_clock_offset_seconds = reg.gauge(
            s, "peer_clock_offset_seconds",
            "Estimated remote-minus-local wall-clock offset per peer "
            "(pong piggyback, RTT halved; the correction applied to "
            "gossip hop latency).",
            labels=("peer_id",),
        )
        self.send_queue_size = reg.gauge(
            s, "send_queue_size",
            "Messages waiting in a channel's send queue.",
            labels=("peer_id", "chID"),
        )
        self.send_queue_bytes = reg.gauge(
            s, "send_queue_bytes",
            "Bytes waiting in a channel's send queue (incl. the "
            "unsent remainder of the in-flight message).",
            labels=("peer_id", "chID"),
        )
        self.send_timeouts = reg.counter(
            s, "send_timeouts",
            "Blocking sends that timed out on a full channel queue.",
            labels=("peer_id", "chID"),
        )
        self.try_send_failures = reg.counter(
            s, "try_send_failures",
            "Non-blocking sends dropped on a full channel queue "
            "(async-broadcast backpressure).",
            labels=("peer_id", "chID"),
        )
        self.send_rate_bytes = reg.gauge(
            s, "send_rate_bytes",
            "Flowrate EMA send throughput (Monitor.status rate_avg), "
            "sampled each ping interval.",
            labels=("peer_id",),
        )
        self.recv_rate_bytes = reg.gauge(
            s, "recv_rate_bytes",
            "Flowrate EMA receive throughput (Monitor.status "
            "rate_avg), sampled each ping interval.",
            labels=("peer_id",),
        )
        self.handshake_duration_seconds = reg.histogram(
            s, "handshake_duration_seconds",
            "SecretConnection handshake wall time (DH + HKDF + "
            "challenge signatures).",
            buckets=DEFAULT_TIME_BUCKETS,
        )
        self.secret_frames_total = reg.counter(
            s, "secret_frames_total",
            "AEAD frames sealed/opened by SecretConnection "
            "(direction: seal | open).",
            labels=("direction",),
        )


_CRYPTO = CryptoMetrics(None)
_HEALTH = HealthMetrics(None)


def crypto_metrics() -> CryptoMetrics:
    """The installed crypto-plane sink (never None)."""
    return _CRYPTO


def install_crypto_metrics(metrics: CryptoMetrics | None) -> None:
    """Install ``metrics`` as the process-wide crypto sink (None resets
    to the no-op)."""
    global _CRYPTO
    _CRYPTO = metrics if metrics is not None else CryptoMetrics(None)


def health_metrics() -> HealthMetrics:
    """The installed device-health sink (never None)."""
    return _HEALTH


def install_health_metrics(metrics: HealthMetrics | None) -> None:
    """Install ``metrics`` as the process-wide health sink (None resets
    to the no-op)."""
    global _HEALTH
    _HEALTH = metrics if metrics is not None else HealthMetrics(None)


#: Process-wide sink for wire-plane code with no node handle: the
#: secret connection seals and opens frames deep under the transport.
#: No-op by default; the last struct installed wins.
_P2P = P2PMetrics(None)


def p2p_metrics() -> P2PMetrics:
    """The currently installed wire-plane sink (never None)."""
    return _P2P


def install_p2p_metrics(metrics: P2PMetrics | None) -> None:
    """Install ``metrics`` as the process-wide p2p sink (None resets
    to the no-op)."""
    global _P2P
    _P2P = metrics if metrics is not None else P2PMetrics(None)
