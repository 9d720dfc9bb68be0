"""The consensus state machine — Tendermint BFT over one height/round
ladder (a copy of cometbft_tpu/consensus/state.py; reference:
internal/consensus/state.go:72).

Single-writer core (SURVEY.md §2.10): ALL state transitions happen in
one thread (``_receive_routine``), fed by a FIFO input queue carrying
peer messages, our own internal messages, and fired timeouts.  Every
input is WAL-logged before processing — fsynced for our own messages —
so a crash replays to exactly the same state (wal.go contract).

The hot path: every precommit entering ``try_add_vote`` is signature-
verified via VoteSet (ed25519 → the verify queue and the card's batch
plane), and every decided block re-verifies the previous commit inside
``BlockExecutor.apply_block``.

Where the port departs from its reference:
- ``ConsensusState`` takes a keyword ``device`` (``cuda`` unless the
  caller names another; without a card only ``device="cpu"`` runs); it
  must be the executor's, which validates every proposal and applies
  every block (and with it every ``verify_commit``) there;
- the WAL is the ``NopWAL`` unless a caller passes another (the file
  ``wal.WAL``); the determinism guard (``state/determinism.py``) is the
  executor's ``determinism``, where the reference reads
  ``CMT_TPU_DETERMINISM``: with it on, each committed height's digest
  follows its end-height record in the WAL, and replay checks each
  digest it reads against the stores;
- the adversary of ``consensus/byz.py`` is the executor's ``byz``,
  unarmed unless a caller arms it, where the reference reads
  ``CMT_TPU_BYZ`` into a process-wide one;
- a block part of another round that fails its proof check is dropped
  at debug level, as CometBFT's handleMsg drops it (the reference
  raises, and its receive routine logs the input as an error).

As in the reference, the round state's lock is ``utils/sync``'s
``RMutex()`` and the class is ``@guarded``; ``_handle_msg`` is the
``consensus_state`` trust-guard seam; and each committed height outside
replay is decomposed by ``utils/critpath.observe_height``.
"""

from __future__ import annotations

import queue
import threading
import time

from dataclasses import dataclass, replace

from cometbft_tpu_torch.config import ConsensusConfig
from cometbft_tpu_torch.consensus.height_vote_set import HeightVoteSet
from cometbft_tpu_torch.consensus.messages import (
    BlockPartMessage,
    ProposalMessage,
    VoteMessage,
    decode_message,
    encode_message,
)
from cometbft_tpu_torch.consensus.ticker import (
    STEP_COMMIT,
    STEP_NAMES,
    STEP_NEW_HEIGHT,
    STEP_NEW_ROUND,
    STEP_PRECOMMIT,
    STEP_PRECOMMIT_WAIT,
    STEP_PREVOTE,
    STEP_PREVOTE_WAIT,
    STEP_PROPOSE,
    TimeoutInfo,
    TimeoutTicker,
)
from cometbft_tpu_torch.abci.types import ExtendVoteRequest, VerifyVoteExtensionRequest
from cometbft_tpu_torch.state import State, determinism as _determinism
from cometbft_tpu_torch.state.execution import BlockExecutor
from cometbft_tpu_torch.types.block import Block, BlockID, Commit
from cometbft_tpu_torch.types.canonical import PRECOMMIT_TYPE, PREVOTE_TYPE
from cometbft_tpu_torch.types.event_bus import (
    EventBus,
    EventDataCompleteProposal,
    EventDataNewRound,
    EventDataRoundState,
    EventDataVote,
)
from cometbft_tpu_torch.types.part_set import BLOCK_PART_SIZE_BYTES, PartSet, PartSetError
from cometbft_tpu_torch.types.validator import ValidatorSet
from cometbft_tpu_torch.types.vote import Proposal, Vote
from cometbft_tpu_torch.types.vote_set import ConflictingVoteError, VoteSet
from cometbft_tpu_torch.utils.log import Logger, default_logger
from cometbft_tpu_torch.utils.service import BaseService
from cometbft_tpu_torch.utils.flight import FLIGHT
from cometbft_tpu_torch.utils.env import resolve_device
from cometbft_tpu_torch.utils.time import now_ns
from cometbft_tpu_torch.utils.trace import NOP_SPAN, TRACER as _tracer
from cometbft_tpu_torch.wal import (
    KIND_MSG_INFO,
    KIND_TIMEOUT,
    KIND_TRANSITION_DIGEST,
    NopWAL,
    WALRecord,
)
from cometbft_tpu_torch.utils.protoio import ProtoReader, ProtoWriter
from cometbft_tpu_torch.utils import sync as cmtsync
from cometbft_tpu_torch.utils import critpath, trustguard


class ConsensusError(Exception):
    pass


@dataclass(frozen=True)
class MsgInfo:
    """(state.go msgInfo)"""

    msg: object
    peer_id: str = ""  # "" = internal (our own proposal/parts/votes)
    #: fleet plane: the envelope's trace context (TraceContext | None).
    #: Deliberately NOT WAL-encoded — replay skips span recording
    #: anyway, so the stamp is live-path-only observability.
    ctx: object = None


def encode_msg_info(mi: MsgInfo) -> bytes:
    w = ProtoWriter()
    w.string(1, mi.peer_id)
    w.bytes_(2, encode_message(mi.msg))
    return w.finish()


def decode_msg_info(data: bytes) -> MsgInfo:
    f = ProtoReader(data).to_dict()
    return MsgInfo(
        msg=decode_message(bytes(f[2][0])),
        peer_id=bytes(f.get(1, [b""])[0]).decode(),
    )


def encode_timeout_info(ti: TimeoutInfo) -> bytes:
    w = ProtoWriter()
    w.varint(1, ti.duration_ns)
    w.varint(2, ti.height)
    w.svarint(3, ti.round)
    w.varint(4, ti.step)
    return w.finish()


def decode_timeout_info(data: bytes) -> TimeoutInfo:
    from cometbft_tpu_torch.utils.protoio import _unzigzag

    f = ProtoReader(data).to_dict()
    return TimeoutInfo(
        duration_ns=int(f.get(1, [0])[0]),
        height=int(f.get(2, [0])[0]),
        round=_unzigzag(int(f.get(3, [0])[0])),
        step=int(f.get(4, [0])[0]),
    )


@cmtsync.guarded
class ConsensusState(BaseService):
    """(internal/consensus/state.go:72 State)

    The round state (round_state.go RoundState) — ``height`` through
    ``state`` below, with ``_early_parts`` — is guarded by ``_rs_mtx``:
    written only by the receive routine (and the pre-start/handoff
    paths, which take the lock too), read by gossip/RPC through the
    locked ``round_state()`` snapshot.  The transition methods carry
    ``# holds _rs_mtx`` caller-holds markers."""

    _GUARDED_BY = {
        "height": "_rs_mtx",
        "round": "_rs_mtx",
        "step": "_rs_mtx",
        "_step_start": "_rs_mtx",
        "_step_hr": "_rs_mtx",
        "_height_t0": "_rs_mtx",
        "_quorum_prevote_round": "_rs_mtx",
        "start_time_ns": "_rs_mtx",
        "commit_time_ns": "_rs_mtx",
        "validators": "_rs_mtx",
        "proposal": "_rs_mtx",
        "proposal_block": "_rs_mtx",
        "proposal_block_parts": "_rs_mtx",
        "_proposal_recv_time_ns": "_rs_mtx",
        "locked_round": "_rs_mtx",
        "locked_block": "_rs_mtx",
        "locked_block_parts": "_rs_mtx",
        "valid_round": "_rs_mtx",
        "valid_block": "_rs_mtx",
        "valid_block_parts": "_rs_mtx",
        "votes": "_rs_mtx",
        "commit_round": "_rs_mtx",
        "last_commit": "_rs_mtx",
        "last_validators": "_rs_mtx",
        "triggered_timeout_precommit": "_rs_mtx",
        "_early_parts": "_rs_mtx",
        "state": "_rs_mtx",
    }

    def __init__(
        self,
        config: ConsensusConfig,
        state: State,
        block_exec: BlockExecutor,
        block_store,
        priv_validator=None,
        event_bus: EventBus | None = None,
        wal=None,
        metrics=None,
        logger: Logger | None = None,
        *,
        device=None,
    ):
        self.device = resolve_device(device)
        if getattr(block_exec, "device", self.device) != self.device:
            raise ValueError(
                f"consensus on {self.device} with an executor on "
                f"{block_exec.device}"
            )
        super().__init__(
            name="consensus",
            logger=logger or default_logger().with_fields(module="consensus"),
        )
        self.config = config
        self.block_exec = block_exec
        self.block_store = block_store
        self.priv_validator = priv_validator
        self.event_bus = event_bus
        self.wal = wal if wal is not None else NopWAL()
        # one place for each policy: the executor's
        self.byz = block_exec.byz
        self.determinism = block_exec.determinism
        from cometbft_tpu_torch.metrics import ConsensusMetrics

        self.metrics = metrics if metrics is not None else ConsensusMetrics()

        # round state (round_state.go RoundState) — guarded by _rs_mtx for
        # readers (gossip, RPC); written only by the receive routine.
        self._rs_mtx = cmtsync.RMutex()
        self.height = 0
        self.round = 0
        self.step = STEP_NEW_HEIGHT
        self._step_start = time.perf_counter()
        self._step_hr = (0, 0)  # (height, round) at step entry
        self._height_t0 = time.perf_counter()  # height-pipeline span root
        self._quorum_prevote_round = -1
        self.start_time_ns = 0
        self.commit_time_ns = 0
        self.validators: ValidatorSet | None = None
        self.proposal: Proposal | None = None
        self.proposal_block: Block | None = None
        self.proposal_block_parts: PartSet | None = None
        self.locked_round = -1
        self.locked_block: Block | None = None
        self.locked_block_parts: PartSet | None = None
        self.valid_round = -1
        self.valid_block: Block | None = None
        self.valid_block_parts: PartSet | None = None
        self.votes: HeightVoteSet | None = None
        self.commit_round = -1
        self.last_commit: VoteSet | None = None
        self.last_validators: ValidatorSet | None = None
        self.triggered_timeout_precommit = False

        self.state = state  # committed chain state

        self._early_parts: list = []  # catch-up parts pre-commit-header
        self._queue: queue.Queue = queue.Queue(maxsize=1000)
        self._ticker = TimeoutTicker(self._tock)
        self._thread: threading.Thread | None = None
        self._replay_mode = False
        self._replay_msg_time_ns = 0
        # WAL catch-up counts (the port's; the reference only logs them):
        # records replayed, and transition digests checked on the way
        self.replayed_records = 0
        self.replayed_digests = 0
        self._proposal_recv_time_ns = 0

        # listeners for new-step notification (reactor broadcast hook)
        self.on_new_step = None

        self._update_to_state(state)

    # -- public input API (reactor entry points) -------------------------

    def send_peer_msg(self, msg, peer_id: str, ctx=None) -> None:
        """Queue a peer message (reactor.go Receive → peerMsgQueue).
        ``ctx`` carries the envelope's trace context when present."""
        self._queue.put(("msg", MsgInfo(msg, peer_id, ctx)))

    def _send_internal(self, msg) -> None:
        """(state.go sendInternalMessage) — must never block the receive
        routine NOR drop our own messages.  A full queue (e.g. a
        max-size proposal split into >1000 parts) falls back to a
        blocking put from a helper thread, mirroring the reference's
        go-routine fallback."""
        item = ("msg", MsgInfo(msg, ""))
        try:
            self._queue.put_nowait(item)
        except queue.Full:
            threading.Thread(
                target=self._queue.put, args=(item,), daemon=True
            ).start()

    def _tock(self, ti: TimeoutInfo) -> None:
        self._queue.put(("timeout", ti))

    def set_proposal_and_block(
        self, proposal: Proposal, parts: PartSet
    ) -> None:
        """Inject a full proposal (privileged/test path, state.go
        SetProposalAndBlock)."""
        self._send_internal(ProposalMessage(proposal))
        for i in range(parts.header.total):
            self._send_internal(
                BlockPartMessage(proposal.height, proposal.round, parts.get_part(i))
            )

    # -- round state snapshot --------------------------------------------

    def round_state(self) -> dict:
        """Snapshot for gossip/RPC (round_state.go RoundState)."""
        with self._rs_mtx:
            return {
                "height": self.height,
                "round": self.round,
                "step": self.step,
                "step_name": STEP_NAMES[self.step],
                "start_time_ns": self.start_time_ns,
                "proposal": self.proposal,
                "proposal_block": self.proposal_block,
                "proposal_block_parts": self.proposal_block_parts,
                "locked_round": self.locked_round,
                "locked_block": self.locked_block,
                "valid_round": self.valid_round,
                "valid_block": self.valid_block,
                "votes": self.votes,
                "commit_round": self.commit_round,
                "last_commit": self.last_commit,
                "validators": self.validators,
                "last_validators": self.last_validators,
            }

    # -- lifecycle -------------------------------------------------------

    def on_start(self) -> None:
        self._check_double_signing_risk()
        self._ticker.start()
        # the ticker (and, below, the receive routine) is live from
        # here on: replay and round-0 scheduling touch round state, so
        # they need the lock like any other writer (lockcheck)
        with self._rs_mtx:
            self._catchup_replay()
        self._thread = threading.Thread(
            target=self._receive_routine, name="cs-receive", daemon=True
        )
        self._thread.start()
        with self._rs_mtx:
            self._schedule_round_0()

    def _check_double_signing_risk(self) -> None:
        """(state.go:2643 checkDoubleSigningRisk) — with
        double_sign_check_height set, REFUSE to join consensus if our
        own signature appears in any of the last N seen commits: a
        validator whose sign-state was reset (unsafe-reset-all, restored
        backup) would otherwise re-sign heights it already signed."""
        n = getattr(self.config, "double_sign_check_height", 0)
        if (
            n <= 0
            or self.priv_validator is None
            or self.block_store is None
        ):
            return
        height = self.block_store.height()
        addr = self.priv_validator.address
        for i in range(1, min(n, height) + 1):
            commit = self.block_store.load_seen_commit(height - i + 1)
            if commit is None:
                continue
            for sig in commit.signatures:
                if sig.is_commit() and sig.validator_address == addr:
                    raise ConsensusError(
                        f"own signature found in seen commit at height "
                        f"{height - i + 1}; refusing to join consensus "
                        "(double-signing risk — wait "
                        f"{n} blocks or restore priv_validator_state)"
                    )

    def on_stop(self) -> None:
        self._queue.put(("quit", None))
        if self._thread is not None:
            self._thread.join(timeout=10)
        self._ticker.stop()
        if hasattr(self.wal, "stop") and getattr(
            self.wal, "is_running", lambda: False
        )():
            self.wal.stop()

    def update_state_and_start(self, state: State) -> None:
        """Adopt a post-sync state and begin consensus — the blocksync →
        consensus handoff (reactor.go SwitchToConsensus)."""
        with self._rs_mtx:
            self.state = state
            self._update_to_state(state)
        if not self.is_running():
            self.start()

    # -- WAL replay (replay.go:95 catchupReplay) -------------------------

    def _catchup_replay(self) -> None:  # holds _rs_mtx
        records = self.wal.search_for_end_height(self.height - 1)
        if records is None:
            # No anchor for the in-flight height (fresh WAL, or the node
            # jumped heights via handshake/statesync): write it now so a
            # crash mid-height can replay (wal.go OnStart writes
            # EndHeightMessage{0} to an empty WAL for the same reason).
            self.wal.write_end_height(self.height - 1)
            return
        self._replay_mode = True
        try:
            for rec in records:
                self._apply_wal_record(rec)
                self.replayed_records += 1
        finally:
            self._replay_mode = False
        self.logger.info("replayed wal", height=self.height, n=len(records))

    def _apply_wal_record(self, rec: WALRecord) -> None:
        self._replay_msg_time_ns = rec.time_ns
        if rec.kind == KIND_MSG_INFO:
            mi = decode_msg_info(rec.data)
            self._handle_msg(mi)
        elif rec.kind == KIND_TIMEOUT:
            ti = decode_timeout_info(rec.data)
            self._handle_timeout(ti)
        elif rec.kind == KIND_TRANSITION_DIGEST:
            # the determinism guard: the digest committed before the
            # crash must still be derivable from the stores we are
            # replaying on top of — a mismatch means replay would
            # rebuild a DIFFERENT state than the one that ran
            if self.determinism:
                recorded = _determinism.TransitionDigest.decode(rec.data)
                recomputed = _determinism.recompute_from_stores(
                    recorded.height,
                    self.block_store,
                    self.block_exec.state_store,
                )
                if recomputed is not None:
                    _determinism.compare(
                        recorded, recomputed,
                        surface="wal_replay", metrics=self.metrics,
                    )
                    self.replayed_digests += 1

    # -- the single-writer core (state.go:795 receiveRoutine) ------------

    def _receive_routine(self) -> None:
        while True:
            try:
                kind, payload = self._queue.get(timeout=0.5)
            except queue.Empty:
                if self.quit_event().is_set():
                    return
                continue
            if kind == "quit":
                return
            try:
                if kind == "msg":
                    # WAL BEFORE processing; fsync for our own messages
                    data = encode_msg_info(payload)
                    if payload.peer_id == "":
                        self.wal.write_sync(KIND_MSG_INFO, data)
                    else:
                        self.wal.write(KIND_MSG_INFO, data)
                    self._handle_msg(payload)
                elif kind == "timeout":
                    self.wal.write(KIND_TIMEOUT, encode_timeout_info(payload))
                    self._handle_timeout(payload)
            except Exception as exc:  # noqa: BLE001 — the loop must survive
                # consensus panic path: the flight recorder tail IS the
                # post-mortem — the last ~2k replication events before
                # this input wedged the state machine survive in the
                # ring (scrape /debug/flight) and the immediate tail
                # lands in the log next to the error
                FLIGHT.record(
                    "consensus_panic", err=repr(exc), input_kind=kind
                )
                self.logger.error(
                    "error processing consensus input",
                    err=repr(exc),
                    kind=kind,
                )
                self.logger.error(FLIGHT.format_tail(20))

    @trustguard.guarded_seam("consensus_state")
    def _handle_msg(self, mi: MsgInfo) -> None:
        msg, peer_id = mi.msg, mi.peer_id
        with self._rs_mtx:
            if isinstance(msg, ProposalMessage):
                self._set_proposal(msg.proposal, ctx=mi.ctx)
                # stashed early parts may have completed the proposal
                if (
                    self.proposal_block_parts is not None
                    and self.proposal_block_parts.is_complete()
                    and self.proposal_block is not None
                ):
                    self._handle_complete_proposal(msg.proposal.height)
            elif isinstance(msg, BlockPartMessage):
                try:
                    added = self._add_proposal_block_part(msg, peer_id)
                except PartSetError as exc:
                    if msg.round == self.round:
                        raise
                    # a part of another round's proposal (state.go
                    # handleMsg: "received block part from wrong round")
                    self.logger.debug(
                        "block part from another round", round=msg.round,
                        err=repr(exc),
                    )
                    return
                if added and self.proposal_block_parts.is_complete():
                    self._handle_complete_proposal(msg.height)
            elif isinstance(msg, VoteMessage):
                self._try_add_vote(msg.vote, peer_id)
            else:
                self.logger.debug(
                    "ignoring message", type=type(msg).__name__
                )

    def _handle_timeout(self, ti: TimeoutInfo) -> None:
        with self._rs_mtx:
            if ti.height != self.height or ti.round < self.round or (
                ti.round == self.round and ti.step < self.step
            ):
                return  # stale
            if ti.step == STEP_NEW_HEIGHT:
                self._enter_new_round(ti.height, 0)
            elif ti.step == STEP_NEW_ROUND:
                self._enter_propose(ti.height, 0)
            elif ti.step == STEP_PROPOSE:
                self.event_bus and self.event_bus.publish_timeout_propose(
                    self._rs_event()
                )
                self._enter_prevote(ti.height, ti.round)
            elif ti.step == STEP_PREVOTE_WAIT:
                self.event_bus and self.event_bus.publish_timeout_wait(
                    self._rs_event()
                )
                self._enter_precommit(ti.height, ti.round)
            elif ti.step == STEP_PRECOMMIT_WAIT:
                self.event_bus and self.event_bus.publish_timeout_wait(
                    self._rs_event()
                )
                self._enter_precommit(ti.height, ti.round)
                self._enter_new_round(ti.height, ti.round + 1)

    # -- state setup -----------------------------------------------------

    def _update_to_state(self, state: State) -> None:  # holds _rs_mtx
        """(state.go:652 updateToState)"""
        if self.commit_round > -1 and 0 < self.height != state.last_block_height:
            raise ConsensusError(
                f"updateToState at height {self.height} != "
                f"committed {state.last_block_height}"
            )
        self._early_parts.clear()  # stashed parts are per-height
        height = (
            state.initial_height
            if state.last_block_height == 0
            else state.last_block_height + 1
        )
        validators = state.validators

        if state.last_block_height > 0 and self.commit_round > -1 and self.votes:
            # promote this height's precommits to last_commit
            precommits = self.votes.precommits(self.commit_round)
            if precommits is None or not precommits.has_two_thirds_majority():
                raise ConsensusError("wanted +2/3 precommits for last commit")
            last_commit = precommits
        elif state.last_block_height == 0:
            last_commit = None
        else:
            last_commit = self.last_commit if self.height == height else None

        self.height = height
        self.round = 0
        self._set_step(STEP_NEW_HEIGHT)
        self.metrics.height.set(height)
        self.metrics.validators.set(len(validators))
        self.metrics.validators_power.set(validators.total_voting_power())
        if self.commit_time_ns == 0:
            self.start_time_ns = now_ns() + self.config.timeout_commit_ns  # deterministic: round scheduling, not state — decides WHEN, never WHAT
        else:
            self.start_time_ns = (
                self.commit_time_ns + self.config.timeout_commit_ns
            )
        self.validators = validators
        self.proposal = None
        self.proposal_block = None
        self.proposal_block_parts = None
        self._proposal_recv_time_ns = 0
        self.locked_round = -1
        self.locked_block = None
        self.locked_block_parts = None
        self.valid_round = -1
        self.valid_block = None
        self.valid_block_parts = None
        self.votes = HeightVoteSet(
            state.chain_id,
            height,
            validators,
            extensions_enabled=state.consensus_params.vote_extensions_enabled(
                height
            ),
        )
        self.commit_round = -1
        self._quorum_prevote_round = -1
        self.last_commit = last_commit
        self.last_validators = state.last_validators
        self.triggered_timeout_precommit = False
        self.state = state
        # the new height's pipeline root starts here (proposal receipt,
        # quorum marks, and the commit pipeline all parent to the
        # "height/pipeline" span recorded at finalize)
        self._height_t0 = time.perf_counter()

    def _schedule_round_0(self) -> None:  # holds _rs_mtx
        sleep = max(self.start_time_ns - now_ns(), 0)  # deterministic: round scheduling, not state — decides WHEN, never WHAT
        self._ticker.schedule(
            TimeoutInfo(sleep, self.height, 0, STEP_NEW_HEIGHT)
        )

    def _set_step(self, step: int) -> None:  # holds _rs_mtx
        """Advance ``self.step``, closing out the previous step's
        observability: its duration lands in the
        ``consensus_step_duration_seconds`` histogram and as a
        ``consensus/<Step>`` trace span (recorded at transition time,
        so the span's interval brackets everything — vote handling,
        VerifyCommit, device launches — that ran during the step).
        Callers mutate ``self.height``/``self.round`` before advancing
        the step, so the closing span is labeled with the
        height/round snapshotted when the step was ENTERED — the
        block the step's work actually belonged to."""
        if step == self.step:
            return
        now = time.perf_counter()
        if not self._replay_mode:
            # WAL replay re-drives transitions in microseconds; like
            # the event-bus publishes (and the reference's
            # updateRoundStep replayMode guard), those don't observe —
            # they'd skew the histogram and flood the trace ring
            name = STEP_NAMES[self.step]
            self.metrics.step_duration_seconds.labels(step=name).observe(
                now - self._step_start
            )
            height, round_ = self._step_hr
            _tracer.add_complete(
                f"consensus/{name}",
                self._step_start,
                now - self._step_start,
                cat="consensus",
                args={
                    "height": height,
                    "round": round_,
                    "parent": "height/pipeline",
                },
            )
            FLIGHT.record(
                "step", height=self.height, round=self.round,
                step=STEP_NAMES[step],
            )
        self._step_start = now
        self._step_hr = (self.height, self.round)
        self.step = step

    def _new_step(self) -> None:  # holds _rs_mtx
        if self.event_bus is not None and not self._replay_mode:
            self.event_bus.publish_new_round_step(self._rs_event())
        if self.on_new_step is not None:
            self.on_new_step(self.round_state())

    def _rs_event(self) -> EventDataRoundState:  # holds _rs_mtx
        return EventDataRoundState(
            height=self.height, round=self.round, step=STEP_NAMES[self.step]
        )

    # -- transitions -----------------------------------------------------

    def _enter_new_round(self, height: int, round_: int) -> None:  # holds _rs_mtx
        """(state.go:1063)"""
        if self.height != height or round_ < self.round or (
            self.round == round_ and self.step != STEP_NEW_HEIGHT
        ):
            return
        self.logger.debug("enter new round", height=height, round=round_)
        if round_ > self.round:
            # proposer rotation advances with the round (state.go:1087)
            self.validators = self.validators.copy().increment_proposer_priority(
                round_ - self.round
            )
        self.round = round_
        self._set_step(STEP_NEW_ROUND)
        self.metrics.rounds.set(round_)
        if round_ != 0:
            # round 0 keeps the proposal received during NewHeight wait
            self.proposal = None
            self.proposal_block = None
            self.proposal_block_parts = None
            self._proposal_recv_time_ns = 0
        self.votes.set_round(round_)
        self.triggered_timeout_precommit = False
        if self.event_bus is not None and not self._replay_mode:
            self.event_bus.publish_new_round(
                EventDataNewRound(
                    height=height,
                    round=round_,
                    step=STEP_NAMES[self.step],
                    proposer_address=self.validators.get_proposer().address,
                )
            )
        self._enter_propose(height, round_)

    def _enter_propose(self, height: int, round_: int) -> None:  # holds _rs_mtx
        """(state.go:1152)"""
        if self.height != height or round_ < self.round or (
            self.round == round_ and self.step >= STEP_PROPOSE
        ):
            return
        self.round = round_
        self._set_step(STEP_PROPOSE)
        self._new_step()
        self._ticker.schedule(
            TimeoutInfo(
                self.config.propose_timeout_ns(round_),
                height,
                round_,
                STEP_PROPOSE,
            )
        )
        if self._is_proposer():
            self._decide_proposal(height, round_)
        # If the proposal is already complete (gossip beat us here):
        if self._is_proposal_complete():
            self._enter_prevote(height, round_)

    def _is_proposer(self) -> bool:  # holds _rs_mtx
        if self.priv_validator is None:
            return False
        return (
            self.validators.get_proposer().address
            == self.priv_validator.address
        )

    def _decide_proposal(self, height: int, round_: int) -> None:  # holds _rs_mtx
        """(state.go:1226 defaultDecideProposal)"""
        if self.valid_block is not None:
            block, parts = self.valid_block, self.valid_block_parts
        else:
            last_commit = None
            if height > self.state.initial_height:
                if self.last_commit is not None:
                    last_commit = self.last_commit.make_commit()
                else:
                    last_commit = self.block_store.load_seen_commit(height - 1)
                if last_commit is None:
                    self.logger.error(
                        "cannot propose without last commit", height=height
                    )
                    return
            extended_votes = None
            if (
                height > self.state.initial_height
                and self.state.consensus_params.vote_extensions_enabled(
                    height - 1
                )
            ):
                if self.last_commit is not None:
                    extended_votes = self.last_commit.votes()
                else:
                    extended_votes = (
                        self.block_store.load_seen_extended_votes(
                            height - 1
                        )
                    )
                if extended_votes is None:
                    # the reference PANICS here (execution.go: an
                    # extension-enabled height without a stored
                    # extended commit is a bug or a blocksync gap);
                    # refuse to propose rather than silently hand the
                    # app local_last_commit=None
                    self.logger.error(
                        "missing extended votes for enabled height; "
                        "refusing to propose",
                        height=height,
                    )
                    return
            block = self.block_exec.create_proposal_block(
                height,
                self.state,
                last_commit,
                self.priv_validator.address,
                extended_votes=extended_votes,
            )
            parts = block.make_part_set(BLOCK_PART_SIZE_BYTES)

        block_id = BlockID(hash=block.hash(), part_set_header=parts.header)
        proposal = Proposal(
            height=height,
            round=round_,
            pol_round=self.valid_round,
            block_id=block_id,
            timestamp_ns=block.header.time_ns
            if not self.state.consensus_params.pbts_enabled(height)
            else now_ns(),  # deterministic: proposer's signed PBTS stamp — every node re-validates it via _proposal_is_timely
        )
        try:
            proposal = self.priv_validator.sign_proposal(
                self.state.chain_id, proposal
            )
        except Exception as exc:  # double-sign protection may refuse
            self.logger.error("failed signing proposal", err=repr(exc))
            return
        self._send_internal(ProposalMessage(proposal))
        for i in range(parts.header.total):
            self._send_internal(
                BlockPartMessage(height, round_, parts.get_part(i))
            )
        self.logger.info(
            "signed proposal", height=height, round=round_,
            hash=block.hash().hex()[:12],
        )

    def _is_proposal_complete(self) -> bool:  # holds _rs_mtx
        """(state.go isProposalComplete)"""
        if self.proposal is None or self.proposal_block is None:
            return False
        if self.proposal.pol_round < 0:
            return True
        prevotes = self.votes.prevotes(self.proposal.pol_round)
        return prevotes is not None and prevotes.has_two_thirds_majority()

    # -- proposal handling ------------------------------------------------

    def _set_proposal(self, proposal: Proposal, ctx=None) -> None:  # holds _rs_mtx
        """(state.go:2048 defaultSetProposal); ``ctx`` is the gossip
        envelope's trace context when the sender stamped it."""
        if self.proposal is not None:
            return
        if proposal.height != self.height or proposal.round != self.round:
            return
        if proposal.pol_round < -1 or (
            proposal.pol_round >= 0 and proposal.pol_round >= proposal.round
        ):
            raise ConsensusError("invalid proposal POL round")
        proposer = self.validators.get_proposer()
        if not proposer.pub_key.verify_signature(
            proposal.sign_bytes(self.state.chain_id), proposal.signature
        ):
            raise ConsensusError("invalid proposal signature")
        self.proposal = proposal
        # PBTS timeliness is judged at RECEIVE time, not prevote time
        # (types/vote.go IsTimely contract); during WAL replay the
        # original receive timestamp comes from the record.
        self._proposal_recv_time_ns = (
            self._replay_msg_time_ns if self._replay_mode else now_ns()  # deterministic: live branch only — replay takes the recorded WAL receipt time
        )
        if self.proposal_block_parts is None:
            self.proposal_block_parts = PartSet(
                proposal.block_id.part_set_header
            )
            # parts that raced ahead of this proposal message
            early, self._early_parts = self._early_parts, []
            for part, from_peer in early:
                try:
                    self._add_proposal_block_part(
                        BlockPartMessage(
                            height=self.height, round=self.round, part=part
                        ),
                        from_peer,
                    )
                except Exception as exc:  # noqa: BLE001 — bad proofs skipped
                    # a swallowed error leaves a flight breadcrumb
                    # naming the type, never nothing
                    FLIGHT.record(
                        "early_part_rejected",
                        height=self.height,
                        err=type(exc).__name__,
                    )
                    continue
        if not self._replay_mode:
            # zero-duration mark: where in the height's timeline the
            # proposal landed (docs/observability.md height pipeline)
            recv_args = {
                "height": proposal.height,
                "round": proposal.round,
                "parent": "height/pipeline",
            }
            if ctx is not None:
                recv_args["origin"] = ctx.origin[:16]
                recv_args["origin_send_wall"] = ctx.send_wall
            _tracer.add_complete(
                "height/proposal_received", time.perf_counter(), 0.0,
                cat="height", args=recv_args,
            )
            if ctx is not None:
                # the remote proposer's SEND wall time: with this mark
                # in the tree, a stitched height shows true
                # network-inclusive latency — local _height_t0 only
                # sees the proposal ARRIVE (fleet plane satellite)
                _tracer.add_complete(
                    "height/proposal_origin_wall", time.perf_counter(),
                    0.0, cat="height",
                    args={
                        "height": proposal.height,
                        "round": proposal.round,
                        "origin": ctx.origin[:16],
                        "send_wall": ctx.send_wall,
                        "parent": "height/pipeline",
                    },
                )
            FLIGHT.record(
                "proposal", height=proposal.height, round=proposal.round,
                hash=proposal.block_id.hash.hex()[:12],
            )
        self.logger.info(
            "received proposal",
            height=proposal.height,
            round=proposal.round,
            hash=proposal.block_id.hash.hex()[:12],
        )

    def _add_proposal_block_part(
        self, msg: BlockPartMessage, peer_id: str
    ) -> bool:  # holds _rs_mtx
        """(state.go:2123 addProposalBlockPart)"""
        if msg.height != self.height:
            return False
        if self.proposal_block_parts is None:
            # No header to verify against yet.  During catch-up, parts
            # can outrun the precommits that establish the commit header
            # (enterCommit below); stash a bounded number so one gossip
            # pass suffices instead of waiting a full round reset.
            if len(self._early_parts) < 256:
                self._early_parts.append((msg.part, peer_id))
            return False
        added = self.proposal_block_parts.add_part(msg.part)
        if added:
            # per-peer part accounting (metrics.go BlockParts); ""
            # (internal) parts are our own proposal's
            self.metrics.block_parts.labels(peer_id=peer_id).inc()
        if added and self.proposal_block_parts.is_complete():
            from cometbft_tpu_torch.types import codec

            self.proposal_block = codec.decode_block(
                self.proposal_block_parts.assemble()
            )
            if (
                self.proposal is not None
                and self.proposal_block.hash() != self.proposal.block_id.hash
            ):
                self.proposal_block = None
                raise ConsensusError("proposal block hash mismatch")
            self._speculate_last_commit(self.proposal_block)
            if self.event_bus is not None and not self._replay_mode:
                self.event_bus.publish_complete_proposal(
                    EventDataCompleteProposal(
                        height=self.height,
                        round=self.round,
                        step=STEP_NAMES[self.step],
                        block_id=self.proposal.block_id
                        if self.proposal
                        else None,
                    )
                )
        return added

    def _speculate_last_commit(self, block) -> None:  # holds _rs_mtx
        """Prime the verify queue with the proposal's LastCommit
        signatures the moment the block completes: ``apply_block``'s
        ``verify_commit`` at finalize then hits the speculative-result
        cache instead of paying a synchronous batch launch on the
        commit critical path.  For a validator that voted at height-1
        the cache is already warm (add_vote speculated each vote);
        this covers catch-up and restarts, where the LastCommit
        arrives cold inside the proposal.  Fire-and-forget at prefetch
        priority — live vote verification always preempts it — and
        bounded waste (one commit) when the proposal dies."""
        from cometbft_tpu_torch.crypto import verify_queue as _vq

        if not _vq.speculation_active():
            return
        lc = block.last_commit
        lvals = self.state.last_validators
        if lc is None or lvals is None or lc.size() != len(lvals):
            return
        items = []
        for i, cs in enumerate(lc.signatures):
            if cs.is_absent():
                continue  # verify_commit checks non-absent votes
            if lc.is_aggregated(i):
                # covered by the commit-level BLS aggregate: nothing
                # per-signature to speculate (the aggregate verdict
                # itself is cached at first verification)
                continue
            val = lvals.get_by_index(i)
            if val is None or val.address != cs.validator_address:
                return  # malformed commit: let verify_commit raise
            items.append((
                val.pub_key,
                lc.vote_sign_bytes(self.state.chain_id, i),
                cs.signature,
            ))
        if items:
            _vq.submit_prefetch(items)

    def _handle_complete_proposal(self, height: int) -> None:  # holds _rs_mtx
        """(state.go handleCompleteProposal)"""
        prevotes = self.votes.prevotes(self.round)
        maj23 = prevotes.two_thirds_majority() if prevotes else None
        if (
            maj23 is not None
            and not maj23.is_nil()
            and self.valid_round < self.round
        ):
            if self.proposal_block.hash() == maj23.hash:
                self.valid_round = self.round
                self.valid_block = self.proposal_block
                self.valid_block_parts = self.proposal_block_parts
        if self.step <= STEP_PROPOSE and self._is_proposal_complete():
            self._enter_prevote(height, self.round)
            if maj23 is not None and not maj23.is_nil():
                self._enter_precommit(height, self.round)
        elif self.step == STEP_COMMIT:
            self._try_finalize_commit(height)

    # -- prevote ---------------------------------------------------------

    def _enter_prevote(self, height: int, round_: int) -> None:  # holds _rs_mtx
        """(state.go:1345)"""
        if self.height != height or round_ < self.round or (
            self.round == round_ and self.step >= STEP_PREVOTE
        ):
            return
        self.round = round_
        self._set_step(STEP_PREVOTE)
        self._new_step()
        self._do_prevote(height, round_)

    def _do_prevote(self, height: int, round_: int) -> None:  # holds _rs_mtx
        """(state.go:1387 defaultDoPrevote)"""
        if self.locked_block is not None:
            self._sign_add_vote(PREVOTE_TYPE, self.locked_block)
            return
        if self.proposal_block is None or self.proposal is None:
            self._sign_add_vote(PREVOTE_TYPE, None)
            return
        if self.state.consensus_params.pbts_enabled(height):
            if not self._proposal_is_timely():
                self.logger.info(
                    "prevote nil: proposal not timely", height=height
                )
                self._sign_add_vote(PREVOTE_TYPE, None)
                return
        try:
            self.block_exec.validate_block(self.state, self.proposal_block)
            accepted = self.block_exec.process_proposal(
                self.proposal_block, self.state
            )
        except Exception as exc:  # invalid block
            self.logger.info("prevote nil: invalid block", err=repr(exc))
            accepted = False
        self._sign_add_vote(
            PREVOTE_TYPE, self.proposal_block if accepted else None
        )

    def _proposal_is_timely(self) -> bool:  # holds _rs_mtx
        """PBTS timeliness (types/vote.go IsTimely), measured against the
        proposal's receive time so scheduling delay between receive and
        prevote cannot flip the verdict."""
        sp = self.state.consensus_params.synchrony
        t = self.proposal.timestamp_ns
        recv = self._proposal_recv_time_ns or now_ns()  # deterministic: PBTS is DEFINED on local receive time — precision/message_delay absorb the skew
        lhs = t - sp.precision_ns
        rhs = t + sp.precision_ns + sp.message_delay_ns
        return lhs <= recv <= rhs

    # -- precommit -------------------------------------------------------

    def _enter_prevote_wait(self, height: int, round_: int) -> None:  # holds _rs_mtx
        if self.height != height or round_ < self.round or (
            self.round == round_ and self.step >= STEP_PREVOTE_WAIT
        ):
            return
        self.round = round_
        self._set_step(STEP_PREVOTE_WAIT)
        self._new_step()
        self._ticker.schedule(
            TimeoutInfo(
                self.config.prevote_timeout_ns(round_),
                height,
                round_,
                STEP_PREVOTE_WAIT,
            )
        )

    def _enter_precommit(self, height: int, round_: int) -> None:  # holds _rs_mtx
        """(state.go:1609)"""
        if self.height != height or round_ < self.round or (
            self.round == round_ and self.step >= STEP_PRECOMMIT
        ):
            return
        self.round = round_
        self._set_step(STEP_PRECOMMIT)
        self._new_step()
        prevotes = self.votes.prevotes(round_)
        maj23 = prevotes.two_thirds_majority() if prevotes else None
        if maj23 is None:
            # no polka: precommit nil
            self._sign_add_vote(PRECOMMIT_TYPE, None)
            return
        if self.event_bus is not None and not self._replay_mode:
            self.event_bus.publish_polka(self._rs_event())
        pol_round, _ = self.votes.pol_info()
        if pol_round < round_:
            raise ConsensusError("polka round inconsistency")
        if maj23.is_nil():
            # +2/3 prevoted nil: unlock and precommit nil (state.go:1674)
            self.locked_round = -1
            self.locked_block = None
            self.locked_block_parts = None
            self._sign_add_vote(PRECOMMIT_TYPE, None)
            return
        if (
            self.locked_block is not None
            and self.locked_block.hash() == maj23.hash
        ):
            # re-lock on same block
            self.locked_round = round_
            self._sign_add_vote(PRECOMMIT_TYPE, self.locked_block)
            return
        if (
            self.proposal_block is not None
            and self.proposal_block.hash() == maj23.hash
        ):
            # lock on the polka block
            try:
                self.block_exec.validate_block(self.state, self.proposal_block)
            except Exception as exc:
                raise ConsensusError(
                    f"+2/3 prevoted an invalid block: {exc}"
                ) from exc
            self.locked_round = round_
            self.locked_block = self.proposal_block
            self.locked_block_parts = self.proposal_block_parts
            self._sign_add_vote(PRECOMMIT_TYPE, self.proposal_block)
            return
        # Polka for a block we don't have: unlock, fetch it via gossip
        self.locked_round = -1
        self.locked_block = None
        self.locked_block_parts = None
        if self.proposal_block_parts is None or not (
            self.proposal_block_parts.has_header(maj23.part_set_header)
        ):
            self.proposal_block = None
            self.proposal_block_parts = PartSet(maj23.part_set_header)
        self._sign_add_vote(PRECOMMIT_TYPE, None)

    def _enter_precommit_wait(self, height: int, round_: int) -> None:  # holds _rs_mtx
        if self.height != height or round_ < self.round or (
            self.round == round_ and self.triggered_timeout_precommit
        ):
            return
        self.triggered_timeout_precommit = True
        self._ticker.schedule(
            TimeoutInfo(
                self.config.precommit_timeout_ns(round_),
                height,
                round_,
                STEP_PRECOMMIT_WAIT,
            )
        )

    # -- commit ----------------------------------------------------------

    def _enter_commit(self, height: int, commit_round: int) -> None:  # holds _rs_mtx
        """(state.go:1743)"""
        if self.height != height or self.step >= STEP_COMMIT:
            return
        self.commit_round = commit_round
        self.commit_time_ns = now_ns()  # deterministic: round scheduling, not state — decides WHEN, never WHAT
        self._set_step(STEP_COMMIT)
        if not self._replay_mode:
            _tracer.add_complete(
                "height/quorum_precommit", time.perf_counter(), 0.0,
                cat="height",
                args={
                    "height": height,
                    "round": commit_round,
                    "parent": "height/pipeline",
                },
            )
        self._new_step()
        precommits = self.votes.precommits(commit_round)
        maj23 = precommits.two_thirds_majority()
        if maj23 is None or maj23.is_nil():
            raise ConsensusError("enterCommit without +2/3 for a block")
        # lock → proposal promotion so finalize uses the decided block
        if self.locked_block is not None and self.locked_block.hash() == maj23.hash:
            self.proposal_block = self.locked_block
            self.proposal_block_parts = self.locked_block_parts
        if (
            self.proposal_block is None
            or self.proposal_block.hash() != maj23.hash
        ):
            if self.proposal_block_parts is None or not (
                self.proposal_block_parts.has_header(maj23.part_set_header)
            ):
                self.proposal_block = None
                # drop a conflicting proposal too: the network decided a
                # different block (equivocating proposer); keeping it
                # would make the hash check reject the decided block
                self.proposal = None
                self.proposal_block_parts = PartSet(maj23.part_set_header)
                # drain parts that arrived before the commit header was
                # known (proof-checked against the header by add_part)
                early, self._early_parts = self._early_parts, []
                for part, from_peer in early:
                    try:
                        self._add_proposal_block_part(
                            BlockPartMessage(
                                height=height, round=commit_round, part=part
                            ),
                            from_peer,
                        )
                    except Exception as exc:  # noqa: BLE001 — stashed parts
                        # are unvalidated; bad proofs get skipped, but
                        # never silently
                        FLIGHT.record(
                            "early_part_rejected",
                            height=height,
                            err=type(exc).__name__,
                        )
                        continue
                if self.proposal_block is None:
                    return  # wait for parts via gossip
        self._try_finalize_commit(height)

    def _try_finalize_commit(self, height: int) -> None:  # holds _rs_mtx
        """(state.go:1806)"""
        if self.height != height:
            return
        precommits = self.votes.precommits(self.commit_round)
        maj23 = precommits.two_thirds_majority() if precommits else None
        if maj23 is None or maj23.is_nil():
            return
        if (
            self.proposal_block is None
            or self.proposal_block.hash() != maj23.hash
        ):
            return  # don't have the block yet
        self._finalize_commit(height)

    def _finalize_commit(self, height: int) -> None:  # holds _rs_mtx
        """(state.go:1834) SaveBlock → WAL EndHeight → ApplyBlock →
        next height."""
        if self.step != STEP_COMMIT:
            return
        precommits = self.votes.precommits(self.commit_round)
        block_id = precommits.two_thirds_majority()
        block, parts = self.proposal_block, self.proposal_block_parts
        if not parts.has_header(block_id.part_set_header):
            raise ConsensusError("commit partset header mismatch")

        # One height is ONE span tree ("height/pipeline" root, recorded
        # below once the height closes): the commit pipeline — store
        # save, WAL height boundary, ABCI FinalizeBlock/Commit — runs
        # inside this lexical span, so its children nest under it via
        # thread-local parenting.  Replay re-commits don't observe.
        commit_round = self.commit_round
        pipeline_t0 = self._height_t0
        pipeline_span = (
            _tracer.span(
                "height/commit_pipeline", cat="height",
                parent="height/pipeline", height=height,
                round=commit_round,
            )
            if not self._replay_mode
            else NOP_SPAN
        )
        with pipeline_span:
            if self.block_store.height() < block.header.height:
                seen_commit = precommits.make_commit()
                extended = None
                if self.state.consensus_params.vote_extensions_enabled(
                    height
                ):
                    # keep the precommits WITH extensions — atomically
                    # with the block, so a crash can't strand a stored
                    # block whose extensions the height+1 proposer then
                    # silently lacks (store.go SaveBlockWithExtendedCommit)
                    extended = precommits.votes()
                self.block_store.save_block(  # trusted: _verify — parts proof-verified at admission, precommits signature-verified by VoteSet._verify; the commit is assembled from the 2/3 majority
                    block, parts, seen_commit, extended_votes=extended
                )
            # Height boundary: the block is durably stored; a crash after
            # this replays from handshake, not the WAL (wal.go
            # EndHeightMessage).
            self.wal.write_end_height(height)

            new_state = self.block_exec.apply_block(
                self.state,
                BlockID(hash=block.hash(), part_set_header=parts.header),
                block,
            )
            if self.determinism and not self._replay_mode:
                # the digest record rides AFTER end_height(H), so it is
                # part of height H+1's replay window (and the startup
                # sweep sees every record regardless of position);
                # fsynced so the guard's evidence survives a crash
                d = self.block_exec.last_transition_digest
                if d is not None and d.height == height:
                    self.wal.write_sync(
                        KIND_TRANSITION_DIGEST, d.encode()
                    )
        self.logger.info(
            "committed block",
            height=height,
            hash=(block.hash() or b"").hex()[:12],
            num_txs=len(block.data.txs),
        )
        m = self.metrics
        m.committed_height.set(height)
        m.num_txs.set(len(block.data.txs))
        m.total_txs.inc(len(block.data.txs))
        m.block_size_bytes.set(len(block.encode()))
        byz: set[bytes] = set()
        for ev in block.evidence:
            vote_a = getattr(ev, "vote_a", None)
            if vote_a is not None:
                byz.add(vote_a.validator_address)
            else:
                byz.update(getattr(ev, "byzantine_validators", ()))
        m.byzantine_validators.set(len(byz))
        prev = self.block_store.load_block_meta(height - 1)
        if prev is not None and prev.header.time_ns:
            m.block_interval_seconds.observe(
                max(0.0, (block.header.time_ns - prev.header.time_ns) / 1e9)  # deterministic: metrics observation only — never enters state
            )
        self._update_to_state(new_state)
        if not self._replay_mode:
            # the height's root span: NewHeight entry → commit applied.
            # Children (consensus/<Step>, the receipt/quorum marks, the
            # commit pipeline) all carry parent="height/pipeline".
            _tracer.add_complete(
                "height/pipeline", pipeline_t0,
                time.perf_counter() - pipeline_t0,
                cat="height",
                args={"height": height, "round": commit_round},
            )
            FLIGHT.record(
                "commit", height=height, round=commit_round,
                num_txs=len(block.data.txs),
                hash=(block.hash() or b"").hex()[:12],
            )
            # attribution plane: decompose the span tree just recorded
            # into stage budgets (best-effort inside observe_height —
            # the commit must not depend on the diagnostics plane)
            critpath.observe_height(height, tracer=_tracer)
        self._schedule_round_0()

    # -- votes -----------------------------------------------------------

    def _try_add_vote(self, vote: Vote, peer_id: str) -> None:  # holds _rs_mtx
        """(state.go:2243 tryAddVote)"""
        try:
            self._add_vote(vote, peer_id)
        except ConflictingVoteError as conflict:
            if self.priv_validator is not None and (
                vote.validator_address == self.priv_validator.address
            ):
                self.logger.error(
                    "found conflicting vote from ourselves",
                    height=vote.height,
                    round=vote.round,
                )
                return
            self.block_exec.ev_pool.report_conflicting_votes(
                conflict.vote_a, conflict.vote_b
            )
        except Exception as exc:  # noqa: BLE001
            self.logger.debug("failed adding vote", err=repr(exc))

    def _add_vote(self, vote: Vote, peer_id: str) -> bool:  # holds _rs_mtx
        """(state.go:2294 addVote)"""
        # Precommit for the previous height (LastCommit catchup)
        if (
            vote.height + 1 == self.height
            and vote.type == PRECOMMIT_TYPE
            and self.step == STEP_NEW_HEIGHT
            and self.last_commit is not None
        ):
            added = self.last_commit.add_vote(vote)
            if added and self.event_bus is not None and not self._replay_mode:
                self.event_bus.publish_vote(EventDataVote(vote=vote))
            return added
        if vote.height != self.height:
            return False

        # Vote-extension verification for current-height precommits
        if (
            vote.type == PRECOMMIT_TYPE
            and not vote.is_nil()
            and self.state.consensus_params.vote_extensions_enabled(
                self.height
            )
            # verify every validator's extension except our own — on a
            # non-validator node (no priv_validator) that means ALL of
            # them (state.go addVote: myAddr is empty for observers)
            and (
                self.priv_validator is None
                or vote.validator_address != self.priv_validator.address
            )
        ):
            resp = self.block_exec.proxy_app.verify_vote_extension(
                VerifyVoteExtensionRequest(
                    hash=vote.block_id.hash,
                    validator_address=vote.validator_address,
                    height=vote.height,
                    vote_extension=vote.extension,
                )
            )
            if not resp.is_accepted:
                raise ConsensusError("vote extension rejected by app")

        added = self.votes.add_vote(vote, peer_id)
        if not added:
            return False
        if self.event_bus is not None and not self._replay_mode:
            self.event_bus.publish_vote(EventDataVote(vote=vote))

        if vote.type == PREVOTE_TYPE:
            self._on_prevote_added(vote)
        else:
            self._on_precommit_added(vote)
        return True

    def _on_prevote_added(self, vote: Vote) -> None:  # holds _rs_mtx
        prevotes = self.votes.prevotes(vote.round)
        maj23 = prevotes.two_thirds_majority()
        if maj23 is not None:
            if (
                vote.round > self._quorum_prevote_round
                and self.proposal is not None
                and self.proposal.round == vote.round
                and not self._replay_mode
            ):
                # first +2/3 prevote quorum for the proposal's round:
                # how long after the proposal's timestamp did it land
                # (metrics.go QuorumPrevoteDelay).  A late quorum for
                # an older round doesn't belong to this proposal, and
                # WAL replay would measure against the current wall
                # clock — both are skipped.
                self._quorum_prevote_round = vote.round
                self.metrics.quorum_prevote_delay.labels(
                    proposer_address=(
                        self.validators.get_proposer().address.hex()
                    )
                ).set(
                    max(0.0, (now_ns() - self.proposal.timestamp_ns) / 1e9)  # deterministic: metrics observation only — never enters state
                )
                _tracer.add_complete(
                    "height/quorum_prevote", time.perf_counter(), 0.0,
                    cat="height",
                    args={
                        "height": self.height,
                        "round": vote.round,
                        "parent": "height/pipeline",
                    },
                )
            # Unlock if a newer polka contradicts our lock (state.go:2372)
            if (
                self.locked_block is not None
                and self.locked_round < vote.round <= self.round
                and self.locked_block.hash() != maj23.hash
            ):
                self.locked_round = -1
                self.locked_block = None
                self.locked_block_parts = None
            # Track the most recent valid block (state.go:2392)
            if not maj23.is_nil() and self.valid_round < vote.round <= self.round:
                if (
                    self.proposal_block is not None
                    and self.proposal_block.hash() == maj23.hash
                ):
                    self.valid_round = vote.round
                    self.valid_block = self.proposal_block
                    self.valid_block_parts = self.proposal_block_parts
                elif self.proposal_block_parts is None or not (
                    self.proposal_block_parts.has_header(
                        maj23.part_set_header
                    )
                ):
                    # polka for a block we don't have: start fetching it
                    self.proposal_block = None
                    self.proposal_block_parts = PartSet(
                        maj23.part_set_header
                    )

        if self.round < vote.round and prevotes.has_two_thirds_any():
            self._enter_new_round(self.height, vote.round)
        elif self.round == vote.round and self.step >= STEP_PREVOTE:
            if maj23 is not None and (
                self._is_proposal_complete() or maj23.is_nil()
            ):
                self._enter_precommit(self.height, vote.round)
            elif prevotes.has_two_thirds_any() and self.step == STEP_PREVOTE:
                self._enter_prevote_wait(self.height, vote.round)
        elif (
            self.proposal is not None
            and 0 <= self.proposal.pol_round == vote.round
        ):
            if self._is_proposal_complete():
                self._enter_prevote(self.height, self.round)

    def _on_precommit_added(self, vote: Vote) -> None:  # holds _rs_mtx
        precommits = self.votes.precommits(vote.round)
        maj23 = precommits.two_thirds_majority()
        if maj23 is not None:
            self._enter_new_round(self.height, vote.round)
            self._enter_precommit(self.height, vote.round)
            if not maj23.is_nil():
                self._enter_commit(self.height, vote.round)
                if self.config.skip_timeout_commit and precommits.has_all():
                    self._enter_new_round(self.height, 0)
            else:
                self._enter_precommit_wait(self.height, vote.round)
        elif self.round <= vote.round and precommits.has_two_thirds_any():
            self._enter_new_round(self.height, vote.round)
            self._enter_precommit_wait(self.height, vote.round)

    def _sign_vote(self, vote_type: int, block: Block | None) -> Vote | None:  # holds _rs_mtx
        if self.priv_validator is None:
            return None
        addr = self.priv_validator.address
        idx, _ = self.validators.get_by_address(addr)
        if idx < 0:
            return None  # not a validator this height
        if block is None:
            block_id = BlockID()
        else:
            parts = (
                self.proposal_block_parts
                if self.proposal_block is block
                else (
                    self.locked_block_parts
                    if self.locked_block is block
                    else None
                )
            )
            if parts is None:
                parts = block.make_part_set(BLOCK_PART_SIZE_BYTES)
            block_id = BlockID(
                hash=block.hash(), part_set_header=parts.header
            )
        vote = Vote(
            type=vote_type,
            height=self.height,
            round=self.round,
            block_id=block_id,
            timestamp_ns=max(now_ns(), self.state.last_block_time_ns + 1),  # deterministic: votes carry signed LOCAL time by protocol — BFT time is their median
            validator_address=addr,
            validator_index=idx,
        )
        ext_enabled = self.state.consensus_params.vote_extensions_enabled(
            self.height
        )
        if ext_enabled and vote_type == PRECOMMIT_TYPE and block is not None:
            resp = self.block_exec.proxy_app.extend_vote(
                ExtendVoteRequest(
                    hash=block_id.hash,
                    height=self.height,
                    round=self.round,
                )
            )
            vote = replace(vote, extension=resp.vote_extension)
        try:
            return self.priv_validator.sign_vote(
                self.state.chain_id,
                vote,
                with_extension=ext_enabled and vote_type == PRECOMMIT_TYPE,
            )
        except Exception as exc:
            self.logger.error("failed signing vote", err=repr(exc))
            return None

    def _sign_add_vote(self, vote_type: int, block: Block | None) -> None:  # holds _rs_mtx
        vote = self._sign_vote(vote_type, block)
        if vote is not None:
            self._send_internal(VoteMessage(vote))
            # the node's adversary (consensus/byz.py): a no-op attribute
            # test unless a caller armed it with equivocate
            self.byz.maybe_equivocate(
                vote, self.priv_validator, self.state.chain_id
            )
