"""BlockExecutor — proposal creation, validation, and block application
(a copy of cometbft_tpu/state/execution.py; reference:
state/execution.go:26).

The one engine shared by consensus and blocksync: it owns the ABCI
consensus connection, the mempool lock across Commit, and the state
transition (validator-set rotation, params updates, results hash).
Commit verification of the previous block funnels into
``types.validation`` and from there onto the card's batch verifier.

Where the port departs from its reference:
- ``validate_block`` and ``BlockExecutor`` take a keyword ``device``
  (``cuda`` unless the caller names another; without a card only
  ``device="cpu"`` runs) and pass it to every ``verify_commit``;
- the node's adversary is an argument, ``byz`` (``consensus/byz.py``;
  unarmed unless the caller arms it), where the reference reads
  ``CMT_TPU_BYZ`` into a process-wide one;
- the replay-determinism guard is an argument, ``determinism``, where
  the reference reads ``CMT_TPU_DETERMINISM``: with it on,
  ``last_transition_digest`` is the digest of the last applied block.

After each commit the app's positive retain height goes to ``pruner``
(``state/pruner.py``) when the caller has wired one, as in the
reference.  ``validate_block`` notes the trust guard's validator and
``apply_block`` is a sink, as in the reference.
"""

from __future__ import annotations

import time

from cometbft_tpu_torch.abci.types import (
    CommitInfo,
    FinalizeBlockRequest,
    FinalizeBlockResponse,
    Misbehavior,
    PrepareProposalRequest,
    ProcessProposalRequest,
    MISBEHAVIOR_DUPLICATE_VOTE,
    MISBEHAVIOR_LIGHT_CLIENT_ATTACK,
    ValidatorUpdate,
    VoteInfo,
    results_hash,
)
from cometbft_tpu_torch.crypto.ed25519 import Ed25519PubKey
from cometbft_tpu_torch.state import State, Store, determinism as _determinism
from cometbft_tpu_torch.types.block import Block, BlockID, Commit
from cometbft_tpu_torch.types.evidence import (
    DuplicateVoteEvidence,
    LightClientAttackEvidence,
)
from cometbft_tpu_torch.types.event_bus import (
    EventBus,
    EventDataNewBlock,
    EventDataNewBlockHeader,
    EventDataTx,
    EventDataValidatorSetUpdates,
)
from cometbft_tpu_torch.types.validation import verify_commit
from cometbft_tpu_torch.types.validator import ValidatorSet
from cometbft_tpu_torch.utils.env import resolve_device
from cometbft_tpu_torch.utils.fail import fail_point
from cometbft_tpu_torch.utils.flight import FLIGHT
from cometbft_tpu_torch.utils.log import Logger, default_logger
from cometbft_tpu_torch.utils.time import now_ns
from cometbft_tpu_torch.utils.trace import TRACER
from cometbft_tpu_torch.version import BLOCK_PROTOCOL
from cometbft_tpu_torch.utils import trustguard

MAX_OVERHEAD_FOR_BLOCK = 11
MAX_HEADER_BYTES = 626
MAX_COMMIT_OVERHEAD = 94
MAX_COMMIT_SIG_BYTES = 109


class BlockExecutionError(Exception):
    pass


class InvalidBlockError(BlockExecutionError):
    pass


def max_data_bytes(max_bytes: int, evidence_bytes: int, num_vals: int) -> int:
    """Space left for txs in a block (types/block.go MaxDataBytes)."""
    return (
        max_bytes
        - MAX_OVERHEAD_FOR_BLOCK
        - MAX_HEADER_BYTES
        - MAX_COMMIT_OVERHEAD
        - num_vals * MAX_COMMIT_SIG_BYTES
        - evidence_bytes
    )


def median_time(commit: Commit, vals: ValidatorSet) -> int:
    """Voting-power-weighted median of commit timestamps — BFT time
    (types/time/weighted_time.go WeightedMedian).  With +2/3 honest
    power the median is bounded by honest clocks."""
    pairs: list[tuple[int, int]] = []
    total = 0
    for cs in commit.signatures:
        if cs.is_absent():
            continue
        _, val = vals.get_by_address(cs.validator_address)
        if val is None:
            continue
        pairs.append((cs.timestamp_ns, val.voting_power))
        total += val.voting_power
    if not pairs:
        raise BlockExecutionError("no timestamps in commit")
    pairs.sort()
    half = total // 2
    acc = 0
    for t, p in pairs:
        acc += p
        if acc > half:
            return t
    return pairs[-1][0]


class _NopEvidencePool:
    """(state/services.go EmptyEvidencePool)"""

    def pending_evidence(self, max_bytes: int) -> tuple[list, int]:
        return [], 0

    def check_evidence(self, ev_list) -> None:
        if ev_list:
            raise InvalidBlockError("unexpected evidence in block")

    def update(self, state: State, ev_list) -> None:
        pass

    def report_conflicting_votes(self, vote_a, vote_b) -> None:
        pass


def abci_validator_updates_to_changes(
    updates: tuple[ValidatorUpdate, ...],
) -> list[tuple[Ed25519PubKey, int]]:
    changes = []
    for u in updates:
        if u.pub_key_type != "ed25519":
            raise BlockExecutionError(
                f"unsupported validator key type {u.pub_key_type!r}"
            )
        if u.power < 0:
            raise BlockExecutionError("negative validator power")
        changes.append((Ed25519PubKey(u.pub_key_bytes), u.power))
    return changes


def extended_commit_info(last_commit: Commit, votes, last_vals: ValidatorSet):
    """ExtendedCommitInfo for PrepareProposal (execution.go
    buildExtendedCommitInfoFromStore): per last-validator entry with
    its vote extension + extension signature; absent validators get
    empty entries so indices align.  Flags mirror MakeCommit's rules:
    a precommit for a block OTHER than the decided one counts ABSENT
    (its extension never passed the decided-block quorum), and nil
    precommits never carry extensions to the app (their extensions are
    not signature-verified — ABCI contract: extension only with
    flag=COMMIT)."""
    from cometbft_tpu_torch.abci.types import ExtendedCommitInfo, ExtendedVoteInfo
    from cometbft_tpu_torch.types.block import (
        BLOCK_ID_FLAG_ABSENT,
        BLOCK_ID_FLAG_COMMIT,
        BLOCK_ID_FLAG_NIL,
    )

    decided = last_commit.block_id
    infos = []
    for i in range(len(last_vals)):
        val = last_vals.get_by_index(i)
        vote = votes[i] if votes is not None and i < len(votes) else None
        if vote is None or (
            not vote.block_id.is_nil() and vote.block_id != decided
        ):
            infos.append(
                ExtendedVoteInfo(
                    validator_address=val.address,
                    validator_power=val.voting_power,
                    block_id_flag=BLOCK_ID_FLAG_ABSENT,
                )
            )
            continue
        if vote.block_id.is_nil():
            infos.append(
                ExtendedVoteInfo(
                    validator_address=val.address,
                    validator_power=val.voting_power,
                    block_id_flag=BLOCK_ID_FLAG_NIL,
                )
            )
            continue
        infos.append(
            ExtendedVoteInfo(
                validator_address=val.address,
                validator_power=val.voting_power,
                vote_extension=vote.extension,
                extension_signature=vote.extension_signature,
                block_id_flag=BLOCK_ID_FLAG_COMMIT,
            )
        )
    return ExtendedCommitInfo(round=last_commit.round, votes=tuple(infos))


def build_last_commit_info(block: Block, store) -> CommitInfo:
    """CommitInfo for FinalizeBlock (state/execution.go buildLastCommitInfo)."""
    if block.header.height == 1 or block.last_commit is None:
        return CommitInfo()
    last_vals = store.load_validators(block.header.height - 1)
    votes = []
    for i, cs in enumerate(block.last_commit.signatures):
        val = last_vals.get_by_index(i)
        votes.append(
            VoteInfo(
                validator_address=val.address if val else cs.validator_address,
                validator_power=val.voting_power if val else 0,
                block_id_flag=cs.block_id_flag,
            )
        )
    return CommitInfo(round=block.last_commit.round, votes=tuple(votes))


def evidence_to_misbehavior(ev_list, state: State, store) -> tuple[Misbehavior, ...]:
    """(types/evidence.go Evidence.ABCI)"""
    out = []
    for ev in ev_list:
        if isinstance(ev, DuplicateVoteEvidence):
            out.append(
                Misbehavior(
                    type=MISBEHAVIOR_DUPLICATE_VOTE,
                    validator_address=ev.vote_a.validator_address,
                    validator_power=ev.validator_power,
                    height=ev.height,
                    time_ns=ev.timestamp_ns,
                    total_voting_power=ev.total_voting_power,
                )
            )
        elif isinstance(ev, LightClientAttackEvidence):
            for addr in ev.byzantine_validators:
                out.append(
                    Misbehavior(
                        type=MISBEHAVIOR_LIGHT_CLIENT_ATTACK,
                        validator_address=addr,
                        validator_power=0,
                        height=ev.height,
                        time_ns=ev.timestamp_ns,
                        total_voting_power=ev.total_voting_power,
                    )
                )
    return tuple(out)


def validate_block(state: State, block: Block, block_store=None, *, device=None) -> None:
    """Full header/commit validation against the current state
    (state/validation.go validateBlock).  ``device``: where the last
    commit's batch runs (``cuda`` unless given)."""
    block.validate_basic()
    h = block.header
    if h.version_block != BLOCK_PROTOCOL:
        raise InvalidBlockError(
            f"block protocol {h.version_block}, expected {BLOCK_PROTOCOL}"
        )
    if h.version_app != state.version_app:
        raise InvalidBlockError(
            f"app version {h.version_app}, expected {state.version_app}"
        )
    if h.chain_id != state.chain_id:
        raise InvalidBlockError(
            f"chain id {h.chain_id!r}, expected {state.chain_id!r}"
        )
    expected_height = (
        state.initial_height
        if state.last_block_height == 0
        else state.last_block_height + 1
    )
    if h.height != expected_height:
        raise InvalidBlockError(
            f"height {h.height}, expected {expected_height}"
        )
    if h.last_block_id != state.last_block_id:
        raise InvalidBlockError("wrong last_block_id")

    # hashes derived from state
    if h.validators_hash != state.validators.hash():
        raise InvalidBlockError("wrong validators_hash")
    if h.next_validators_hash != state.next_validators.hash():
        raise InvalidBlockError("wrong next_validators_hash")
    if h.consensus_hash != state.consensus_params.hash():
        raise InvalidBlockError("wrong consensus_hash")
    if h.app_hash != state.app_hash:
        raise InvalidBlockError("wrong app_hash")
    if h.last_results_hash != state.last_results_hash:
        raise InvalidBlockError("wrong last_results_hash")

    # hashes derived from the block itself
    if h.data_hash != block.data.hash():
        raise InvalidBlockError("wrong data_hash")

    # last commit
    if h.height == state.initial_height:
        if block.last_commit is not None and block.last_commit.size() > 0:
            raise InvalidBlockError("initial block cannot have last commit")
        expected_hash = (
            block.last_commit.hash() if block.last_commit is not None else b""
        )
        if h.last_commit_hash != expected_hash:
            raise InvalidBlockError("wrong last_commit_hash at initial height")
    else:
        lc = block.last_commit
        if lc is None or lc.size() != len(state.last_validators):
            raise InvalidBlockError("wrong last_commit size")
        if h.last_commit_hash != lc.hash():
            raise InvalidBlockError("wrong last_commit_hash")
        # THE hot path: batch-verify the previous height's commit
        # (state/validation.go:94 → types/validation → TPU kernel)
        verify_commit(
            state.chain_id,
            state.last_validators,
            state.last_block_id,
            h.height - 1,
            lc,
            device=device,
        )

    if not state.validators.has_address(h.proposer_address):
        raise InvalidBlockError("proposer not in validator set")

    # block time
    if h.height == state.initial_height:
        if h.time_ns != state.last_block_time_ns:
            raise InvalidBlockError("genesis block time mismatch")
    elif state.consensus_params.pbts_enabled(h.height):
        if h.time_ns <= state.last_block_time_ns:
            raise InvalidBlockError("block time not monotonic")
    else:
        expected = median_time(block.last_commit, state.last_validators)
        if h.time_ns != expected:
            raise InvalidBlockError(
                f"block time {h.time_ns} != median time {expected}"
            )


def update_state(
    state: State,
    block_id: BlockID,
    block: Block,
    resp: FinalizeBlockResponse,
) -> State:
    """Pure state transition (state/execution.go updateState):
    validator sets rotate forward one height, ABCI updates land in the
    n+2 set, params updates take effect next height."""
    h = block.header
    n_val_set = state.next_validators.copy()
    last_height_vals_changed = state.last_height_validators_changed
    if resp.validator_updates:
        changes = abci_validator_updates_to_changes(resp.validator_updates)
        n_val_set = n_val_set.update_with_change_set(changes)
        last_height_vals_changed = h.height + 1 + 1

    params = state.consensus_params
    last_height_params_changed = state.last_height_params_changed
    if resp.consensus_param_updates is not None:
        params = resp.consensus_param_updates
        params.validate()
        last_height_params_changed = h.height + 1

    return State(
        chain_id=state.chain_id,
        initial_height=state.initial_height,
        last_block_height=h.height,
        last_block_id=block_id,
        last_block_time_ns=h.time_ns,
        validators=state.next_validators.copy(),
        next_validators=n_val_set.increment_proposer_priority(1),
        last_validators=state.validators.copy(),
        last_height_validators_changed=last_height_vals_changed,
        consensus_params=params,
        last_height_params_changed=last_height_params_changed,
        last_results_hash=results_hash(list(resp.tx_results)),
        app_hash=resp.app_hash,
        version_app=state.version_app,
    )


class BlockExecutor:
    """(state/execution.go:26)"""

    def __init__(
        self,
        state_store: Store,
        proxy_app,  # consensus connection
        mempool,
        evidence_pool=None,
        block_store=None,
        event_bus: EventBus | None = None,
        metrics=None,
        logger: Logger | None = None,
        *,
        device=None,
        byz=None,
        determinism: bool = False,
    ):
        # consensus/byz.py imports nothing at module level, but the
        # consensus package (which imports this module) would run first
        from cometbft_tpu_torch.consensus.byz import Byz

        self.device = resolve_device(device)
        self.byz = byz if byz is not None else Byz()
        self.determinism = determinism
        self.state_store = state_store
        self.proxy_app = proxy_app
        self.mempool = mempool
        self.ev_pool = evidence_pool or _NopEvidencePool()
        self.block_store = block_store
        self.event_bus = event_bus
        from cometbft_tpu_torch.metrics import StateMetrics

        self.metrics = metrics if metrics is not None else StateMetrics()
        self.logger = logger or default_logger().with_fields(module="executor")
        self.retain_height = 0  # last app-requested retain height
        self.pruner = None  # wired by the node (state/pruner.py)
        # TransitionDigest of the last apply_block with the
        # determinism guard on (state/determinism.py); None otherwise
        self.last_transition_digest = None

    # -- proposal path ---------------------------------------------------

    def create_proposal_block(
        self,
        height: int,
        state: State,
        last_commit: Commit | None,
        proposer_address: bytes,
        extended_votes=None,
    ) -> Block:
        """Reap mempool + PrepareProposal (state/execution.go:113).

        ``extended_votes``: last height's precommit Votes including
        their vote extensions (index-aligned with last_validators);
        when given, PrepareProposal receives them as local_last_commit
        so the app can act on the extensions it collected
        (execution.go buildExtendedCommitInfoFromStore)."""
        max_bytes = state.consensus_params.block.max_bytes
        if max_bytes == -1:
            max_bytes = 104857600
        max_gas = state.consensus_params.block.max_gas

        evidence, ev_size = self.ev_pool.pending_evidence(
            state.consensus_params.evidence.max_bytes
        )
        data_limit = max_data_bytes(max_bytes, ev_size, len(state.validators))
        txs = self.mempool.reap_max_bytes_max_gas(data_limit, max_gas)

        if height == state.initial_height:
            time_ns = state.last_block_time_ns
        elif state.consensus_params.pbts_enabled(height):
            time_ns = max(now_ns(), state.last_block_time_ns + 1)  # deterministic: proposer's PBTS block-time stamp — validators re-check it via _proposal_is_timely
        else:
            time_ns = median_time(last_commit, state.last_validators)

        local_last_commit = None
        if extended_votes is not None and last_commit is not None:
            local_last_commit = extended_commit_info(
                last_commit, extended_votes, state.last_validators
            )
        req = PrepareProposalRequest(
            max_tx_bytes=data_limit,
            txs=tuple(txs),
            local_last_commit=local_last_commit,
            misbehavior=evidence_to_misbehavior(evidence, state, None),
            height=height,
            time_ns=time_ns,
            next_validators_hash=state.next_validators.hash(),
            proposer_address=proposer_address,
        )
        resp = self.proxy_app.prepare_proposal(req)
        total = sum(len(tx) for tx in resp.txs)
        if total > data_limit:
            raise BlockExecutionError(
                f"PrepareProposal returned {total} tx bytes > limit {data_limit}"
            )
        # the node's adversary (consensus/byz.py): identity unless
        # forge_stx armed it — then the block is built (and hashed)
        # over a forged envelope honest process_proposal must refuse
        block_txs = self.byz.maybe_forge_stx(tuple(resp.txs))
        return state.make_block(
            height,
            block_txs,
            last_commit if last_commit is not None else Commit(),
            tuple(evidence),
            proposer_address,
            time_ns,
        )

    def process_proposal(self, block: Block, state: State) -> bool:
        """(state/execution.go:173)"""
        req = ProcessProposalRequest(
            txs=block.data.txs,
            proposed_last_commit=build_last_commit_info(
                block, self.state_store
            )
            if block.header.height > state.initial_height
            else None,
            misbehavior=evidence_to_misbehavior(block.evidence, state, None),
            hash=block.hash() or b"",
            height=block.header.height,
            time_ns=block.header.time_ns,
            next_validators_hash=block.header.next_validators_hash,
            proposer_address=block.header.proposer_address,
        )
        accepted = self.proxy_app.process_proposal(req).is_accepted
        self.metrics.process_proposal_total.labels(
            result="accept" if accepted else "reject"
        ).inc()
        return accepted

    # -- apply path ------------------------------------------------------

    def validate_block(self, state: State, block: Block) -> None:
        validate_block(state, block, self.block_store, device=self.device)
        self.ev_pool.check_evidence(list(block.evidence))
        trustguard.note_validated("validate_block")

    def apply_block(
        self,
        state: State,
        block_id: BlockID,
        block: Block,
        syncing_to_height: int = 0,
    ) -> State:
        """Validate → FinalizeBlock → persist → Commit → events
        (state/execution.go:224 ApplyBlock)."""
        with TRACER.span(
            "exec/apply_block", cat="exec", height=block.header.height
        ):
            return self._apply_block_inner(
                state, block_id, block, syncing_to_height
            )

    def _apply_block_inner(
        self,
        state: State,
        block_id: BlockID,
        block: Block,
        syncing_to_height: int = 0,
    ) -> State:
        self.validate_block(state, block)
        trustguard.check_sink("apply_block")

        # duration clock, not wall clock: the measurement feeds metrics
        # only, and determcheck keeps wall-time reads off the apply path
        start = time.perf_counter()
        req = FinalizeBlockRequest(
            txs=block.data.txs,
            decided_last_commit=build_last_commit_info(
                block, self.state_store
            ),
            misbehavior=evidence_to_misbehavior(block.evidence, state, None),
            hash=block.hash() or b"",
            height=block.header.height,
            time_ns=block.header.time_ns,
            next_validators_hash=block.header.next_validators_hash,
            proposer_address=block.header.proposer_address,
            syncing_to_height=syncing_to_height or block.header.height,
        )
        resp = self.proxy_app.finalize_block(req)
        elapsed_s = time.perf_counter() - start
        self.metrics.block_processing_time.observe(elapsed_s)
        if resp.validator_updates:
            self.metrics.validator_set_updates.inc()
        if resp.consensus_param_updates is not None:
            self.metrics.consensus_param_updates.inc()
        self.logger.info(
            "finalized block",
            height=block.header.height,
            num_txs=len(block.data.txs),
            ms=round(elapsed_s * 1e3, 2),
        )
        if len(resp.tx_results) != len(block.data.txs):
            raise BlockExecutionError(
                f"app returned {len(resp.tx_results)} tx results for "
                f"{len(block.data.txs)} txs"
            )

        fail_point()  # crash point 1 (execution.go:270)
        self.state_store.save_finalize_block_response(
            block.header.height, resp
        )
        fail_point()  # crash point 2 (execution.go:277)

        new_state = update_state(state, block_id, block, resp)

        if self.determinism:
            self.last_transition_digest = _determinism.transition_digest(
                block.header.height, block_id, resp
            )
            FLIGHT.record(
                "determinism_digest",
                height=block.header.height,
                digest=self.last_transition_digest.digest[:16],
            )

        # Commit: lock mempool so no CheckTx lands between app Commit and
        # mempool Update (execution.go:405)
        retain_height = self._commit(new_state, block, resp)

        fail_point()  # crash point 3 (execution.go:317)
        self.ev_pool.update(new_state, list(block.evidence))
        self.state_store.save(new_state)
        fail_point()  # crash point 4 (execution.go:325)

        self._fire_events(block, block_id, resp)
        # advisory for the background pruner (node/node.go createPruner)
        self.retain_height = max(retain_height, 0)
        if self.pruner is not None and retain_height > 0:
            try:
                self.pruner.set_application_retain_height(retain_height)
            except Exception as exc:  # noqa: BLE001 — never block commit
                self.logger.error(
                    "failed to record retain height", err=repr(exc)
                )
        return new_state

    def _commit(
        self, state: State, block: Block, resp: FinalizeBlockResponse
    ) -> int:
        self.mempool.lock()
        try:
            if hasattr(self.mempool, "flush_app_conn"):
                self.mempool.flush_app_conn()
            commit_resp = self.proxy_app.commit()
            self.mempool.update(
                block.header.height,
                list(block.data.txs),
                list(resp.tx_results),
            )
            return commit_resp.retain_height
        finally:
            self.mempool.unlock()

    def _fire_events(
        self, block: Block, block_id: BlockID, resp: FinalizeBlockResponse
    ) -> None:
        """(state/execution.go:337 fireEvents)"""
        if self.event_bus is None:
            return
        self.event_bus.publish_new_block(
            EventDataNewBlock(
                block=block, block_id=block_id, result_finalize_block=resp
            )
        )
        self.event_bus.publish_new_block_header(
            EventDataNewBlockHeader(header=block.header)
        )
        if resp.events:
            self.event_bus.publish_new_block_events(
                block.header.height, resp.events
            )
        for i, tx in enumerate(block.data.txs):
            self.event_bus.publish_tx(
                EventDataTx(
                    height=block.header.height,
                    index=i,
                    tx=tx,
                    result=resp.tx_results[i],
                )
            )
        if resp.validator_updates:
            self.event_bus.publish_validator_set_updates(
                EventDataValidatorSetUpdates(
                    validator_updates=resp.validator_updates
                )
            )


__all__ = [
    "BlockExecutionError",
    "BlockExecutor",
    "InvalidBlockError",
    "build_last_commit_info",
    "extended_commit_info",
    "max_data_bytes",
    "median_time",
    "update_state",
    "validate_block",
]
