"""Evidence pool — detection and lifecycle of byzantine-fault proof
(a copy of cometbft_tpu/evidence/pool.py; reference:
internal/evidence/pool.go:24).

Consensus reports conflicting votes here (pool.go:308
ReportConflictingVotes); peers gossip verified evidence in; the block
proposer reaps pending evidence into blocks (PendingEvidence); once
committed, evidence is marked and pruned when it expires
(pool.go Update).  Verification (verify.go:19) checks the proof
against historical state: validator membership, signature validity,
and the max-age window.

Where the port departs from its reference:
- ``Pool`` takes a keyword ``device`` (``cuda`` unless the caller names
  another; without a card only ``device="cpu"`` runs), on which the
  light-client-attack check verifies the conflicting commit: every
  signature, through the keyed tier of ``types/validation.py``.

As in the reference, its lock is ``utils/sync``'s ``Mutex()`` (the
class ``@guarded``); ``verify`` and ``check_evidence`` note the trust
guard's validators and ``add_evidence`` is a sink.
"""

from __future__ import annotations

import threading
from fractions import Fraction

from cometbft_tpu_torch.state import State
from cometbft_tpu_torch.types import codec, validation
from cometbft_tpu_torch.types.canonical import PRECOMMIT_TYPE, PREVOTE_TYPE
from cometbft_tpu_torch.types.evidence import (
    DuplicateVoteEvidence,
    EvidenceError,
    LightClientAttackEvidence,
)
from cometbft_tpu_torch.types.light_block import SignedHeader
from cometbft_tpu_torch.types.vote import Vote
from cometbft_tpu_torch.utils.db import DB
from cometbft_tpu_torch.utils.env import resolve_device
from cometbft_tpu_torch.utils.flight import FLIGHT
from cometbft_tpu_torch.utils.log import Logger, default_logger
from cometbft_tpu_torch.utils.time import now_ns
from cometbft_tpu_torch.utils import sync as cmtsync
from cometbft_tpu_torch.utils import trustguard

_PREFIX_PENDING = b"evp/"
_PREFIX_COMMITTED = b"evc/"


class EvidenceInvalidError(EvidenceError):
    """Provably bad evidence — the sender is byzantine or buggy."""


class EvidenceExpiredError(EvidenceError):
    """Evidence outside the age window, or referencing state we no
    longer hold — benign (clock/pruning skew), NOT punishable."""


class EvidenceAlreadyCommittedError(EvidenceError):
    pass


def _key(prefix: bytes, height: int, ev_hash: bytes) -> bytes:
    return prefix + height.to_bytes(8, "big") + ev_hash


def _ev_type(ev) -> str:
    """The ``{type}`` label of evidence_pool_detected_total."""
    if isinstance(ev, LightClientAttackEvidence):
        return "light_client_attack"
    return "duplicate_vote"


@cmtsync.guarded
class Pool:
    """(internal/evidence/pool.go:24 Pool)"""

    _GUARDED_BY = {"_consensus_buffer": "_mtx"}

    def __init__(
        self,
        db: DB,
        state_store,
        block_store,
        logger: Logger | None = None,
        metrics=None,
        *,
        device=None,
    ):
        from cometbft_tpu_torch.metrics import EvidenceMetrics

        self.device = resolve_device(device)
        self.db = db
        self.state_store = state_store
        self.block_store = block_store
        self.logger = logger or default_logger().with_fields(module="evidence")
        self.metrics = metrics if metrics is not None else EvidenceMetrics()
        self._mtx = cmtsync.Mutex()
        # conflicting vote pairs reported by consensus, turned into
        # evidence at the next Update when block time/val set are known
        self._consensus_buffer: list[tuple[Vote, Vote]] = []
        self._new_evidence_cond = threading.Condition(self._mtx)
        self._pending_bytes: int | None = None  # cache

    # -- state accessors ------------------------------------------------

    def _current_state(self) -> State:
        return self.state_store.load()

    def _observe_pool_locked(self) -> None:
        """Refresh the size/age gauges (evidence volumes are tiny, so
        the pending scan is cheap; called on add/commit/prune)."""
        count, oldest_ns = 0, None
        for _, raw in self.db.prefix_iterator(_PREFIX_PENDING):
            count += 1
            ev = codec.decode_evidence(bytes(raw))
            if oldest_ns is None or ev.timestamp_ns < oldest_ns:
                oldest_ns = ev.timestamp_ns
        self.metrics.pool_size.set(count)
        self.metrics.oldest_age_seconds.set(
            max(0.0, (now_ns() - oldest_ns) / 1e9)  # deterministic: metrics observation only — never enters state
            if oldest_ns is not None
            else 0.0
        )

    # -- verification (internal/evidence/verify.go:19) -------------------

    def verify(self, ev) -> None:
        """Full verification against historical state; raises on failure."""
        state = self._current_state()
        height, ev_time = state.last_block_height, None

        if isinstance(ev, DuplicateVoteEvidence):
            ev_time = self._verify_duplicate_vote(ev, state)
        elif isinstance(ev, LightClientAttackEvidence):
            ev_time = self._verify_light_client_attack(ev, state)
        else:
            raise EvidenceInvalidError(f"unknown evidence type {type(ev)}")

        # the timestamp field must equal our own header time at the
        # evidence height (verify.go:31-34) — otherwise the committed
        # evidence time is sender-controlled and non-deterministic
        # across proposers.
        if ev.timestamp_ns != ev_time:
            raise EvidenceInvalidError(
                f"evidence time {ev.timestamp_ns} != header time "
                f"{ev_time} at evidence height"
            )

        # age window (verify.go:36-60)
        params = state.consensus_params.evidence
        age_blocks = height - ev.height
        age_ns = state.last_block_time_ns - ev_time
        if (
            age_blocks > params.max_age_num_blocks
            and age_ns > params.max_age_duration_ns
        ):
            raise EvidenceExpiredError(
                f"evidence from height {ev.height} is too old "
                f"({age_blocks} blocks, {age_ns // 1_000_000_000}s)"
            )
        trustguard.note_validated("Pool.verify")

    def _verify_duplicate_vote(
        self, ev: DuplicateVoteEvidence, state: State
    ) -> int:
        """(verify.go:164 VerifyDuplicateVote) — returns evidence time."""
        a, b = ev.vote_a, ev.vote_b
        if a.height != b.height or a.round != b.round or a.type != b.type:
            raise EvidenceInvalidError("votes have different H/R/S")
        if a.validator_address != b.validator_address:
            raise EvidenceInvalidError("votes from different validators")
        if a.block_id.key() == b.block_id.key():
            raise EvidenceInvalidError("votes for the same block")
        if a.type not in (PREVOTE_TYPE, PRECOMMIT_TYPE):
            raise EvidenceInvalidError("invalid vote type")
        ev.validate_basic()

        try:
            val_set = self.state_store.load_validators(ev.height)
        except Exception as exc:  # noqa: BLE001 — pruned/missing state
            raise EvidenceExpiredError(
                f"no validator set for height {ev.height}: {exc}"
            ) from exc
        _, val = val_set.get_by_address(a.validator_address)
        if val is None:
            raise EvidenceInvalidError(
                "validator not in set at evidence height"
            )
        if ev.validator_power != val.voting_power:
            raise EvidenceInvalidError("validator power mismatch")
        if ev.total_voting_power != val_set.total_voting_power():
            raise EvidenceInvalidError("total voting power mismatch")

        chain_id = state.chain_id
        for vote in (a, b):
            if not val.pub_key.verify_signature(
                vote.sign_bytes(chain_id), vote.signature
            ):
                raise EvidenceInvalidError("invalid vote signature")
        # evidence time = block time at that height (pool.go:308); a
        # missing header means we cannot pin the time, and trusting the
        # sender's field would let stale evidence evade the age window
        # (verify.go "don't have header at height").
        meta = self.block_store.load_block_meta(ev.height)
        if meta is None:
            raise EvidenceExpiredError(
                f"no header at evidence height {ev.height}"
            )
        return meta.header.time_ns

    def _load_signed_header(self, height: int):
        """Our chain's SignedHeader at ``height`` (verify.go:264
        getSignedHeader)."""
        meta = self.block_store.load_block_meta(height)
        commit = self.block_store.load_block_commit(height)
        if commit is None:
            # at the chain tip the +2/3 commit is only known locally
            commit = self.block_store.load_seen_commit(height)
        if meta is None or commit is None:
            return None
        return SignedHeader(header=meta.header, commit=commit)

    def _verify_light_client_attack(
        self, ev: LightClientAttackEvidence, state: State
    ) -> int:
        """(verify.go:110 VerifyLightClientAttack) — the conflicting
        commit must carry real signatures: +1/3 of the common set's
        power in the lunatic case (trusting verification), and +2/3 of
        the conflicting set itself, all signatures checked; the listed
        byzantine validators must match the actual signers."""
        cb = ev.conflicting_block
        if cb is None or cb.commit is None or not cb.commit.signatures:
            raise EvidenceInvalidError("missing conflicting block/commit")
        if ev.common_height <= 0:
            raise EvidenceInvalidError("non-positive common height")
        if ev.common_height > state.last_block_height:
            raise EvidenceInvalidError("common height in the future")
        if ev.common_height > cb.height:
            raise EvidenceInvalidError(
                "common height above conflicting block height"
            )

        common_header = self._load_signed_header(ev.common_height)
        if common_header is None:
            raise EvidenceExpiredError(
                f"no header at common height {ev.common_height}"
            )
        try:
            common_vals = self.state_store.load_validators(ev.common_height)
        except Exception as exc:  # noqa: BLE001 — pruned/missing state
            raise EvidenceExpiredError(
                f"no validator set for height {ev.common_height}: {exc}"
            ) from exc
        chain_id = state.chain_id

        # Trusted header at the conflicting height; in a forward lunatic
        # attack we don't have one yet and fall back to our latest.
        trusted = common_header
        if ev.common_height != cb.height:
            trusted = self._load_signed_header(cb.height)
            if trusted is None:
                trusted = self._load_signed_header(self.block_store.height())
                if trusted is None:
                    raise EvidenceExpiredError("no trusted header available")
                if trusted.header.time_ns < cb.time_ns:
                    raise EvidenceInvalidError(
                        "latest block time is before conflicting block time"
                    )
            # lunatic: one verification jump from the common set, every
            # signature checked (VerifyCommitLightTrustingAllSignatures)
            try:
                validation.verify_commit_light_trusting(
                    chain_id,
                    common_vals,
                    cb.commit,
                    trust_level=Fraction(1, 3),
                    count_all=True,
                    device=self.device,
                )
            except validation.CommitError as exc:
                raise EvidenceInvalidError(
                    f"conflicting commit not signed by +1/3 of the "
                    f"common validator set: {exc}"
                ) from exc
        elif ev.conflicting_header_is_invalid(trusted.header):
            raise EvidenceInvalidError(
                "common height equals conflicting height, so the "
                "conflicting header must be correctly derived"
            )

        # +2/3 of the conflicting block's own validator set, all
        # signatures checked (VerifyCommitLightAllSignatures).
        if cb.validator_set is None or len(cb.validator_set) == 0:
            raise EvidenceInvalidError("missing conflicting validator set")
        if cb.header.validators_hash != cb.validator_set.hash():
            raise EvidenceInvalidError(
                "conflicting validator set does not match its header"
            )
        try:
            validation.verify_commit_light(
                chain_id,
                cb.validator_set,
                cb.commit.block_id,
                cb.height,
                cb.commit,
                count_all=True,
                device=self.device,
            )
        except validation.CommitError as exc:
            raise EvidenceInvalidError(
                f"invalid commit from conflicting block: {exc}"
            ) from exc
        if cb.commit.block_id.hash != cb.hash():
            raise EvidenceInvalidError(
                "conflicting commit signs a different header"
            )

        if ev.total_voting_power != common_vals.total_voting_power():
            raise EvidenceInvalidError("total voting power mismatch")

        # forward lunatic must violate monotonically increasing time;
        # otherwise the conflicting header must actually differ.
        if cb.height > trusted.header.height:
            if cb.time_ns > trusted.header.time_ns:
                raise EvidenceInvalidError(
                    "conflicting block doesn't violate monotonic time"
                )
        elif trusted.hash() == cb.hash():
            raise EvidenceInvalidError(
                "conflicting header matches our own header"
            )

        # byzantine validators must be derived from the actual
        # conflicting signatures, not the sender's say-so.
        expected = ev.get_byzantine_validators(common_vals, trusted)
        if tuple(v.address for v in expected) != tuple(
            ev.byzantine_validators
        ):
            raise EvidenceInvalidError(
                "byzantine validator list does not match the "
                "conflicting commit's signers"
            )

        return common_header.header.time_ns

    # -- ingestion -------------------------------------------------------

    def add_evidence(self, ev) -> None:
        """Verify + persist pending evidence (pool.go:137 AddEvidence).
        Idempotent for known evidence."""
        with self._mtx:
            if self._is_pending(ev) or self._is_committed(ev):
                return
        self.verify(ev)
        trustguard.check_sink("evidence.add")
        with self._mtx:
            self._add_pending_locked(ev)
            self._observe_pool_locked()
            self._new_evidence_cond.notify_all()
        self.metrics.pool_detected_total.labels(type=_ev_type(ev)).inc()
        FLIGHT.record(
            "evidence_added", height=ev.height,
            hash=ev.hash().hex()[:12],
        )
        self.logger.info(
            "verified new evidence", height=ev.height,
            hash=ev.hash().hex()[:12],
        )

    def report_conflicting_votes(self, vote_a: Vote, vote_b: Vote) -> None:
        """(pool.go:308 ReportConflictingVotes) — buffered until Update
        provides the block time + validator set."""
        with self._mtx:
            self._consensus_buffer.append((vote_a, vote_b))

    # -- block production / validation -----------------------------------

    def pending_evidence(self, max_bytes: int) -> tuple[list, int]:
        """(pool.go:96 PendingEvidence)"""
        out, size = [], 0
        with self._mtx:
            for _, raw in self.db.prefix_iterator(_PREFIX_PENDING):
                ev = codec.decode_evidence(bytes(raw))
                ev_size = len(raw)
                if max_bytes >= 0 and size + ev_size > max_bytes:
                    break
                out.append(ev)
                size += ev_size
        return out, size

    def check_evidence(self, ev_list) -> None:
        """Validate all evidence in a proposed block (pool.go:184
        CheckEvidence): no duplicates within the block, nothing already
        committed, everything verifiable."""
        seen = set()
        for ev in ev_list:
            h = ev.hash()
            if h in seen:
                raise EvidenceInvalidError("duplicate evidence in block")
            seen.add(h)
            with self._mtx:
                if self._is_committed(ev):
                    raise EvidenceAlreadyCommittedError(
                        "evidence already committed"
                    )
                pending = self._is_pending(ev)
            if not pending:
                self.verify(ev)
        trustguard.note_validated("Pool.check_evidence")

    # -- post-commit update ----------------------------------------------

    def update(self, state: State, ev_list) -> None:
        """(pool.go:110 Update) — mark committed, materialize reported
        conflicts, prune expired."""
        with self._mtx:
            for ev in ev_list:
                if not self._is_committed(ev):
                    self.metrics.committed_total.inc()
                self._mark_committed_locked(ev)
        self._process_consensus_buffer(state)
        self._prune_expired(state)
        with self._mtx:
            self._observe_pool_locked()

    def _process_consensus_buffer(self, state: State) -> None:
        """(pool.go:271 processConsensusBuffer)"""
        with self._mtx:
            buf, self._consensus_buffer = self._consensus_buffer, []
        for vote_a, vote_b in buf:
            try:
                val_set = self.state_store.load_validators(vote_a.height)
                # evidence time = our header time at the vote height
                # (pool.go:271 processConsensusBuffer), so every honest
                # proposer derives the identical evidence bytes. Without
                # the header we must not guess: peers pin the timestamp
                # to their own header and would reject ours.
                meta = self.block_store.load_block_meta(vote_a.height)
                if meta is None:
                    self.logger.error(
                        "failed to make evidence: no block meta",
                        height=vote_a.height,
                    )
                    continue
                ev = DuplicateVoteEvidence.from_votes(
                    vote_a, vote_b, meta.header.time_ns, val_set
                )
            except Exception as exc:  # noqa: BLE001
                self.logger.error("failed to make evidence", err=repr(exc))
                continue
            with self._mtx:
                if self._is_pending(ev) or self._is_committed(ev):
                    continue
                # no gauge refresh here: the sole caller (update) runs
                # _observe_pool_locked once after the buffer drains
                self._add_pending_locked(ev)
                self._new_evidence_cond.notify_all()
            self.metrics.pool_detected_total.labels(
                type="duplicate_vote"
            ).inc()
            self.logger.info(
                "duplicate vote evidence created",
                height=ev.height,
                validator=ev.vote_a.validator_address.hex()[:12],
            )

    def _prune_expired(self, state: State) -> None:
        params = state.consensus_params.evidence
        height = state.last_block_height
        # expiry is judged in BLOCK time, never host time: every node
        # prunes the same evidence at the same height, and replay
        # reconstructs the same pool (determcheck; evidence.go uses
        # state.LastBlockTime the same way).  Pre-genesis (time 0)
        # nothing can expire.
        now = state.last_block_time_ns
        if now == 0:
            return
        drop = []
        with self._mtx:
            for key, raw in self.db.prefix_iterator(_PREFIX_PENDING):
                ev = codec.decode_evidence(bytes(raw))
                if (
                    height - ev.height > params.max_age_num_blocks
                    and now - ev.timestamp_ns > params.max_age_duration_ns
                ):
                    drop.append(key)
            # committed markers only matter within the age window — once
            # expired evidence can no longer enter a block, drop them
            # too.  Expiry needs BOTH block age and duration exceeded
            # (same rule as verify/pending pruning), otherwise a marker
            # could vanish while its evidence is still admissible and
            # the same evidence committed twice.
            for key, raw in self.db.prefix_iterator(_PREFIX_COMMITTED):
                ev_height = int.from_bytes(
                    key[len(_PREFIX_COMMITTED):len(_PREFIX_COMMITTED) + 8],
                    "big",
                )
                ev_time = (
                    int.from_bytes(raw[:8], "big") if len(raw) >= 8 else 0
                )
                if (
                    height - ev_height > params.max_age_num_blocks
                    and now - ev_time > params.max_age_duration_ns
                ):
                    drop.append(key)
            for key in drop:
                self.db.delete(key)

    # -- storage helpers -------------------------------------------------

    def _add_pending_locked(self, ev) -> None:
        self.db.set(
            _key(_PREFIX_PENDING, ev.height, ev.hash()),
            codec.encode_evidence(ev),
        )

    def _is_pending(self, ev) -> bool:
        return self.db.has(_key(_PREFIX_PENDING, ev.height, ev.hash()))

    def _is_committed(self, ev) -> bool:
        return self.db.has(_key(_PREFIX_COMMITTED, ev.height, ev.hash()))

    def _mark_committed_locked(self, ev) -> None:
        self.db.delete(_key(_PREFIX_PENDING, ev.height, ev.hash()))
        # marker value = evidence time, so expiry can apply the
        # duration condition as well as the block-age one
        meta = self.block_store.load_block_meta(ev.height)
        ev_time = meta.header.time_ns if meta is not None else ev.timestamp_ns
        self.db.set(
            _key(_PREFIX_COMMITTED, ev.height, ev.hash()),
            max(ev_time, 0).to_bytes(8, "big"),
        )

    # -- reactor support -------------------------------------------------

    def wait_for_evidence(self, timeout: float) -> bool:
        with self._mtx:
            return self._new_evidence_cond.wait(timeout)

    def size(self) -> int:
        with self._mtx:
            return sum(1 for _ in self.db.prefix_iterator(_PREFIX_PENDING))


__all__ = [
    "Pool",
    "EvidenceExpiredError",
    "EvidenceInvalidError",
    "EvidenceAlreadyCommittedError",
]
