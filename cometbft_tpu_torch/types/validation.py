"""Commit verification — the north-star hot path (a copy of
cometbft_tpu/types/validation.py; reference types/validation.go).

All block/light-client/evidence verification funnels here, and from
here into the BatchVerifier seam, i.e. onto the card:

  VerifyCommit              every applied block (state/validation.go:94)
  VerifyCommitLight         blocksync replay (internal/blocksync/reactor.go:550)
  VerifyCommitLightTrusting light client (light/verifier.go:56)

Design difference from the reference: its batch path gets only a single
ok/fail bit from the RLC batch equation and must re-verify sequentially
to find the offender (types/validation.go:310); the data-parallel device
kernel returns per-signature validity, so the invalid index is free.

Where the port departs from its reference:

- every public function takes a keyword ``device`` and hands it to
  ``crypto.batch.create_batch_verifier``: ``cuda`` unless the caller
  passes another (``device="cpu"`` on a machine without a card); the
  reference's factory picks a host verifier when no device is probed;
- a commit that carries a BLS aggregate (``Commit.agg_signature``) raises
  :class:`BlsTierUnavailable` before any signature is checked: the port
  has no BLS tier (the reference's ``crypto/bls_dispatch``), so it keeps
  none of the reference's aggregate-signer bookkeeping either
  (``signer_vals``);
- the group lock is ``utils/sync``'s ``Mutex()`` and the three
  ``verify_commit*`` functions note the trust guard's validators, as in
  the reference.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from fractions import Fraction

from cometbft_tpu_torch.crypto import batch as crypto_batch
from cometbft_tpu_torch.crypto import verify_queue as _vq
from cometbft_tpu_torch.types.block import BlockID, Commit
from cometbft_tpu_torch.types.validator import ValidatorSet
from cometbft_tpu_torch.utils.flight import FLIGHT
from cometbft_tpu_torch.utils.trace import TRACER as _tracer
from cometbft_tpu_torch.utils import sync as cmtsync
from cometbft_tpu_torch.utils import trustguard


class CommitError(Exception):
    pass


class InvalidCommitHeight(CommitError):
    pass


class InvalidCommitSignatures(CommitError):
    pass


class NotEnoughVotingPower(CommitError):
    pass


class BlsTierUnavailable(NotImplementedError):
    """The commit carries a BLS aggregate signature and the port has no
    BLS tier to check it.  Not a ``CommitError``: it says nothing about
    the commit's validity."""


@dataclass
class _Entry:
    idx: int
    val_idx: int
    power: int
    counts: bool  # counts toward the tallied (for-block) power


def _check_dims(vals: ValidatorSet, commit: Commit, height: int, block_id: BlockID):
    if vals is None or commit is None:
        raise CommitError("nil validator set or commit")
    if height != commit.height:
        raise InvalidCommitHeight(
            f"commit height {commit.height}, expected {height}"
        )
    if block_id != commit.block_id:
        raise InvalidCommitSignatures(
            f"commit for wrong block id {commit.block_id}"
        )


def _batch_groups(entries: list[_Entry], vals) -> list[list[_Entry]]:
    """Group entries by pubkey type for the crypto pass.

    The reference batches only when the whole commit shares one
    batch-capable key type and otherwise verifies serially
    (validation.go:15 shouldBatchVerify); grouping instead means a
    mixed ed25519+bls12381 commit still gets ONE device launch for
    its ed25519 votes and ONE multi-pairing for its BLS votes — the
    BASELINE mega-commit shape."""
    groups: dict[str, list[_Entry]] = {}
    for e in entries:
        groups.setdefault(
            vals.get_by_index(e.val_idx).pub_key.type(), []
        ).append(e)
    return list(groups.values())


def _verify(
    chain_id: str,
    vals: ValidatorSet,
    commit: Commit,
    voting_power_needed: int,
    count_sig,
    count_all: bool,
    lookup_by_address: bool,
    device=None,
) -> None:
    """Shared engine for the three verification modes
    (validation.go:160 verifyBasicValsAndCommit + verifyCommitBatch).

    count_sig(cs) decides which signatures are cryptographically checked;
    tallied power only ever counts BlockIDFlagCommit votes. count_all
    keeps verifying past the threshold (VerifyCommit) or stops early
    (the Light variants).

    When the commit carries ``agg_signature`` (types/block.py), the
    reference proves the covered COMMIT-flag votes (those with no
    signature of their own) by ONE BLS pairing-product check.  The
    port refuses such a commit up front: with no covered vote it is
    malformed (the reference's verdict), else it raises
    :class:`BlsTierUnavailable` and verifies nothing.

    ``device`` is where a batch of two or more signatures is verified
    (``create_batch_verifier(pk, device=device)``).
    """
    if not lookup_by_address and len(vals) != commit.size():
        raise InvalidCommitSignatures(
            f"validator set size {len(vals)} != commit size {commit.size()}"
        )

    if commit.agg_signature:
        covered = sum(
            1 for cs in commit.signatures
            if cs.is_commit() and not cs.signature
        )
        if not covered:
            raise InvalidCommitSignatures(
                "aggregate signature with no aggregated signatures"
            )
        # the reference verifies the aggregate beside the groups
        # (crypto/bls_dispatch.BlsLadderVerifier); nothing is verified
        # in its place, so no verdict is given
        raise BlsTierUnavailable(
            f"commit at height {commit.height} carries a BLS aggregate "
            f"signature over {covered} signatures: the port has no BLS "
            "tier (crypto/bls_dispatch) to verify it"
        )

    entries: list[_Entry] = []
    tallied = 0
    counted_power = 0
    seen_addrs: set[bytes] = set()
    for idx, cs in enumerate(commit.signatures):
        if not count_sig(cs):
            continue
        if lookup_by_address:
            val_idx, val = vals.get_by_address(cs.validator_address)
            if val_idx < 0:
                continue
            if cs.validator_address in seen_addrs:
                raise InvalidCommitSignatures(
                    "double vote by validator in trusting verification"
                )
            seen_addrs.add(cs.validator_address)
        else:
            val_idx, val = idx, vals.get_by_index(idx)
            if val is None:
                raise InvalidCommitSignatures(f"no validator at index {idx}")
            if val.address != cs.validator_address:
                raise InvalidCommitSignatures(
                    f"signature {idx} address mismatch"
                )
        entries.append(
            _Entry(idx, val_idx, val.voting_power, cs.is_commit())
        )
        if cs.is_commit():
            counted_power += val.voting_power
        # early-break path: stop collecting once the counted power
        # passes the threshold (validation.go:290)
        if not count_all and counted_power > voting_power_needed:
            break

    # crypto pass — one batch launch per key type in the commit; with
    # multiple key types the groups run CONCURRENTLY (the device kernel
    # waits on device compute and the native BLS library releases the
    # GIL, so a mixed mega-commit costs max(ed25519, bls) not the sum).
    # When the verify queue is live (crypto/verify_queue.py), each
    # signature consults the speculative-result cache first: votes the
    # queue already verified on receipt (VoteSet.add_vote) or via
    # blocksync prefetch skip the launch entirely — a fully speculated
    # commit performs ZERO new launches.  Fall-back is strict: cache
    # misses run the exact batch/serial verify below.
    spec_mtx = cmtsync.Mutex()
    spec = {"hits": 0, "misses": 0, "tier": None}
    # serving-plane lane (crypto/verify_queue.submission_lane):
    # captured ONCE here because groups may run on executor threads
    # where the caller's thread-local is invisible
    lane = _vq.active_submission_lane()

    def _verify_group(group) -> None:
        pks = [vals.get_by_index(e.val_idx).pub_key for e in group]
        sbs = [commit.vote_sign_bytes(chain_id, e.idx) for e in group]
        pending = list(range(len(group)))
        keys: list[bytes] | None = None
        if _vq.speculation_active():
            # only POSITIVE verdicts are ever cached (verify_queue
            # stores proofs of validity), so a hit is a signature that
            # skips its launch and anything else re-verifies below —
            # a transient mis-verify can never stick.  The SHA-512
            # prehash is computed ONCE per signature and reused by the
            # record_result below — on a cold 10k-sig commit the
            # consult-then-record shape would otherwise hash twice.
            keys = [
                _vq.cache_key(
                    pks[i].bytes(), sbs[i],
                    commit.signatures[e.idx].signature,
                )
                for i, e in enumerate(group)
            ]
            pending = []
            hits = 0
            for i, e in enumerate(group):
                if _vq.cached_result(
                    pks[i].bytes(), sbs[i],
                    commit.signatures[e.idx].signature,
                    key=keys[i],
                ) is True:
                    hits += 1
                else:
                    pending.append(i)
            with spec_mtx:
                spec["hits"] += hits
                spec["misses"] += len(pending)
            if not pending:
                return
        if lane is not None and _vq.speculation_active():
            # serving-plane route: the pending signatures ride the
            # verify queue's lane (the light_client micro-batcher
            # coalesces CONCURRENT header syncs into single ladder
            # launches); verify_or_fallback keeps the strict sync
            # fallback and the launcher feeds the speculative cache,
            # so this branch never weakens the verdict
            items = [
                (
                    pks[i], sbs[i],
                    commit.signatures[group[i].idx].signature,
                )
                for i in pending
            ]
            results = _vq.verify_or_fallback(items, priority=lane)
            with spec_mtx:
                spec["tier"] = spec["tier"] or f"lane:{lane}"
            bad = next(
                (j for j, r in enumerate(results) if not r), None
            )
            if bad is not None:
                raise InvalidCommitSignatures(
                    f"wrong signature (#{group[pending[bad]].idx})"
                )
            return
        pk0 = pks[pending[0]]
        verifier = None
        if len(pending) >= 2 and crypto_batch.supports_batch_verifier(
            pk0
        ):
            verifier = crypto_batch.create_batch_verifier(pk0, device=device)
        if verifier is not None:
            for i in pending:
                verifier.add(
                    pks[i], sbs[i],
                    commit.signatures[group[i].idx].signature,
                )
            ok, results = verifier.verify()
            tier = getattr(verifier, "last_tier", None)
            with spec_mtx:
                spec["tier"] = tier or spec["tier"] or "host"
            if _vq.speculation_active():
                # repeat verifications of this commit (evidence
                # re-checks, light-client retries) become cache hits
                for i, r in zip(pending, results):
                    _vq.record_result(
                        pks[i].bytes(), sbs[i],
                        commit.signatures[group[i].idx].signature,
                        bool(r),
                        key=keys[i] if keys is not None else None,
                    )
            if not ok:
                bad = next(j for j, r in enumerate(results) if not r)
                raise InvalidCommitSignatures(
                    f"wrong signature (#{group[pending[bad]].idx})"
                )
        else:
            # per-signature host fallback (secp256k1 and other key
            # types without a batch verifier, 1-sig groups): still ONE
            # ladder accounting sample at the decision point, so
            # crypto_dispatch_tier covers every verify in the process
            # — a raising (invalid) signature is a verdict the host
            # tier produced correctly, not a tier failure.  In the port
            # verify_signature is the big-int oracle (crypto/edwards.py)
            from cometbft_tpu_torch.crypto.dispatch import LADDER as _ladder

            # deliberately NO batch/seconds here: this rung verifies
            # whatever key type fell through (secp256k1, 1-sig
            # groups) — timing it would pollute the host tier's
            # ed25519 cost estimates with unrelated crypto
            _ladder.note_batch("host")
            with spec_mtx:
                spec["tier"] = spec["tier"] or "host"
            for i in pending:
                sig = commit.signatures[group[i].idx].signature
                ok1 = pks[i].verify_signature(sbs[i], sig)
                if _vq.speculation_active():
                    _vq.record_result(
                        pks[i].bytes(), sbs[i], sig, ok1,
                        key=keys[i] if keys is not None else None,
                    )
                if not ok1:
                    raise InvalidCommitSignatures(
                        f"wrong signature (#{group[i].idx})"
                    )

    groups = _batch_groups(entries, vals)
    # one task per key-type group — with several, they run CONCURRENTLY
    # (the device kernel waits on device compute)
    tasks = [lambda g=g: _verify_group(g) for g in groups]
    with _tracer.span(
        "verify_commit", cat="crypto",
        height=commit.height, sigs=len(entries), groups=len(tasks),
    ) as sp:
        speculating = _vq.speculation_active()
        try:
            if len(tasks) <= 1:
                for task in tasks:
                    task()
            else:
                import concurrent.futures as _futures

                with _futures.ThreadPoolExecutor(len(tasks)) as pool:
                    futs = [pool.submit(t) for t in tasks]
                    for f in futs:
                        f.result()  # re-raises InvalidCommitSignatures
        finally:
            if speculating:
                # tier tells the flight tail whether a slow commit came
                # from a cold queue (misses ran on a real tier) or a
                # warm one (all hits -> "speculative", no launch)
                tier = (
                    "speculative" if spec["misses"] == 0
                    else (spec["tier"] or "host")
                )
                sp.set(
                    spec_hits=spec["hits"], spec_misses=spec["misses"],
                    tier=tier,
                )
                FLIGHT.record(
                    "consensus/speculative_verify",
                    height=commit.height, sigs=len(entries),
                    hits=spec["hits"], misses=spec["misses"], tier=tier,
                )

    for e in entries:
        if e.counts:
            tallied += e.power
    if tallied <= voting_power_needed:
        raise NotEnoughVotingPower(
            f"tallied {tallied} <= needed {voting_power_needed}"
        )


def verify_commit(
    chain_id: str,
    vals: ValidatorSet,
    block_id: BlockID,
    height: int,
    commit: Commit,
    *,
    device=None,
) -> None:
    """Full verification: every signature (commit and nil votes) checked,
    +2/3 of total power must have signed the block (validation.go:28).
    ``device``: where the batch runs (``cuda`` unless given)."""
    _check_dims(vals, commit, height, block_id)
    needed = vals.total_voting_power() * 2 // 3
    _verify(
        chain_id,
        vals,
        commit,
        needed,
        count_sig=lambda cs: not cs.is_absent(),
        count_all=True,
        lookup_by_address=False,
        device=device,
    )
    trustguard.note_validated("verify_commit")


def verify_commit_light(
    chain_id: str,
    vals: ValidatorSet,
    block_id: BlockID,
    height: int,
    commit: Commit,
    count_all: bool = False,
    *,
    device=None,
) -> None:
    """Verify only until +2/3 is reached; nil votes skipped
    (validation.go:63).  ``count_all=True`` checks every commit
    signature with no early break (VerifyCommitLightAllSignatures),
    required when the commit is used as evidence — nil votes are still
    skipped, so a garbage nil entry can't poison otherwise-valid
    evidence."""
    _check_dims(vals, commit, height, block_id)
    needed = vals.total_voting_power() * 2 // 3
    _verify(
        chain_id,
        vals,
        commit,
        needed,
        count_sig=lambda cs: cs.is_commit(),
        count_all=count_all,
        lookup_by_address=False,
        device=device,
    )
    trustguard.note_validated("verify_commit_light")


def check_trust_level(trust_level: Fraction) -> None:
    """ValueError unless the trust level is in (0, 1] (validation.go:129);
    the light verifier calls it apart, so that the only ``ValueError`` it
    turns into a verdict is this one."""
    if trust_level.denominator == 0:
        raise ValueError("trust level has zero denominator")
    if not (0 < trust_level <= 1):
        raise ValueError(f"trust level must be in (0, 1], got {trust_level}")


def verify_commit_light_trusting(
    chain_id: str,
    vals: ValidatorSet,
    commit: Commit,
    trust_level: Fraction = Fraction(1, 3),
    count_all: bool = False,
    *,
    device=None,
) -> None:
    """Light-client trusting verification: signatures matched by address
    against the *trusted* set; needs > trust_level of its power
    (validation.go:129).  ``count_all=True`` checks every signature with
    no early break (VerifyCommitLightTrustingAllSignatures), required
    when the commit is used as evidence.  The reference's
    ``signer_vals`` (aggregate signers outside the trusted set) goes
    with its BLS tier (module docstring)."""
    check_trust_level(trust_level)
    needed = (
        vals.total_voting_power() * trust_level.numerator
    ) // trust_level.denominator
    _verify(
        chain_id,
        vals,
        commit,
        needed,
        count_sig=lambda cs: cs.is_commit(),
        count_all=count_all,
        lookup_by_address=True,
        device=device,
    )
    trustguard.note_validated("verify_commit_light_trusting")
