"""Light client (a copy of cometbft_tpu/light/client.py; reference:
light/client.go:133).

Verifies headers against a trusted root using sequential or skipping
(bisection) verification, cross-checks every newly verified header
against witness providers (fork detection, light/detector.go), and
persists trusted blocks.  The 10k-header verification benchmark
(BASELINE.json) exercises this plane's batch-verify calls.

Where the port departs from its reference:
- ``Client`` takes a keyword ``device`` (``cuda`` unless the caller
  names another; without a card only ``device="cpu"`` runs) and passes
  it to every header check, as the light verifier's entries take it;
- ``_compare_with_witnesses`` skips a witness, and ignores a failed
  evidence report, only on a ``ProviderError`` (``LightBlockNotFoundError``
  among them); the reference catches every exception there, so a kernel
  or build fault would read as a witness that is down.  In the port it
  reaches the caller.
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction

from cometbft_tpu_torch.light.provider import Provider, ProviderError
from cometbft_tpu_torch.light.store import LightStore
from cometbft_tpu_torch.light.verifier import (
    DEFAULT_TRUST_LEVEL,
    ErrNewValSetCantBeTrusted,
    VerificationError,
    _verify_self_commit,
    verify as _verify,
    verify_adjacent,
)
from cometbft_tpu_torch.types.evidence import LightClientAttackEvidence
from cometbft_tpu_torch.types.light_block import LightBlock
from cometbft_tpu_torch.utils.env import resolve_device
from cometbft_tpu_torch.utils.log import Logger, default_logger
from cometbft_tpu_torch.utils.time import now_ns
from cometbft_tpu_torch.utils import sync as cmtsync

SEQUENTIAL = "sequential"   # client.go:44
SKIPPING = "skipping"       # client.go:50

DEFAULT_PRUNING_SIZE = 1000  # client.go:60
DEFAULT_MAX_CLOCK_DRIFT_NS = 10 * 10**9


class LightClientError(Exception):
    pass


class ErrLightClientAttack(LightClientError):
    """(light/errors.go ErrLightClientAttack) — divergence between the
    primary and a witness was detected and evidence submitted."""


class NoWitnessesError(LightClientError):
    pass


@dataclass(frozen=True)
class TrustOptions:
    """(light/client.go:77 TrustOptions) — the subjective root of trust."""

    period_ns: int
    height: int
    hash: bytes

    def validate(self) -> None:
        if self.period_ns <= 0:
            raise LightClientError("trusting period must be positive")
        if self.height <= 0:
            raise LightClientError("trust height must be positive")
        if len(self.hash) != 32:
            raise LightClientError("trust hash must be 32 bytes")


class Client:
    """(light/client.go:133 Client)"""

    def __init__(
        self,
        chain_id: str,
        trust_options: TrustOptions | None,
        primary: Provider,
        witnesses: list[Provider],
        trusted_store: LightStore,
        verification_mode: str = SKIPPING,
        trust_level: Fraction = DEFAULT_TRUST_LEVEL,
        trust_period_ns: int = 7 * 24 * 3600 * 1_000_000_000,
        max_clock_drift_ns: int = DEFAULT_MAX_CLOCK_DRIFT_NS,
        pruning_size: int = DEFAULT_PRUNING_SIZE,
        logger: Logger | None = None,
        *,
        device=None,
    ):
        if trust_options is not None:
            trust_options.validate()
        self.chain_id = chain_id
        self.trust_options = trust_options
        # the trusting period outlives the root of trust: resume mode
        # (trust_options=None, NewClientFromTrustedStore) still expires
        # stored headers against it
        self.trust_period_ns = (
            trust_options.period_ns if trust_options is not None
            else trust_period_ns
        )
        self.primary = primary
        self.witnesses = list(witnesses)
        self.store = trusted_store
        self.mode = verification_mode
        self.trust_level = trust_level
        self.max_clock_drift_ns = max_clock_drift_ns
        self.pruning_size = pruning_size
        self.logger = logger or default_logger().with_fields(module="light")
        self._mtx = cmtsync.Mutex()
        self.device = resolve_device(device)
        self._initialize()

    # -- initialization (client.go:265 initializeWithTrustOptions) -------

    def _initialize(self) -> None:
        existing = self.store.latest()
        if existing is not None:
            return  # already have a trust root (client.go checkTrustedHeaderUsingOptions simplified: keep store)
        if self.trust_options is None:
            # NewClientFromTrustedStore semantics (light/client.go:233,
            # cmd light.go:189 "continue from latest state"): without a
            # root of trust there is nothing subjective to anchor to
            raise LightClientError(
                "trusted store is empty and no trust options given "
                "(supply --trusted-height/--trusted-hash on first run)"
            )
        lb = self.primary.light_block(self.trust_options.height)
        lb.validate_basic(self.chain_id)
        if lb.hash() != self.trust_options.hash:
            raise LightClientError(
                f"primary's header hash {lb.hash().hex()[:12]} != "
                f"trust hash {self.trust_options.hash.hex()[:12]}"
            )
        # +2/3 of ITS validator set signed it
        _verify_self_commit(lb, self.chain_id, self.device)
        self._compare_with_witnesses(lb)
        self.store.save(lb)

    # -- public API -------------------------------------------------------

    def trusted_light_block(self, height: int) -> LightBlock | None:
        return self.store.get(height)

    def latest_trusted(self) -> LightBlock | None:
        return self.store.latest()

    def update(self, now: int | None = None) -> LightBlock | None:
        """Verify the primary's latest header (client.go:486 Update)."""
        latest = self.primary.light_block(0)
        trusted = self.store.latest()
        if trusted is not None and latest.height <= trusted.height:
            return None
        return self.verify_light_block_at_height(latest.height, now)

    def verify_light_block_at_height(
        self, height: int, now: int | None = None
    ) -> LightBlock:
        """(client.go:473 VerifyLightBlockAtHeight)"""
        if height <= 0:
            raise LightClientError("height must be positive")
        now = now_ns() if now is None else now
        with self._mtx:
            existing = self.store.get(height)
            if existing is not None:
                return existing
            lb = self.primary.light_block(height)
            lb.validate_basic(self.chain_id)
            if lb.height != height:
                raise LightClientError(
                    f"primary returned height {lb.height}, wanted {height}"
                )
            self._verify_light_block(lb, now)
            return lb

    def verify_header(self, header, now: int | None = None) -> LightBlock:
        """Verify a caller-supplied header by fetching its light block
        (client.go:520 VerifyHeader)."""
        lb = self.verify_light_block_at_height(header.height, now)
        if lb.hash() != header.hash():
            raise LightClientError(
                "header differs from the verified header at that height"
            )
        return lb

    # -- verification strategies -----------------------------------------

    def _verify_light_block(self, new: LightBlock, now: int) -> None:
        trusted = self.store.light_block_before(new.height)
        if trusted is None:
            # target below our first trusted block: backwards verification
            first = self.store.first()
            if first is None:
                raise LightClientError("store has no trust root")
            self._verify_backwards(first, new)
            self._finalize_verified(new)
            return
        if self.mode == SEQUENTIAL:
            self._verify_sequential(trusted, new, now)
        else:
            self._verify_skipping(trusted, new, now)
        self._finalize_verified(new)

    def _finalize_verified(self, new: LightBlock) -> None:
        self._compare_with_witnesses(new)
        self.store.save(new)
        if self.store.size() > self.pruning_size:
            self.store.prune(self.pruning_size)

    def _verify_sequential(
        self, trusted: LightBlock, new: LightBlock, now: int
    ) -> None:
        """(client.go:612 verifySequential) — fetch and verify every
        intermediate header."""
        current = trusted
        for h in range(trusted.height + 1, new.height + 1):
            nxt = (
                new if h == new.height else self.primary.light_block(h)
            )
            nxt.validate_basic(self.chain_id)
            verify_adjacent(
                current, nxt, self.chain_id,
                self.trust_period_ns, now,
                self.max_clock_drift_ns,
                device=self.device,
            )
            if h != new.height:
                self.store.save(nxt)
            current = nxt

    def _verify_skipping(
        self, trusted: LightBlock, new: LightBlock, now: int
    ) -> None:
        """(client.go:705 verifySkipping) — bisection: try the jump; on
        insufficient trusted power, verify the midpoint first."""
        verified = [trusted]
        pending = [new]
        depth_guard = 0
        while pending:
            depth_guard += 1
            if depth_guard > 10_000:
                raise LightClientError("bisection did not converge")
            base = verified[-1]
            target = pending[-1]
            try:
                _verify(
                    base, target, self.chain_id,
                    self.trust_period_ns, now,
                    self.trust_level, self.max_clock_drift_ns,
                    device=self.device,
                )
                verified.append(target)
                pending.pop()
                if target.height != new.height:
                    self.store.save(target)
            except ErrNewValSetCantBeTrusted:
                pivot = (base.height + target.height) // 2
                if pivot in (base.height, target.height):
                    raise LightClientError(
                        "cannot bisect further — chain not verifiable "
                        "within the trusting period"
                    ) from None
                mid = self.primary.light_block(pivot)
                mid.validate_basic(self.chain_id)
                pending.append(mid)

    def _verify_backwards(self, trusted: LightBlock, new: LightBlock) -> None:
        """(client.go:790 backwards) — hash-link each header back from
        the trusted block to the target."""
        current = trusted
        for h in range(trusted.height - 1, new.height - 1, -1):
            prev = new if h == new.height else self.primary.light_block(h)
            prev.validate_basic(self.chain_id)
            if current.header.last_block_id.hash != prev.hash():
                raise VerificationError(
                    f"header {h} does not hash-link to header {h + 1}"
                )
            current = prev

    # -- fork detection (light/detector.go) ------------------------------

    def _make_attack_evidence(
        self, conflicting: LightBlock, common: LightBlock, trusted: LightBlock
    ) -> LightClientAttackEvidence:
        """(detector.go newLightClientAttackEvidence) — ``common`` is
        the latest trusted block both sides agree on; ``trusted`` is the
        header we believe at the conflicting height.  Total power and
        the byzantine list come from the common-height validator set and
        the actual conflicting signatures, so full nodes' checks pass."""
        from dataclasses import replace

        ev = LightClientAttackEvidence(
            conflicting_block=conflicting,
            common_height=common.height,
            total_voting_power=common.validator_set.total_voting_power(),
            timestamp_ns=common.time_ns,
        )
        byz = ev.get_byzantine_validators(
            common.validator_set, trusted.signed_header
        )
        return replace(
            ev, byzantine_validators=tuple(v.address for v in byz)
        )

    def _compare_with_witnesses(self, lb: LightBlock) -> None:
        """(detector.go:33 detectDivergence) — any witness serving a
        different header at this height implies an attack on one side;
        we can't tell which, so build evidence against each side and
        report it to the other."""
        for witness in self.witnesses:
            try:
                w_lb = witness.light_block(lb.height)
            except ProviderError:  # witness down or without the height: skip
                continue
            if w_lb.hash() == lb.hash():
                continue
            common = self.store.light_block_before(lb.height)
            if common is None:
                self.logger.error(
                    "divergence detected but no trusted block below the "
                    "conflicting height — cannot build attack evidence",
                    height=lb.height,
                )
            else:
                # witness's block is the fraud → tell the primary
                ev_w = self._make_attack_evidence(w_lb, common, lb)
                # primary's block is the fraud → tell the witness
                ev_p = self._make_attack_evidence(lb, common, w_lb)
                for target, ev in ((self.primary, ev_w), (witness, ev_p)):
                    try:
                        target.report_evidence(ev)
                    except ProviderError:
                        pass
            raise ErrLightClientAttack(
                f"witness header {w_lb.hash().hex()[:12]} conflicts with "
                f"primary {lb.hash().hex()[:12]} at height {lb.height}"
            )


__all__ = [
    "Client",
    "ErrLightClientAttack",
    "LightClientError",
    "NoWitnessesError",
    "SEQUENTIAL",
    "SKIPPING",
    "TrustOptions",
]
