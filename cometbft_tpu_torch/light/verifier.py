"""Light-client verification core (a copy of cometbft_tpu/light/verifier.py;
reference: light/verifier.go).

Two modes (verifier.go:129 Verify):
- adjacent (H → H+1): the new header's validator set must hash to the
  trusted header's next_validators_hash (verifier.go:91 VerifyAdjacent);
- non-adjacent (H → H+n): the *trusted* validator set must have signed
  the new commit with ≥ 1/3 of its power (skipping trust,
  verifier.go:30 VerifyNonAdjacent), then the new set verifies its own
  commit with +2/3.

Both commit checks ride the batch-verify plane (types/validation, the
device seam): every public function takes a keyword ``device`` and
passes it on (``cuda`` unless the caller gives another).

Where the port departs from its reference: a failed commit check
becomes ``ErrNewValSetCantBeTrusted`` or ``ErrInvalidHeader`` only when
validation judged the input: a ``CommitError``, or a bad trust level
(``check_trust_level``, called on its own before the commit check).
``LightBlockError`` comes from ``validate_basic``, before either, and
is raised as it is, as in the reference.  The reference wraps every
exception, so a kernel that failed to build or to launch -- a
``RuntimeError``, or a ``ValueError`` from the device layer -- would
read as a rejected header; in the port it reaches the caller as it is.
"""

from __future__ import annotations

from fractions import Fraction

from cometbft_tpu_torch.types.block import BlockID
from cometbft_tpu_torch.types.light_block import LightBlock
from cometbft_tpu_torch.types.validation import (
    CommitError,
    check_trust_level,
    verify_commit_light,
    verify_commit_light_trusting,
)
from cometbft_tpu_torch.utils.time import now_ns

DEFAULT_TRUST_LEVEL = Fraction(1, 3)  # light/verifier.go:21


class VerificationError(Exception):
    pass


class ErrOldHeaderExpired(VerificationError):
    """Trusted header fell outside the trusting period."""


class ErrNewValSetCantBeTrusted(VerificationError):
    """Skipping verification failed: not enough trusted power signed.
    The client responds by bisecting (client.go verifySkipping)."""


class ErrInvalidHeader(VerificationError):
    pass


def _check_trusted_within_period(
    trusted: LightBlock, trusting_period_ns: int, now: int
) -> None:
    """(light/verifier.go:213 HeaderExpired check)"""
    expiration = trusted.time_ns + trusting_period_ns
    if now > expiration:
        raise ErrOldHeaderExpired(
            f"trusted header expired at {expiration} (now {now})"
        )


def _verify_new_header_and_vals(
    untrusted: LightBlock,
    trusted: LightBlock,
    chain_id: str,
    now: int,
    max_clock_drift_ns: int,
) -> None:
    """(light/verifier.go:147 verifyNewHeaderAndVals)"""
    untrusted.validate_basic(chain_id)
    if untrusted.height <= trusted.height:
        raise ErrInvalidHeader(
            f"new header height {untrusted.height} <= "
            f"trusted {trusted.height}"
        )
    if untrusted.time_ns <= trusted.time_ns:
        raise ErrInvalidHeader("new header time not after trusted header")
    if untrusted.time_ns >= now + max_clock_drift_ns:
        raise ErrInvalidHeader("new header is from the future")


def verify_adjacent(
    trusted: LightBlock,
    untrusted: LightBlock,
    chain_id: str,
    trusting_period_ns: int,
    now: int | None = None,
    max_clock_drift_ns: int = 10 * 10**9,
    *,
    device=None,
) -> None:
    """(light/verifier.go:91 VerifyAdjacent)"""
    if untrusted.height != trusted.height + 1:
        raise ErrInvalidHeader("headers must be adjacent in height")
    now = now_ns() if now is None else now
    _check_trusted_within_period(trusted, trusting_period_ns, now)
    _verify_new_header_and_vals(
        untrusted, trusted, chain_id, now, max_clock_drift_ns
    )
    if (
        untrusted.header.validators_hash
        != trusted.header.next_validators_hash
    ):
        raise ErrInvalidHeader(
            "new validator set hash does not match trusted "
            "next_validators_hash"
        )
    _verify_self_commit(untrusted, chain_id, device)


def verify_non_adjacent(
    trusted: LightBlock,
    untrusted: LightBlock,
    chain_id: str,
    trusting_period_ns: int,
    now: int | None = None,
    trust_level: Fraction = DEFAULT_TRUST_LEVEL,
    max_clock_drift_ns: int = 10 * 10**9,
    *,
    device=None,
) -> None:
    """(light/verifier.go:30 VerifyNonAdjacent)"""
    if untrusted.height == trusted.height + 1:
        return verify_adjacent(
            trusted, untrusted, chain_id, trusting_period_ns, now,
            max_clock_drift_ns, device=device,
        )
    now = now_ns() if now is None else now
    _check_trusted_within_period(trusted, trusting_period_ns, now)
    _verify_new_header_and_vals(
        untrusted, trusted, chain_id, now, max_clock_drift_ns
    )
    # ≥ trust_level of the OLD (trusted) set must have signed the new
    # commit
    try:
        check_trust_level(trust_level)
    except ValueError as exc:
        raise ErrNewValSetCantBeTrusted(str(exc)) from exc
    try:
        verify_commit_light_trusting(
            chain_id,
            trusted.validator_set,
            untrusted.signed_header.commit,
            trust_level,
            device=device,
        )
    except CommitError as exc:
        raise ErrNewValSetCantBeTrusted(str(exc)) from exc
    _verify_self_commit(untrusted, chain_id, device)


def verify(
    trusted: LightBlock,
    untrusted: LightBlock,
    chain_id: str,
    trusting_period_ns: int,
    now: int | None = None,
    trust_level: Fraction = DEFAULT_TRUST_LEVEL,
    max_clock_drift_ns: int = 10 * 10**9,
    *,
    device=None,
) -> None:
    """(light/verifier.go:129 Verify) — dispatch on adjacency."""
    if untrusted.height != trusted.height + 1:
        verify_non_adjacent(
            trusted, untrusted, chain_id, trusting_period_ns, now,
            trust_level, max_clock_drift_ns, device=device,
        )
    else:
        verify_adjacent(
            trusted, untrusted, chain_id, trusting_period_ns, now,
            max_clock_drift_ns, device=device,
        )


def _verify_self_commit(lb: LightBlock, chain_id: str, device=None) -> None:
    """+2/3 of the new set signed its own header (batch path)."""
    sh = lb.signed_header
    block_id = BlockID(
        hash=sh.header.hash(),
        part_set_header=sh.commit.block_id.part_set_header,
    )
    try:
        verify_commit_light(
            chain_id,
            lb.validator_set,
            block_id,
            sh.height,
            sh.commit,
            device=device,
        )
    except CommitError as exc:
        raise ErrInvalidHeader(f"invalid commit: {exc}") from exc


__all__ = [
    "DEFAULT_TRUST_LEVEL",
    "ErrInvalidHeader",
    "ErrNewValSetCantBeTrusted",
    "ErrOldHeaderExpired",
    "VerificationError",
    "verify",
    "verify_adjacent",
    "verify_non_adjacent",
]
