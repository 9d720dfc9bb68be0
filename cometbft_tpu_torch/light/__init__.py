"""Light plane — header verification without full blocks (a part of
cometbft_tpu/light/, copied: the verifier).  The client, providers,
store and serving plane are not ported yet."""

from cometbft_tpu_torch.light.verifier import (
    DEFAULT_TRUST_LEVEL,
    VerificationError,
    verify,
    verify_adjacent,
    verify_non_adjacent,
)

__all__ = [
    "DEFAULT_TRUST_LEVEL",
    "VerificationError",
    "verify",
    "verify_adjacent",
    "verify_non_adjacent",
]
