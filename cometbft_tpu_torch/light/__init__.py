"""Light plane — header verification without full blocks (a part of
cometbft_tpu/light/, copied: the verifier, the trusted store, the
providers but the RPC one, and the client).  The serving plane, the
HTTP provider and the proxy come with RPC."""

from cometbft_tpu_torch.light.client import (
    Client,
    ErrLightClientAttack,
    LightClientError,
    SEQUENTIAL,
    SKIPPING,
    TrustOptions,
)
from cometbft_tpu_torch.light.provider import (
    LightBlockNotFoundError,
    NodeProvider,
    Provider,
    ProviderError,
)
from cometbft_tpu_torch.light.store import LightStore
from cometbft_tpu_torch.light.verifier import (
    DEFAULT_TRUST_LEVEL,
    VerificationError,
    verify,
    verify_adjacent,
    verify_non_adjacent,
)

__all__ = [
    "Client",
    "DEFAULT_TRUST_LEVEL",
    "ErrLightClientAttack",
    "LightBlockNotFoundError",
    "LightClientError",
    "LightStore",
    "NodeProvider",
    "Provider",
    "ProviderError",
    "SEQUENTIAL",
    "SKIPPING",
    "TrustOptions",
    "VerificationError",
    "verify",
    "verify_adjacent",
    "verify_non_adjacent",
]
