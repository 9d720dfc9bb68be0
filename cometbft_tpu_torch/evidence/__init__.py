"""Evidence plane — byzantine-fault detection (a copy of
cometbft_tpu/evidence/__init__.py; reference: internal/evidence/)."""

from cometbft_tpu_torch.evidence.pool import (
    EvidenceAlreadyCommittedError,
    EvidenceExpiredError,
    EvidenceInvalidError,
    Pool,
)
from cometbft_tpu_torch.evidence.reactor import EVIDENCE_CHANNEL, EvidenceReactor

__all__ = [
    "EVIDENCE_CHANNEL",
    "EvidenceAlreadyCommittedError",
    "EvidenceExpiredError",
    "EvidenceInvalidError",
    "EvidenceReactor",
    "Pool",
]
