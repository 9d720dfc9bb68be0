"""Consensus parameters (a copy of cometbft_tpu/types/params.py;
reference: types/params.go)."""

from __future__ import annotations

from dataclasses import dataclass, field

from cometbft_tpu_torch.crypto import tmhash
from cometbft_tpu_torch.types.part_set import BLOCK_PART_SIZE_BYTES  # noqa: F401
from cometbft_tpu_torch.utils.protoio import ProtoWriter

MAX_BLOCK_SIZE_BYTES = 104857600  # 100MB hard cap (types/params.go)


@dataclass(frozen=True)
class BlockParams:
    max_bytes: int = 4194304  # 4MB default (QA baseline block size)
    max_gas: int = -1

    def validate(self) -> None:
        if self.max_bytes == 0 or self.max_bytes < -1:
            raise ValueError("block.max_bytes must be -1 or positive")
        if self.max_bytes > MAX_BLOCK_SIZE_BYTES:
            raise ValueError("block.max_bytes too large")
        if self.max_gas < -1:
            raise ValueError("block.max_gas must be >= -1")


@dataclass(frozen=True)
class EvidenceParams:
    max_age_num_blocks: int = 100000
    max_age_duration_ns: int = 48 * 3600 * 1_000_000_000
    max_bytes: int = 1048576

    def validate(self) -> None:
        if self.max_age_num_blocks <= 0:
            raise ValueError("evidence.max_age_num_blocks must be positive")
        if self.max_age_duration_ns <= 0:
            raise ValueError("evidence.max_age_duration must be positive")


@dataclass(frozen=True)
class ValidatorParams:
    pub_key_types: tuple[str, ...] = ("ed25519",)

    def validate(self) -> None:
        if not self.pub_key_types:
            raise ValueError("validator.pub_key_types cannot be empty")


@dataclass(frozen=True)
class FeatureParams:
    """Height-gated protocol features (types/params.go FeatureParams):
    0 disables; height H enables from H on."""

    vote_extensions_enable_height: int = 0
    pbts_enable_height: int = 0


@dataclass(frozen=True)
class SynchronyParams:
    """PBTS bounds (types/params.go SynchronyParams)."""

    precision_ns: int = 505_000_000
    message_delay_ns: int = 15_000_000_000


@dataclass(frozen=True)
class ConsensusParams:
    block: BlockParams = field(default_factory=BlockParams)
    evidence: EvidenceParams = field(default_factory=EvidenceParams)
    validator: ValidatorParams = field(default_factory=ValidatorParams)
    feature: FeatureParams = field(default_factory=FeatureParams)
    synchrony: SynchronyParams = field(default_factory=SynchronyParams)

    def validate(self) -> None:
        self.block.validate()
        self.evidence.validate()
        self.validator.validate()

    def vote_extensions_enabled(self, height: int) -> bool:
        h = self.feature.vote_extensions_enable_height
        return h > 0 and height >= h

    def pbts_enabled(self, height: int) -> bool:
        h = self.feature.pbts_enable_height
        return h > 0 and height >= h

    def hash(self) -> bytes:
        """Deterministic hash for Header.consensus_hash
        (types/params.go HashConsensusParams)."""
        w = ProtoWriter()
        w.varint(1, self.block.max_bytes & 0xFFFFFFFFFFFFFFFF)
        w.varint(2, self.block.max_gas & 0xFFFFFFFFFFFFFFFF)
        return tmhash.sum256(w.finish())

    def to_json_dict(self) -> dict:
        return {
            "block": {
                "max_bytes": str(self.block.max_bytes),
                "max_gas": str(self.block.max_gas),
            },
            "evidence": {
                "max_age_num_blocks": str(self.evidence.max_age_num_blocks),
                "max_age_duration": str(self.evidence.max_age_duration_ns),
                "max_bytes": str(self.evidence.max_bytes),
            },
            "validator": {"pub_key_types": list(self.validator.pub_key_types)},
            "feature": {
                "vote_extensions_enable_height": str(
                    self.feature.vote_extensions_enable_height
                ),
                "pbts_enable_height": str(self.feature.pbts_enable_height),
            },
            "synchrony": {
                "precision": str(self.synchrony.precision_ns),
                "message_delay": str(self.synchrony.message_delay_ns),
            },
        }

    @classmethod
    def from_json_dict(cls, d: dict) -> "ConsensusParams":
        def geti(sub, key, default):
            return int(d.get(sub, {}).get(key, default))

        return cls(
            block=BlockParams(
                max_bytes=geti("block", "max_bytes", 4194304),
                max_gas=geti("block", "max_gas", -1),
            ),
            evidence=EvidenceParams(
                max_age_num_blocks=geti("evidence", "max_age_num_blocks", 100000),
                max_age_duration_ns=geti(
                    "evidence", "max_age_duration", 48 * 3600 * 10**9
                ),
                max_bytes=geti("evidence", "max_bytes", 1048576),
            ),
            validator=ValidatorParams(
                pub_key_types=tuple(
                    d.get("validator", {}).get("pub_key_types", ["ed25519"])
                )
            ),
            feature=FeatureParams(
                vote_extensions_enable_height=geti(
                    "feature", "vote_extensions_enable_height", 0
                ),
                pbts_enable_height=geti("feature", "pbts_enable_height", 0),
            ),
            synchrony=SynchronyParams(
                precision_ns=geti("synchrony", "precision", 505_000_000),
                message_delay_ns=geti(
                    "synchrony", "message_delay", 15_000_000_000
                ),
            ),
        )


DEFAULT_CONSENSUS_PARAMS = ConsensusParams()
