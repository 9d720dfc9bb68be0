"""Byzantine-fault evidence types (a copy of cometbft_tpu/types/evidence.py;
reference: types/evidence.go)."""

from __future__ import annotations

from dataclasses import dataclass, field

from cometbft_tpu_torch.crypto import tmhash
from cometbft_tpu_torch.types.validator import ValidatorSet
from cometbft_tpu_torch.types.vote import Vote


class EvidenceError(Exception):
    pass


@dataclass(frozen=True)
class DuplicateVoteEvidence:
    """Equivocation: two votes by one validator for the same
    (height, round, type) but different blocks (types/evidence.go:44)."""

    vote_a: Vote
    vote_b: Vote
    total_voting_power: int = 0
    validator_power: int = 0
    timestamp_ns: int = 0

    @property
    def height(self) -> int:
        return self.vote_a.height

    def hash(self) -> bytes:
        from cometbft_tpu_torch.types import codec

        return tmhash.sum256(codec.encode_evidence(self))

    @classmethod
    def from_votes(
        cls, vote_a: Vote, vote_b: Vote, block_time_ns: int, val_set: ValidatorSet
    ) -> "DuplicateVoteEvidence":
        """Canonical ordering: vote_a is the lexicographically smaller
        block id (types/evidence.go NewDuplicateVoteEvidence)."""
        if vote_a is None or vote_b is None:
            raise EvidenceError("missing vote")
        _, val = val_set.get_by_address(vote_a.validator_address)
        if val is None:
            raise EvidenceError("validator not in set")
        if vote_b.block_id.key() < vote_a.block_id.key():
            vote_a, vote_b = vote_b, vote_a
        return cls(
            vote_a=vote_a,
            vote_b=vote_b,
            total_voting_power=val_set.total_voting_power(),
            validator_power=val.voting_power,
            timestamp_ns=block_time_ns,
        )

    def validate_basic(self) -> None:
        if self.vote_a is None or self.vote_b is None:
            raise EvidenceError("missing vote")
        if self.vote_a.block_id.key() >= self.vote_b.block_id.key():
            raise EvidenceError("duplicate votes in wrong order")


@dataclass(frozen=True)
class LightClientAttackEvidence:
    """A conflicting light block (header + commit + validator set)
    signed by a subset of validators (types/evidence.go:176).  The full
    light block is carried so verifiers can check the conflicting
    commit's signatures; full verification lives in evidence/pool."""

    conflicting_block: object  # LightBlock
    common_height: int
    byzantine_validators: tuple[bytes, ...] = ()  # addresses, power-ordered
    total_voting_power: int = 0
    timestamp_ns: int = 0

    @property
    def height(self) -> int:
        """Last height primary and witness agreed — the height the
        byzantine validators are known to have been bonded at
        (types/evidence.go:341 Height)."""
        return self.common_height

    @property
    def conflicting_header_hash(self) -> bytes:
        return self.conflicting_block.hash()

    def hash(self) -> bytes:
        """Hash over (conflicting header hash, common height) only, so
        permutations of the same attack with different signature subsets
        collide and can't be committed twice (types/evidence.go:329)."""
        from cometbft_tpu_torch.utils.protoio import ProtoWriter

        w = ProtoWriter()
        w.bytes_(1, self.conflicting_block.hash())
        w.varint(2, self.common_height & 0xFFFFFFFFFFFFFFFF)
        return tmhash.sum256(w.finish())

    def conflicting_header_is_invalid(self, trusted_header) -> bool:
        """Lunatic-attack test: the conflicting header could not have
        been produced by the validator set our chain had at that height
        (types/evidence.go:313 ConflictingHeaderIsInvalid)."""
        ch = self.conflicting_block.header
        return (
            trusted_header.validators_hash != ch.validators_hash
            or trusted_header.next_validators_hash != ch.next_validators_hash
            or trusted_header.consensus_hash != ch.consensus_hash
            or trusted_header.app_hash != ch.app_hash
            or trusted_header.last_results_hash != ch.last_results_hash
        )

    def get_byzantine_validators(
        self, common_vals: ValidatorSet, trusted
    ) -> list:
        """Derive the malicious validators from the actual conflicting
        signatures (types/evidence.go:260 GetByzantineValidators).

        Lunatic attack → common-set validators who committed the
        conflicting header.  Equivocation (same round) → validators who
        committed in both headers.  Amnesia → unattributable, empty.
        ``trusted`` is the SignedHeader our chain has at the conflicting
        height.
        """
        cb = self.conflicting_block
        validators = []
        if self.conflicting_header_is_invalid(trusted.header):
            for cs in cb.commit.signatures:
                if not cs.is_commit():
                    continue
                _, val = common_vals.get_by_address(cs.validator_address)
                if val is None:
                    continue
                validators.append(val)
        elif trusted.commit.round == cb.commit.round:
            for i, sig_a in enumerate(cb.commit.signatures):
                if not sig_a.is_commit():
                    continue
                if i >= len(trusted.commit.signatures):
                    continue
                if not trusted.commit.signatures[i].is_commit():
                    continue
                _, val = cb.validator_set.get_by_address(
                    sig_a.validator_address
                )
                if val is not None:
                    validators.append(val)
        validators.sort(key=lambda v: (-v.voting_power, v.address))
        return validators
