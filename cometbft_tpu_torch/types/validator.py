"""Validator and ValidatorSet with proposer-priority rotation (a copy of
cometbft_tpu/types/validator.py; reference types/validator.go,
types/validator_set.go).

Keys are the port's ``crypto.PubKey`` (``crypto/ed25519.Ed25519PubKey``):
a set carried over from the reference is rebuilt from each validator's
``(pub_key.bytes(), voting_power, proposer_priority)``."""

from __future__ import annotations

from dataclasses import dataclass, replace

from cometbft_tpu_torch.crypto import PubKey, merkle
from cometbft_tpu_torch.utils.protoio import ProtoWriter

# Priority rescaling bound (validator_set.go PriorityWindowSizeFactor).
PRIORITY_WINDOW_SIZE_FACTOR = 2
MAX_TOTAL_VOTING_POWER = (1 << 63) // 8


@dataclass(frozen=True)
class Validator:
    pub_key: PubKey
    voting_power: int
    proposer_priority: int = 0

    @property
    def address(self) -> bytes:
        return self.pub_key.address()

    def simple_encode(self) -> bytes:
        """SimpleValidator encoding for the set hash
        (types/validator.go Validator.Bytes): pubkey + power."""
        w = ProtoWriter()
        pk = ProtoWriter()
        pk.string(1, self.pub_key.type())
        pk.bytes_(2, self.pub_key.bytes())
        w.message(1, pk.finish())
        w.varint(2, self.voting_power)
        return w.finish()


class ValidatorSet:
    """Ordered validator set with deterministic proposer rotation.

    Ordering: (voting power desc, address asc) — the reference's
    canonical order. Proposer selection implements the priority queue of
    validator_set.go: each advance adds power to every priority, picks
    the max as proposer, and charges it the total power; priorities are
    re-centered and capped to bound drift.
    """

    def __init__(self, validators: list[Validator]):
        addrs = [v.address for v in validators]
        if len(set(addrs)) != len(addrs):
            raise ValueError("duplicate validator address")
        self.validators = sorted(
            validators, key=lambda v: (-v.voting_power, v.address)
        )
        self._total_power: int | None = None
        self._index: dict[bytes, int] = {}
        self._index_of: list[Validator] | None = None
        if self.validators:
            total = self.total_voting_power()
            if total > MAX_TOTAL_VOTING_POWER:
                raise ValueError("total voting power overflow")
        self._proposer: Validator | None = None

    # -- queries -------------------------------------------------------

    def __len__(self) -> int:
        return len(self.validators)

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, ValidatorSet)
            and self.validators == other.validators
        )

    def __hash__(self) -> int:
        return hash(tuple(v.address for v in self.validators))

    def total_voting_power(self) -> int:
        """Cached — the membership of a ValidatorSet instance is fixed
        (updates return new sets), and vote tallying queries this per
        vote (validator_set.go caches totalVotingPower likewise)."""
        if self._total_power is None:
            self._total_power = sum(v.voting_power for v in self.validators)
        return self._total_power

    def get_by_address(self, addr: bytes) -> tuple[int, Validator | None]:
        """The reference scans the list and hashes every key on the way;
        the port looks the address up in a map built once per list
        (priority steps replace the list, never reorder it).  At 1024
        validators the scan made ``median_time`` -- one lookup per commit
        signature -- cost half a second a block."""
        if self._index_of is not self.validators:
            self._index = {v.address: i for i, v in enumerate(self.validators)}
            self._index_of = self.validators
        i = self._index.get(addr)
        return (-1, None) if i is None else (i, self.validators[i])

    def get_by_index(self, idx: int) -> Validator | None:
        if 0 <= idx < len(self.validators):
            return self.validators[idx]
        return None

    def has_address(self, addr: bytes) -> bool:
        return self.get_by_address(addr)[0] >= 0

    def hash(self) -> bytes:
        return merkle.hash_from_byte_slices(
            [v.simple_encode() for v in self.validators]
        )

    # -- proposer rotation ---------------------------------------------

    def get_proposer(self) -> Validator:
        if not self.validators:
            raise ValueError("empty validator set")
        if self._proposer is None:
            self._proposer = max(
                self.validators,
                key=lambda v: (v.proposer_priority, _neg_bytes(v.address)),
            )
        return self._proposer

    def copy(self) -> "ValidatorSet":
        vs = ValidatorSet(list(self.validators))
        vs._proposer = self._proposer
        return vs

    def increment_proposer_priority(self, times: int) -> "ValidatorSet":
        """Advance the rotation ``times`` rounds (validator_set.go:96)."""
        if times <= 0:
            raise ValueError("times must be positive")
        vs = self.copy()
        vs._rescale_priorities()
        vs._shift_by_avg_proposer_priority()
        proposer = None
        for _ in range(times):
            proposer = vs._increment_once()
        vs._proposer = proposer
        return vs

    def _increment_once(self) -> Validator:
        total = self.total_voting_power()
        vals = [
            replace(v, proposer_priority=v.proposer_priority + v.voting_power)
            for v in self.validators
        ]
        top_i = max(
            range(len(vals)),
            key=lambda i: (vals[i].proposer_priority, _neg_bytes(vals[i].address)),
        )
        vals[top_i] = replace(
            vals[top_i], proposer_priority=vals[top_i].proposer_priority - total
        )
        self.validators = vals
        return vals[top_i]

    def _rescale_priorities(self) -> None:
        """Cap the priority spread to 2*total power (validator_set.go:
        RescalePriorities) so priorities can't overflow over time."""
        if not self.validators:
            return
        diff_max = PRIORITY_WINDOW_SIZE_FACTOR * self.total_voting_power()
        prios = [v.proposer_priority for v in self.validators]
        diff = max(prios) - min(prios)
        if diff_max > 0 and diff > diff_max:
            ratio = (diff + diff_max - 1) // diff_max
            self.validators = [
                replace(v, proposer_priority=_int_div(v.proposer_priority, ratio))
                for v in self.validators
            ]

    def _shift_by_avg_proposer_priority(self) -> None:
        if not self.validators:
            return
        avg = _int_div(
            sum(v.proposer_priority for v in self.validators),
            len(self.validators),
        )
        self.validators = [
            replace(v, proposer_priority=v.proposer_priority - avg)
            for v in self.validators
        ]

    # -- updates (ABCI validator updates) ------------------------------

    def update_with_change_set(
        self, changes: list[tuple[PubKey, int]]
    ) -> "ValidatorSet":
        """Apply (pubkey, power) updates; power 0 removes
        (validator_set.go UpdateWithChangeSet semantics)."""
        by_addr = {v.address: v for v in self.validators}
        seen = set()
        for pub_key, power in changes:
            addr = pub_key.address()
            if addr in seen:
                raise ValueError("duplicate update for validator")
            seen.add(addr)
            if power < 0:
                raise ValueError("negative voting power")
            if power == 0:
                if addr not in by_addr:
                    raise ValueError("removing unknown validator")
                del by_addr[addr]
            elif addr in by_addr:
                by_addr[addr] = replace(by_addr[addr], voting_power=power)
            else:
                # New validator starts with priority -1.125 * total power
                # (validator_set.go computeNewPriority) so it cannot be
                # proposer immediately.
                total = sum(v.voting_power for v in by_addr.values()) + power
                prio = -(total + (total >> 3))
                by_addr[addr] = Validator(pub_key, power, prio)
        if not by_addr:
            raise ValueError("validator set cannot become empty")
        vs = ValidatorSet(list(by_addr.values()))
        vs._shift_by_avg_proposer_priority()
        return vs

    def __repr__(self) -> str:
        return (
            f"ValidatorSet(n={len(self.validators)}, "
            f"power={self.total_voting_power()})"
        )


def _neg_bytes(b: bytes) -> bytes:
    """Order helper: ties on priority break by *lowest* address."""
    return bytes(255 - x for x in b)


def _int_div(a: int, b: int) -> int:
    """Truncated (Go-style) integer division, not Python floor."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q
