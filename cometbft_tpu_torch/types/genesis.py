"""Genesis document (a copy of cometbft_tpu/types/genesis.py; reference:
types/genesis.go)."""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from cometbft_tpu_torch.crypto import PubKey, tmhash
from cometbft_tpu_torch.crypto.ed25519 import Ed25519PubKey
from cometbft_tpu_torch.types.params import ConsensusParams, DEFAULT_CONSENSUS_PARAMS
from cometbft_tpu_torch.types.validator import Validator, ValidatorSet

MAX_CHAIN_ID_LEN = 50


class GenesisError(Exception):
    pass


def _pub_key_to_json(pk: PubKey) -> dict:
    import base64

    return {
        "type": f"tendermint/PubKey{pk.type().capitalize()}",
        "value": base64.b64encode(pk.bytes()).decode(),
    }


def _pub_key_from_json(d: dict) -> PubKey:
    import base64

    raw = base64.b64decode(d["value"])
    t = d.get("type", "")
    if "Ed25519" in t or "ed25519" in t:
        return Ed25519PubKey(raw)
    raise GenesisError(f"unsupported pubkey type {t}")


@dataclass(frozen=True)
class GenesisValidator:
    pub_key: PubKey
    power: int
    name: str = ""

    @property
    def address(self) -> bytes:
        return self.pub_key.address()


@dataclass(frozen=True)
class GenesisDoc:
    chain_id: str
    genesis_time_ns: int = 0
    initial_height: int = 1
    consensus_params: ConsensusParams = field(
        default_factory=lambda: DEFAULT_CONSENSUS_PARAMS
    )
    validators: tuple[GenesisValidator, ...] = ()
    app_hash: bytes = b""
    app_state: bytes = b"{}"

    def validate_and_complete(self) -> "GenesisDoc":
        if not self.chain_id:
            raise GenesisError("genesis doc must include chain_id")
        if len(self.chain_id) > MAX_CHAIN_ID_LEN:
            raise GenesisError("chain_id too long")
        if self.initial_height < 1:
            raise GenesisError("initial_height must be >= 1")
        self.consensus_params.validate()
        for v in self.validators:
            if v.power < 0:
                raise GenesisError("validator power cannot be negative")
        return self

    def validator_set(self) -> ValidatorSet:
        return ValidatorSet(
            [Validator(v.pub_key, v.power) for v in self.validators]
        )

    def hash(self) -> bytes:
        """Genesis hash for chain identity checks (node/node.go:329)."""
        return tmhash.sum256(self.to_json().encode())

    def to_json(self) -> str:
        import base64

        return json.dumps(
            {
                "genesis_time": str(self.genesis_time_ns),
                "chain_id": self.chain_id,
                "initial_height": str(self.initial_height),
                "consensus_params": self.consensus_params.to_json_dict(),
                "validators": [
                    {
                        "address": v.address.hex().upper(),
                        "pub_key": _pub_key_to_json(v.pub_key),
                        "power": str(v.power),
                        "name": v.name,
                    }
                    for v in self.validators
                ],
                "app_hash": self.app_hash.hex().upper(),
                "app_state": json.loads(self.app_state.decode() or "{}"),
            },
            sort_keys=True,
            separators=(",", ":"),
        )

    @classmethod
    def from_json(cls, raw: str | bytes) -> "GenesisDoc":
        d = json.loads(raw)
        vals = tuple(
            GenesisValidator(
                pub_key=_pub_key_from_json(v["pub_key"]),
                power=int(v["power"]),
                name=v.get("name", ""),
            )
            for v in d.get("validators", [])
        )
        doc = cls(
            chain_id=d["chain_id"],
            genesis_time_ns=int(d.get("genesis_time", 0)),
            initial_height=int(d.get("initial_height", 1)),
            consensus_params=ConsensusParams.from_json_dict(
                d.get("consensus_params", {})
            ),
            validators=vals,
            app_hash=bytes.fromhex(d.get("app_hash", "")),
            app_state=json.dumps(d.get("app_state", {})).encode(),
        )
        return doc.validate_and_complete()

    def save_as(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def from_file(cls, path: str) -> "GenesisDoc":
        with open(path) as f:
            return cls.from_json(f.read())
