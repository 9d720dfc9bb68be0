"""Consensus state — the replicated chain state between blocks (a copy
of cometbft_tpu/state/__init__.py; reference: state/state.go:47,
state/store.go:112).

``State`` is an immutable snapshot of everything needed to validate and
apply the *next* block: current/next/last validator sets, consensus
params, and the results of the last applied block.  The ``Store``
persists snapshots plus historical validator sets and params so
lagging peers, evidence verification, and the light client can look up
the set at any height.

``Store.save_finalize_block_response`` persists each height's
``FinalizeBlockResponse`` in ``abci/codec``'s bytes, under the
reference's format marker, so a state DB reads the same in both
packages.  ``Store.save`` is a trust-guard sink, as in the reference,
and runs in a ``state/save`` span (utils/trace.py), which the reference
does not have.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from cometbft_tpu_torch.abci.types import FinalizeBlockResponse
from cometbft_tpu_torch.crypto.ed25519 import Ed25519PubKey
from cometbft_tpu_torch.types.block import Block, BlockID, Commit, Data, Header
from cometbft_tpu_torch.types.genesis import GenesisDoc
from cometbft_tpu_torch.types.params import ConsensusParams
from cometbft_tpu_torch.types.validator import Validator, ValidatorSet
from cometbft_tpu_torch.utils.db import DB
from cometbft_tpu_torch.utils.protoio import ProtoReader, ProtoWriter
from cometbft_tpu_torch.utils.trace import TRACER
from cometbft_tpu_torch.version import BLOCK_PROTOCOL
from cometbft_tpu_torch.utils import trustguard


class StateError(Exception):
    pass


@dataclass(frozen=True)
class State:
    """Snapshot after applying block ``last_block_height``
    (state/state.go:47)."""

    chain_id: str = ""
    initial_height: int = 1
    last_block_height: int = 0
    last_block_id: BlockID = field(default_factory=BlockID)
    last_block_time_ns: int = 0
    validators: ValidatorSet | None = None
    next_validators: ValidatorSet | None = None
    last_validators: ValidatorSet | None = None
    last_height_validators_changed: int = 0
    consensus_params: ConsensusParams = field(default_factory=ConsensusParams)
    last_height_params_changed: int = 0
    last_results_hash: bytes = b""
    app_hash: bytes = b""
    version_app: int = 0

    def is_empty(self) -> bool:
        return self.validators is None

    @classmethod
    def from_genesis(cls, gen: GenesisDoc) -> "State":
        """(state/state.go MakeGenesisState)"""
        gen = gen.validate_and_complete()
        vals = gen.validator_set()
        return cls(
            chain_id=gen.chain_id,
            initial_height=gen.initial_height,
            last_block_height=0,
            last_block_time_ns=gen.genesis_time_ns,
            validators=vals,
            next_validators=vals.copy().increment_proposer_priority(1),
            last_validators=ValidatorSet([]),
            last_height_validators_changed=gen.initial_height,
            consensus_params=gen.consensus_params,
            last_height_params_changed=gen.initial_height,
            app_hash=gen.app_hash,
        )

    def make_block(
        self,
        height: int,
        txs: tuple[bytes, ...],
        last_commit: Commit,
        evidence: tuple,
        proposer_address: bytes,
        time_ns: int,
    ) -> Block:
        """Assemble a proposal block consistent with this state
        (state/state.go MakeBlock)."""
        header = Header(
            chain_id=self.chain_id,
            height=height,
            time_ns=time_ns,
            last_block_id=self.last_block_id,
            validators_hash=self.validators.hash(),
            next_validators_hash=self.next_validators.hash(),
            consensus_hash=self.consensus_params.hash(),
            app_hash=self.app_hash,
            last_results_hash=self.last_results_hash,
            proposer_address=proposer_address,
            version_block=BLOCK_PROTOCOL,
            version_app=self.version_app,
        )
        block = Block(
            header=header,
            data=Data(txs=txs),
            evidence=evidence,
            last_commit=last_commit,
        )
        return block.with_hashes()


# -- serialization -----------------------------------------------------

def encode_validator(v: Validator) -> bytes:
    w = ProtoWriter()
    pk = ProtoWriter()
    pk.string(1, v.pub_key.type())
    pk.bytes_(2, v.pub_key.bytes())
    w.message(1, pk.finish())
    w.varint(2, v.voting_power)
    w.sfixed64(3, v.proposer_priority)
    return w.finish()


def decode_validator(data: bytes) -> Validator:
    from cometbft_tpu_torch.types.codec import _bz, _iv, s64
    from cometbft_tpu_torch.utils.protoio import sfixed64_from_u64

    f = ProtoReader(data).to_dict()
    pkf = ProtoReader(_bz(f[1][0])).to_dict()
    ktype = _bz(pkf.get(1, [b""])[0]).decode()
    kbytes = _bz(pkf.get(2, [b""])[0])
    if ktype != "ed25519":
        raise StateError(f"unsupported key type {ktype!r}")
    return Validator(
        pub_key=Ed25519PubKey(kbytes),
        voting_power=s64(f.get(2, [0])[0]),
        proposer_priority=sfixed64_from_u64(_iv(f.get(3, [0])[0])),
    )


def encode_validator_set(vs: ValidatorSet) -> bytes:
    w = ProtoWriter()
    for v in vs.validators:
        w.message(1, encode_validator(v))
    proposer = vs.get_proposer() if len(vs) else None
    if proposer is not None:
        w.bytes_(2, proposer.address)
    return w.finish()


def decode_validator_set(data: bytes) -> ValidatorSet:
    from cometbft_tpu_torch.types.codec import _bz

    f = ProtoReader(data).to_dict()
    vals = [decode_validator(_bz(raw)) for raw in f.get(1, [])]
    vs = ValidatorSet(vals)
    prop_addr = _bz(f.get(2, [b""])[0])
    if prop_addr:
        _, prop = vs.get_by_address(prop_addr)
        if prop is not None:
            vs._proposer = prop
    return vs


def encode_consensus_params(p: ConsensusParams) -> bytes:
    import json

    return json.dumps(p.to_json_dict(), sort_keys=True).encode()


def decode_consensus_params(data: bytes) -> ConsensusParams:
    import json

    return ConsensusParams.from_json_dict(json.loads(data.decode()))


def encode_state(s: State) -> bytes:
    w = ProtoWriter()
    w.string(1, s.chain_id)
    w.varint(2, s.initial_height)
    w.varint(3, s.last_block_height)
    w.message(4, s.last_block_id.encode())
    w.sfixed64(5, s.last_block_time_ns)
    w.message(6, encode_validator_set(s.validators))
    w.message(7, encode_validator_set(s.next_validators))
    w.message(8, encode_validator_set(s.last_validators))
    w.varint(9, s.last_height_validators_changed)
    w.bytes_(10, encode_consensus_params(s.consensus_params))
    w.varint(11, s.last_height_params_changed)
    w.bytes_(12, s.last_results_hash)
    w.bytes_(13, s.app_hash)
    w.varint(14, s.version_app)
    return w.finish()


def decode_state(data: bytes) -> State:
    from cometbft_tpu_torch.types.codec import decode_block_id
    from cometbft_tpu_torch.utils.protoio import sfixed64_from_u64

    f = ProtoReader(data).to_dict()
    return State(
        chain_id=bytes(f.get(1, [b""])[0]).decode(),
        initial_height=int(f.get(2, [1])[0]),
        last_block_height=int(f.get(3, [0])[0]),
        last_block_id=decode_block_id(f[4][0]) if 4 in f else BlockID(),
        last_block_time_ns=sfixed64_from_u64(int(f.get(5, [0])[0])),
        validators=decode_validator_set(f[6][0]),
        next_validators=decode_validator_set(f[7][0]),
        last_validators=decode_validator_set(f[8][0]),
        last_height_validators_changed=int(f.get(9, [0])[0]),
        consensus_params=decode_consensus_params(bytes(f[10][0])),
        last_height_params_changed=int(f.get(11, [0])[0]),
        last_results_hash=bytes(f.get(12, [b""])[0]),
        app_hash=bytes(f.get(13, [b""])[0]),
        version_app=int(f.get(14, [0])[0]),
    )


# -- store -------------------------------------------------------------

_STATE_KEY = b"stateKey"
_VALS = b"validatorsKey:"
_PARAMS = b"consensusParamsKey:"
_ABCI_RESP = b"abciResponsesKey:"


def _hkey(prefix: bytes, height: int) -> bytes:
    return prefix + height.to_bytes(8, "big")


#: Version marker for the persistent ABCI-response encoding. Bumped when
#: abci/codec.py's wire format changes incompatibly (it doubles as the
#: storage format via FinalizeBlockResponse.encode). v2 = proto3-faithful
#: plain-varint encoding; v1 (unmarked) = the earlier zigzag/JSON codec.
_FORMAT_KEY = b"abciResponsesFormat"
_FORMAT_VERSION = b"v2-proto3"


class StoreFormatError(Exception):
    """The on-disk ABCI responses were written by an incompatible codec
    version; re-sync or delete the state DB (there is no migration)."""


class Store:
    """Persistent state store (state/store.go:112 dbStore)."""

    def __init__(self, db: DB):
        self._db = db
        marker = db.get(_FORMAT_KEY)
        if marker is None:
            # Fail loudly instead of decoding old bytes wrongly: a DB
            # that already holds ABCI responses but no format marker was
            # written by the pre-proto3 codec.
            has_old = next(iter(db.prefix_iterator(_ABCI_RESP)), None)
            if has_old is not None:
                raise StoreFormatError(
                    "state DB holds ABCI responses in the legacy "
                    "(pre-proto3) encoding; wipe the chain stores "
                    "(unsafe-reset-all) or re-sync"
                )
            db.set(_FORMAT_KEY, _FORMAT_VERSION)
        elif bytes(marker) != _FORMAT_VERSION:
            raise StoreFormatError(
                f"state DB ABCI-response format {bytes(marker)!r} != "
                f"supported {_FORMAT_VERSION!r}"
            )

    def load(self) -> State | None:
        raw = self._db.get(_STATE_KEY)
        return decode_state(raw) if raw is not None else None

    def save(self, state: State) -> None:
        """Persist the snapshot plus height-indexed validator/params
        lookups, in one atomic batch (state/store.go save)."""
        trustguard.check_sink("state.save")
        with TRACER.span("state/save", cat="state", height=state.last_block_height):
            next_height = state.last_block_height + 1
            ops: list[tuple[bytes, bytes | None]] = []
            if next_height == 1:
                next_height = state.initial_height
                # Genesis: index the initial sets too.
                ops.append(self._vals_op(next_height, state.validators))
            ops.append(self._vals_op(next_height + 1, state.next_validators))
            ops.append(
                (
                    _hkey(_PARAMS, next_height),
                    encode_consensus_params(state.consensus_params),
                )
            )
            ops.append((_STATE_KEY, encode_state(state)))
            self._db.write_batch(ops)

    def bootstrap(self, state: State) -> None:
        """Seed the store from an out-of-band state (statesync)
        (state/store.go Bootstrap)."""
        height = state.last_block_height + 1
        if height == 1:
            height = state.initial_height
        ops: list[tuple[bytes, bytes | None]] = []
        if height > 1 and len(state.last_validators or ValidatorSet([])):
            ops.append(self._vals_op(height - 1, state.last_validators))
        ops.append(self._vals_op(height, state.validators))
        ops.append(self._vals_op(height + 1, state.next_validators))
        ops.append(
            (
                _hkey(_PARAMS, height),
                encode_consensus_params(state.consensus_params),
            )
        )
        ops.append((_STATE_KEY, encode_state(state)))
        self._db.write_batch(ops)

    def _vals_op(self, height: int, vals: ValidatorSet) -> tuple[bytes, bytes]:
        return _hkey(_VALS, height), encode_validator_set(vals)

    def load_validators(self, height: int) -> ValidatorSet:
        """Validator set that signed block ``height``
        (state/store.go LoadValidators)."""
        raw = self._db.get(_hkey(_VALS, height))
        if raw is None:
            raise StateError(f"no validator set at height {height}")
        return decode_validator_set(raw)

    def load_consensus_params(self, height: int) -> ConsensusParams:
        # Params change rarely; one reverse range read finds the last
        # recorded height <= height.
        for _, raw in self._db.reverse_iterator(
            _PARAMS, _hkey(_PARAMS, height + 1)
        ):
            return decode_consensus_params(raw)
        raise StateError(f"no consensus params at height {height}")

    def save_finalize_block_response(
        self, height: int, resp: FinalizeBlockResponse
    ) -> None:
        self._db.set(_hkey(_ABCI_RESP, height), resp.encode())

    def load_finalize_block_response(
        self, height: int
    ) -> FinalizeBlockResponse | None:
        raw = self._db.get(_hkey(_ABCI_RESP, height))
        return FinalizeBlockResponse.decode(raw) if raw is not None else None

    def prune(self, retain_height: int) -> None:
        """Delete historical validators/params/responses below
        ``retain_height`` (state/pruner.go)."""
        for prefix in (_VALS, _PARAMS, _ABCI_RESP):
            ops = [
                (k, None)
                for k, _ in self._db.iterator(
                    prefix, _hkey(prefix, retain_height)
                )
            ]
            if ops:
                self._db.write_batch(ops)

    def prune_abci_responses(self, retain_height: int) -> None:
        """Delete FinalizeBlock responses below ``retain_height`` only
        (the data companion's separate axis, pruner.go pruneABCIResponses)."""
        ops = [
            (k, None)
            for k, _ in self._db.iterator(
                _ABCI_RESP, _hkey(_ABCI_RESP, retain_height)
            )
        ]
        if ops:
            self._db.write_batch(ops)


def load_state_from_db_or_genesis(store: Store, gen: GenesisDoc) -> State:
    """(node/node.go:329 LoadStateFromDBOrGenesisDocProvider)"""
    state = store.load()
    if state is None:
        state = State.from_genesis(gen)
    elif state.chain_id != gen.chain_id:
        raise StateError(
            f"state chain id {state.chain_id!r} != genesis {gen.chain_id!r}"
        )
    return state
