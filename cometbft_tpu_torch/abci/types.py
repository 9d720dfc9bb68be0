"""ABCI 2.x application interface — request/response types and the
``Application`` protocol (a copy of cometbft_tpu/abci/types.py;
reference: abci/types/application.go:11-41).

Twelve methods across four logical connections:
  query     — Info, Query, Echo
  mempool   — CheckTx
  consensus — InitChain, PrepareProposal, ProcessProposal,
              FinalizeBlock, ExtendVote, VerifyVoteExtension, Commit
  snapshot  — ListSnapshots, OfferSnapshot, LoadSnapshotChunk,
              ApplySnapshotChunk
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum

from cometbft_tpu_torch.utils.protoio import ProtoReader, ProtoWriter

CODE_TYPE_OK = 0

# CheckTx types (abci/types/types.proto CheckTxType)
CHECK_TX_TYPE_CHECK = 0
CHECK_TX_TYPE_RECHECK = 1


class ProposalStatus(IntEnum):
    """ProcessProposal verdict (ResponseProcessProposal.ProposalStatus)."""

    UNKNOWN = 0
    ACCEPT = 1
    REJECT = 2


class VerifyStatus(IntEnum):
    """VerifyVoteExtension verdict."""

    UNKNOWN = 0
    ACCEPT = 1
    REJECT = 2


class OfferSnapshotResult(IntEnum):
    """OfferSnapshot verdict (ResponseOfferSnapshot.Result)."""

    UNKNOWN = 0
    ACCEPT = 1
    ABORT = 2
    REJECT = 3
    REJECT_FORMAT = 4
    REJECT_SENDER = 5


class ApplySnapshotChunkResult(IntEnum):
    UNKNOWN = 0
    ACCEPT = 1
    ABORT = 2
    RETRY = 3
    RETRY_SNAPSHOT = 4
    REJECT_SNAPSHOT = 5


@dataclass(frozen=True)
class EventAttribute:
    key: str
    value: str
    index: bool = True


@dataclass(frozen=True)
class Event:
    """Indexable event emitted by the app (abci/types Event)."""

    type: str
    attributes: tuple[EventAttribute, ...] = ()


def encode_event(ev: Event) -> bytes:
    e = ProtoWriter()
    e.string(1, ev.type)
    for attr in ev.attributes:
        a = ProtoWriter()
        a.string(1, attr.key)
        a.string(2, attr.value)
        a.varint(3, 1 if attr.index else 0)
        e.message(2, a.finish())
    return e.finish()


def decode_event(raw: bytes) -> Event:
    ef = ProtoReader(raw).to_dict()
    attrs = []
    for araw in ef.get(2, []):
        af = ProtoReader(araw).to_dict()
        attrs.append(
            EventAttribute(
                key=bytes(af.get(1, [b""])[0]).decode(),
                value=bytes(af.get(2, [b""])[0]).decode(),
                index=bool(af.get(3, [0])[0]),
            )
        )
    return Event(type=bytes(ef.get(1, [b""])[0]).decode(), attributes=tuple(attrs))


@dataclass(frozen=True)
class ValidatorUpdate:
    """(pubkey, power) delta from the app (abci ValidatorUpdate)."""

    pub_key_type: str
    pub_key_bytes: bytes
    power: int


@dataclass(frozen=True)
class ExecTxResult:
    """Result of executing one tx in FinalizeBlock (abci ExecTxResult)."""

    code: int = CODE_TYPE_OK
    data: bytes = b""
    log: str = ""
    info: str = ""
    gas_wanted: int = 0
    gas_used: int = 0
    events: tuple[Event, ...] = ()
    codespace: str = ""

    @property
    def is_ok(self) -> bool:
        return self.code == CODE_TYPE_OK

    def deterministic_encode(self) -> bytes:
        """Encoding of the deterministic subset only (code, data, gas),
        used for Header.last_results_hash (reference:
        types/results.go deterministicExecTxResult)."""
        w = ProtoWriter()
        w.varint(1, self.code)
        w.bytes_(2, self.data)
        w.varint(5, self.gas_wanted & 0xFFFFFFFFFFFFFFFF)
        w.varint(6, self.gas_used & 0xFFFFFFFFFFFFFFFF)
        return w.finish()

    def encode(self) -> bytes:
        """Full wire/persistent encoding — one spec shared with the
        socket protocol (abci/codec)."""
        from cometbft_tpu_torch.abci import codec

        return codec.encode_msg(self)

    @classmethod
    def decode(cls, data: bytes) -> "ExecTxResult":
        from cometbft_tpu_torch.abci import codec

        return codec.decode_msg(cls, data)


def results_hash(results: list[ExecTxResult]) -> bytes:
    """Merkle root over deterministic tx-result encodings — the value of
    Header.last_results_hash (types/results.go TxResults.Hash)."""
    from cometbft_tpu_torch.crypto import merkle

    return merkle.hash_from_byte_slices(
        [r.deterministic_encode() for r in results]
    )


# -- requests/responses ------------------------------------------------

@dataclass(frozen=True)
class InfoRequest:
    version: str = ""
    block_version: int = 0
    p2p_version: int = 0
    abci_version: str = ""


@dataclass(frozen=True)
class InfoResponse:
    data: str = ""
    version: str = ""
    app_version: int = 0
    last_block_height: int = 0
    last_block_app_hash: bytes = b""


@dataclass(frozen=True)
class QueryRequest:
    data: bytes = b""
    path: str = ""
    height: int = 0
    prove: bool = False


@dataclass(frozen=True)
class ProofOp:
    """One step of a query proof chain (crypto/proof.proto ProofOp):
    opaque to the node, interpreted by the proof-verifying light RPC
    client against the verified header's app_hash."""

    type: str = ""
    key: bytes = b""
    data: bytes = b""


@dataclass(frozen=True)
class QueryResponse:
    code: int = CODE_TYPE_OK
    log: str = ""
    info: str = ""
    index: int = 0
    key: bytes = b""
    value: bytes = b""
    proof_ops: tuple = ()
    height: int = 0
    codespace: str = ""


@dataclass(frozen=True)
class CheckTxRequest:
    tx: bytes
    type: int = CHECK_TX_TYPE_CHECK


@dataclass(frozen=True)
class CheckTxResponse:
    code: int = CODE_TYPE_OK
    data: bytes = b""
    log: str = ""
    info: str = ""
    gas_wanted: int = 0
    gas_used: int = 0
    events: tuple = ()
    codespace: str = ""

    @property
    def is_ok(self) -> bool:
        return self.code == CODE_TYPE_OK


@dataclass(frozen=True)
class InitChainRequest:
    time_ns: int = 0
    chain_id: str = ""
    consensus_params: object | None = None
    validators: tuple[ValidatorUpdate, ...] = ()
    app_state_bytes: bytes = b""
    initial_height: int = 1


@dataclass(frozen=True)
class InitChainResponse:
    consensus_params: object | None = None
    validators: tuple[ValidatorUpdate, ...] = ()
    app_hash: bytes = b""


@dataclass(frozen=True)
class ExtendedVoteInfo:
    """(types.proto ExtendedVoteInfo)"""
    validator_address: bytes = b""
    validator_power: int = 0
    vote_extension: bytes = b""
    extension_signature: bytes = b""
    block_id_flag: int = 0


@dataclass(frozen=True)
class ExtendedCommitInfo:
    """(types.proto ExtendedCommitInfo)"""
    round: int = 0
    votes: tuple = ()


@dataclass(frozen=True)
class PrepareProposalRequest:
    max_tx_bytes: int = 0
    txs: tuple[bytes, ...] = ()
    local_last_commit: object | None = None
    misbehavior: tuple = ()
    height: int = 0
    time_ns: int = 0
    next_validators_hash: bytes = b""
    proposer_address: bytes = b""


@dataclass(frozen=True)
class PrepareProposalResponse:
    txs: tuple[bytes, ...] = ()


@dataclass(frozen=True)
class ProcessProposalRequest:
    txs: tuple[bytes, ...] = ()
    proposed_last_commit: object | None = None
    misbehavior: tuple = ()
    hash: bytes = b""
    height: int = 0
    time_ns: int = 0
    next_validators_hash: bytes = b""
    proposer_address: bytes = b""


@dataclass(frozen=True)
class ProcessProposalResponse:
    status: ProposalStatus = ProposalStatus.UNKNOWN

    @property
    def is_accepted(self) -> bool:
        return self.status == ProposalStatus.ACCEPT


@dataclass(frozen=True)
class ExtendVoteRequest:
    hash: bytes = b""
    height: int = 0
    round: int = 0
    time_ns: int = 0
    txs: tuple[bytes, ...] = ()
    proposed_last_commit: object | None = None
    misbehavior: tuple = ()
    next_validators_hash: bytes = b""
    proposer_address: bytes = b""


@dataclass(frozen=True)
class ExtendVoteResponse:
    vote_extension: bytes = b""


@dataclass(frozen=True)
class VerifyVoteExtensionRequest:
    hash: bytes = b""
    validator_address: bytes = b""
    height: int = 0
    vote_extension: bytes = b""


@dataclass(frozen=True)
class VerifyVoteExtensionResponse:
    status: VerifyStatus = VerifyStatus.UNKNOWN

    @property
    def is_accepted(self) -> bool:
        return self.status == VerifyStatus.ACCEPT


@dataclass(frozen=True)
class CommitInfo:
    """Last-commit votes forwarded to the app (abci CommitInfo)."""

    round: int = 0
    votes: tuple["VoteInfo", ...] = ()


@dataclass(frozen=True)
class VoteInfo:
    validator_address: bytes
    validator_power: int
    block_id_flag: int


@dataclass(frozen=True)
class Misbehavior:
    """Evidence forwarded to the app (abci Misbehavior)."""

    type: int  # 1 duplicate vote, 2 light client attack
    validator_address: bytes
    validator_power: int
    height: int
    time_ns: int
    total_voting_power: int


MISBEHAVIOR_DUPLICATE_VOTE = 1
MISBEHAVIOR_LIGHT_CLIENT_ATTACK = 2


@dataclass(frozen=True)
class FinalizeBlockRequest:
    txs: tuple[bytes, ...] = ()
    decided_last_commit: CommitInfo = field(default_factory=CommitInfo)
    misbehavior: tuple[Misbehavior, ...] = ()
    hash: bytes = b""
    height: int = 0
    time_ns: int = 0
    next_validators_hash: bytes = b""
    proposer_address: bytes = b""
    syncing_to_height: int = 0


@dataclass(frozen=True)
class FinalizeBlockResponse:
    events: tuple[Event, ...] = ()
    tx_results: tuple[ExecTxResult, ...] = ()
    validator_updates: tuple[ValidatorUpdate, ...] = ()
    consensus_param_updates: object | None = None
    app_hash: bytes = b""
    next_block_delay_ns: int = 0

    def encode(self) -> bytes:
        """Persistent encoding for the state store (ABCIResponses) —
        one spec shared with the socket protocol (abci/codec), so the
        store format and the wire format cannot diverge."""
        from cometbft_tpu_torch.abci import codec

        return codec.encode_msg(self)

    @classmethod
    def decode(cls, data: bytes) -> "FinalizeBlockResponse":
        from cometbft_tpu_torch.abci import codec

        return codec.decode_msg(cls, data)


@dataclass(frozen=True)
class CommitResponse:
    retain_height: int = 0


@dataclass(frozen=True)
class Snapshot:
    height: int = 0
    format: int = 0
    chunks: int = 0
    hash: bytes = b""
    metadata: bytes = b""


@dataclass(frozen=True)
class ListSnapshotsResponse:
    snapshots: tuple[Snapshot, ...] = ()


@dataclass(frozen=True)
class OfferSnapshotRequest:
    snapshot: Snapshot | None = None
    app_hash: bytes = b""


@dataclass(frozen=True)
class OfferSnapshotResponse:
    result: OfferSnapshotResult = OfferSnapshotResult.UNKNOWN


@dataclass(frozen=True)
class LoadSnapshotChunkRequest:
    height: int = 0
    format: int = 0
    chunk: int = 0


@dataclass(frozen=True)
class LoadSnapshotChunkResponse:
    chunk: bytes = b""


@dataclass(frozen=True)
class ApplySnapshotChunkRequest:
    index: int = 0
    chunk: bytes = b""
    sender: str = ""


@dataclass(frozen=True)
class ApplySnapshotChunkResponse:
    result: ApplySnapshotChunkResult = ApplySnapshotChunkResult.UNKNOWN
    refetch_chunks: tuple[int, ...] = ()
    reject_senders: tuple[str, ...] = ()


class Application:
    """Base application: every method has a sane no-op default, so apps
    override only what they need (abci/types/application.go BaseApplication).
    """

    def info(self, req: InfoRequest) -> InfoResponse:
        return InfoResponse()

    def query(self, req: QueryRequest) -> QueryResponse:
        return QueryResponse()

    def check_tx(self, req: CheckTxRequest) -> CheckTxResponse:
        return CheckTxResponse()

    def init_chain(self, req: InitChainRequest) -> InitChainResponse:
        return InitChainResponse()

    def prepare_proposal(
        self, req: PrepareProposalRequest
    ) -> PrepareProposalResponse:
        # Default: include txs up to the byte limit (reference default).
        total, txs = 0, []
        for tx in req.txs:
            if req.max_tx_bytes > 0 and total + len(tx) > req.max_tx_bytes:
                break
            total += len(tx)
            txs.append(tx)
        return PrepareProposalResponse(txs=tuple(txs))

    def process_proposal(
        self, req: ProcessProposalRequest
    ) -> ProcessProposalResponse:
        return ProcessProposalResponse(status=ProposalStatus.ACCEPT)

    def extend_vote(self, req: ExtendVoteRequest) -> ExtendVoteResponse:
        return ExtendVoteResponse()

    def verify_vote_extension(
        self, req: VerifyVoteExtensionRequest
    ) -> VerifyVoteExtensionResponse:
        return VerifyVoteExtensionResponse(status=VerifyStatus.ACCEPT)

    def finalize_block(
        self, req: FinalizeBlockRequest
    ) -> FinalizeBlockResponse:
        return FinalizeBlockResponse(
            tx_results=tuple(ExecTxResult() for _ in req.txs)
        )

    def commit(self) -> CommitResponse:
        return CommitResponse()

    def list_snapshots(self) -> ListSnapshotsResponse:
        return ListSnapshotsResponse()

    def offer_snapshot(self, req: OfferSnapshotRequest) -> OfferSnapshotResponse:
        return OfferSnapshotResponse()

    def load_snapshot_chunk(
        self, req: LoadSnapshotChunkRequest
    ) -> LoadSnapshotChunkResponse:
        return LoadSnapshotChunkResponse()

    def apply_snapshot_chunk(
        self, req: ApplySnapshotChunkRequest
    ) -> ApplySnapshotChunkResponse:
        return ApplySnapshotChunkResponse(
            result=ApplySnapshotChunkResult.ACCEPT
        )
