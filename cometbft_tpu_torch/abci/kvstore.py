"""In-process key-value example application (a copy of
cometbft_tpu/abci/kvstore.py; reference:
abci/example/kvstore/kvstore.go:36).

The universal fake backend for tests and the e2e harness: txs are
``key=value`` pairs; ``val:<pubkey-b64>!<power>`` txs update the
validator set.  State is height + a sorted KV map with a deterministic
app hash, persisted through the node's KV abstraction so crash/replay
tests exercise real recovery.  Snapshot methods serve the full state in
fixed-size chunks for state sync.
"""

from __future__ import annotations

import base64
import hashlib
import json

from cometbft_tpu_torch.crypto import merkle
from cometbft_tpu_torch.crypto.merkle import kv_leaf as state_leaf
from cometbft_tpu_torch.abci.types import (
    Application,
    ApplySnapshotChunkRequest,
    ApplySnapshotChunkResponse,
    ApplySnapshotChunkResult,
    CheckTxRequest,
    CheckTxResponse,
    CommitResponse,
    Event,
    EventAttribute,
    ExecTxResult,
    FinalizeBlockRequest,
    FinalizeBlockResponse,
    InfoRequest,
    InfoResponse,
    InitChainRequest,
    InitChainResponse,
    ListSnapshotsResponse,
    LoadSnapshotChunkRequest,
    LoadSnapshotChunkResponse,
    OfferSnapshotRequest,
    OfferSnapshotResponse,
    OfferSnapshotResult,
    ProofOp,
    ProcessProposalRequest,
    ProcessProposalResponse,
    ProposalStatus,
    QueryRequest,
    QueryResponse,
    Snapshot,
    ValidatorUpdate,
)
from cometbft_tpu_torch.utils.db import DB, MemDB

VALIDATOR_TX_PREFIX = "val:"
SNAPSHOT_CHUNK_SIZE = 65536

_CODE_INVALID_FORMAT = 1
_CODE_INVALID_POWER = 2
_CODE_BAD_SIGNATURE = 3


class KVStoreApp(Application):
    """kvstore.go Application — the reference's canonical test app."""

    def __init__(self, db: DB | None = None, snapshot_interval: int = 0):
        self._db = db if db is not None else MemDB()
        self._snapshot_interval = snapshot_interval
        self._height = 0
        self._app_hash = b""
        self._kv: dict[str, str] = {}
        self._val_updates: list[ValidatorUpdate] = []
        self._validators: dict[str, int] = {}  # pubkey b64 -> power
        self._snapshots: dict[int, bytes] = {}
        self._restore_buf: list[bytes] = []
        self._restore_target: Snapshot | None = None
        self._load()

    # -- persistence ---------------------------------------------------

    def _load(self) -> None:
        raw = self._db.get(b"kvstore:state")
        if raw is None:
            return
        st = json.loads(raw.decode())
        self._height = st["height"]
        self._kv = st["kv"]
        self._validators = st.get("validators", {})
        self._app_hash = bytes.fromhex(st["app_hash"])

    def _persist(self) -> None:
        self._db.set(
            b"kvstore:state",
            json.dumps(
                {
                    "height": self._height,
                    "kv": self._kv,
                    "validators": self._validators,
                    "app_hash": self._app_hash.hex(),
                },
                sort_keys=True,
            ).encode(),
        )

    def _state_leaves(self) -> list[bytes]:
        """Deterministic leaf list: one length-prefixed k/v pair per
        sorted key. The app hash is the RFC-6962 merkle root over
        these, so /abci_query can serve inclusion proofs that a
        proof-verifying light RPC client checks against the verified
        header's app_hash (light/rpc.py)."""
        return [
            state_leaf(k.encode(), self._kv[k].encode())
            for k in sorted(self._kv)
        ]

    def _compute_hash(self) -> bytes:
        return merkle.hash_from_byte_slices(self._state_leaves())

    # -- tx parsing ----------------------------------------------------

    @staticmethod
    def _parse_validator_tx(tx: str) -> tuple[bytes, int] | None:
        """``val:<pubkey-b64>!<power>`` → (pubkey_bytes, power)."""
        body = tx[len(VALIDATOR_TX_PREFIX):]
        if "!" not in body:
            return None
        key_b64, _, power_s = body.partition("!")
        try:
            pub = base64.b64decode(key_b64, validate=True)
            power = int(power_s)
        except (ValueError, TypeError):
            return None
        if len(pub) != 32:
            return None
        return pub, power

    @staticmethod
    def _open_envelope(
        tx: bytes,
    ) -> tuple[bytes, CheckTxResponse | None]:
        """``(payload, error)`` for the mempool's signed-admission
        envelope (mempool/ingest.py).  The signature is VERIFIED here,
        not just stripped: the mempool pre-checks it at admission, but
        a byzantine proposer can put a forged envelope straight into a
        block — the admission guarantee must survive block inclusion,
        so process_proposal/execute re-check it at the app seam.  A
        plain tx returns ``(tx, None)``; a malformed or forged
        envelope returns the rejection the caller must surface."""
        from cometbft_tpu_torch.crypto.ed25519 import Ed25519PubKey
        from cometbft_tpu_torch.mempool import ingest as _ingest

        try:
            parsed = _ingest.parse_signed_tx(tx)
        except _ingest.MalformedSignedTx as exc:
            return tx, CheckTxResponse(
                code=_CODE_BAD_SIGNATURE, log=str(exc)
            )
        if parsed is None:
            return tx, None
        pub, sig, payload = parsed
        try:
            pk = Ed25519PubKey(pub)
        except ValueError as exc:
            return payload, CheckTxResponse(
                code=_CODE_BAD_SIGNATURE, log=str(exc)
            )
        if not pk.verify_signature(_ingest.sign_bytes(payload), sig):
            return payload, CheckTxResponse(
                code=_CODE_BAD_SIGNATURE,
                log="invalid admission signature",
            )
        return payload, None

    def _check_tx(self, tx: bytes) -> CheckTxResponse:
        tx, env_err = self._open_envelope(tx)
        if env_err is not None:
            return env_err
        return self._check_payload(tx)

    def _check_payload(self, tx: bytes) -> CheckTxResponse:
        try:
            text = tx.decode()
        except UnicodeDecodeError:
            return CheckTxResponse(
                code=_CODE_INVALID_FORMAT, log="tx is not utf-8"
            )
        if text.startswith(VALIDATOR_TX_PREFIX):
            parsed = self._parse_validator_tx(text)
            if parsed is None:
                return CheckTxResponse(
                    code=_CODE_INVALID_FORMAT,
                    log="expected val:<pubkey-b64>!<power>",
                )
            if parsed[1] < 0:
                return CheckTxResponse(
                    code=_CODE_INVALID_POWER, log="negative power"
                )
            return CheckTxResponse(gas_wanted=1)
        if "=" not in text:
            return CheckTxResponse(
                code=_CODE_INVALID_FORMAT, log="expected key=value"
            )
        return CheckTxResponse(gas_wanted=1)

    # -- abci ----------------------------------------------------------

    def info(self, req: InfoRequest) -> InfoResponse:
        return InfoResponse(
            data="kvstore",
            version="1.0.0",
            last_block_height=self._height,
            last_block_app_hash=self._app_hash,
        )

    def init_chain(self, req: InitChainRequest) -> InitChainResponse:
        for vu in req.validators:
            self._validators[base64.b64encode(vu.pub_key_bytes).decode()] = (
                vu.power
            )
        self._height = 0
        self._app_hash = self._compute_hash()
        self._persist()
        return InitChainResponse(app_hash=self._app_hash)

    def check_tx(self, req: CheckTxRequest) -> CheckTxResponse:
        return self._check_tx(req.tx)

    def process_proposal(
        self, req: ProcessProposalRequest
    ) -> ProcessProposalResponse:
        for tx in req.txs:
            if self._check_tx(tx).code != 0:
                return ProcessProposalResponse(status=ProposalStatus.REJECT)
        return ProcessProposalResponse(status=ProposalStatus.ACCEPT)

    def finalize_block(
        self, req: FinalizeBlockRequest
    ) -> FinalizeBlockResponse:
        results = []
        self._val_updates = []
        for tx in req.txs:
            results.append(self._exec_tx(tx))
        self._height = req.height
        self._app_hash = self._compute_hash()
        return FinalizeBlockResponse(
            tx_results=tuple(results),
            validator_updates=tuple(self._val_updates),
            app_hash=self._app_hash,
        )

    def _exec_tx(self, tx: bytes) -> ExecTxResult:
        # open (and verify) the envelope ONCE; check + execute the
        # payload it carried
        payload, env_err = self._open_envelope(tx)
        check = env_err or self._check_payload(payload)
        if check.code != 0:
            return ExecTxResult(code=check.code, log=check.log)
        text = payload.decode()
        if text.startswith(VALIDATOR_TX_PREFIX):
            pub, power = self._parse_validator_tx(text)
            key = base64.b64encode(pub).decode()
            if power == 0:
                self._validators.pop(key, None)
            else:
                self._validators[key] = power
            self._val_updates.append(
                ValidatorUpdate(
                    pub_key_type="ed25519", pub_key_bytes=pub, power=power
                )
            )
            return ExecTxResult(
                data=b"", gas_used=1,
                events=(
                    Event(
                        type="val_update",
                        attributes=(
                            EventAttribute(key="pubkey", value=key),
                            EventAttribute(key="power", value=str(power)),
                        ),
                    ),
                ),
            )
        key, _, value = text.partition("=")
        self._kv[key] = value
        return ExecTxResult(
            data=value.encode(),
            gas_used=1,
            events=(
                Event(
                    type="app",
                    attributes=(
                        EventAttribute(key="key", value=key),
                        EventAttribute(key="noindex_key", value=key, index=False),
                    ),
                ),
            ),
        )

    def commit(self) -> CommitResponse:
        self._persist()
        if (
            self._snapshot_interval > 0
            and self._height > 0
            and self._height % self._snapshot_interval == 0
        ):
            self._take_snapshot()
        return CommitResponse(retain_height=0)

    def query(self, req: QueryRequest) -> QueryResponse:
        if req.path == "/height":
            return QueryResponse(
                value=str(self._height).encode(), height=self._height
            )
        try:
            key = req.data.decode()
            value = self._kv.get(key)
        except UnicodeDecodeError:
            # CheckTx only admits utf-8 "k=v" txs, so a non-utf-8 key
            # can never have been stored — absent, not an error
            value = None
        if value is None:
            return QueryResponse(
                code=0, log="does not exist", key=req.data, height=self._height
            )
        proof_ops: tuple = ()
        if req.prove:
            keys = sorted(self._kv)
            leaves = [
                state_leaf(k.encode(), self._kv[k].encode()) for k in keys
            ]
            _, proofs = merkle.proofs_from_byte_slices(leaves)
            proof_ops = (
                ProofOp(
                    type=merkle.KV_PROOF_OP_TYPE,
                    key=req.data,
                    data=merkle.proof_to_bytes(proofs[keys.index(key)]),
                ),
            )
        return QueryResponse(
            key=req.data,
            value=value.encode(),
            height=self._height,
            proof_ops=proof_ops,
        )

    # -- snapshots -----------------------------------------------------

    def _take_snapshot(self) -> None:
        blob = json.dumps(
            {"height": self._height, "kv": self._kv,
             "validators": self._validators},
            sort_keys=True,
        ).encode()
        self._snapshots[self._height] = blob
        # keep only the most recent few
        for h in sorted(self._snapshots)[:-3]:
            del self._snapshots[h]

    def list_snapshots(self) -> ListSnapshotsResponse:
        snaps = []
        for h, blob in sorted(self._snapshots.items()):
            nchunks = max(1, -(-len(blob) // SNAPSHOT_CHUNK_SIZE))
            snaps.append(
                Snapshot(
                    height=h,
                    format=1,
                    chunks=nchunks,
                    hash=hashlib.sha256(blob).digest(),
                )
            )
        return ListSnapshotsResponse(snapshots=tuple(snaps))

    def load_snapshot_chunk(
        self, req: LoadSnapshotChunkRequest
    ) -> LoadSnapshotChunkResponse:
        blob = self._snapshots.get(req.height)
        if blob is None or req.format != 1:
            return LoadSnapshotChunkResponse()
        start = req.chunk * SNAPSHOT_CHUNK_SIZE
        return LoadSnapshotChunkResponse(
            chunk=blob[start : start + SNAPSHOT_CHUNK_SIZE]
        )

    def offer_snapshot(self, req: OfferSnapshotRequest) -> OfferSnapshotResponse:
        if req.snapshot is None or req.snapshot.format != 1:
            return OfferSnapshotResponse(result=OfferSnapshotResult.REJECT_FORMAT)
        self._restore_target = req.snapshot
        self._restore_buf = []
        return OfferSnapshotResponse(result=OfferSnapshotResult.ACCEPT)

    def apply_snapshot_chunk(
        self, req: ApplySnapshotChunkRequest
    ) -> ApplySnapshotChunkResponse:
        if self._restore_target is None:
            return ApplySnapshotChunkResponse(
                result=ApplySnapshotChunkResult.ABORT
            )
        self._restore_buf.append(req.chunk)
        if len(self._restore_buf) < self._restore_target.chunks:
            return ApplySnapshotChunkResponse(
                result=ApplySnapshotChunkResult.ACCEPT
            )
        blob = b"".join(self._restore_buf)
        if hashlib.sha256(blob).digest() != self._restore_target.hash:
            self._restore_buf = []
            return ApplySnapshotChunkResponse(
                result=ApplySnapshotChunkResult.REJECT_SNAPSHOT
            )
        st = json.loads(blob.decode())
        self._height = st["height"]
        self._kv = st["kv"]
        self._validators = st.get("validators", {})
        self._app_hash = self._compute_hash()
        self._persist()
        self._restore_target = None
        self._restore_buf = []
        return ApplySnapshotChunkResponse(
            result=ApplySnapshotChunkResult.ACCEPT
        )

    # -- test hooks ----------------------------------------------------

    @property
    def height(self) -> int:
        return self._height

    @property
    def app_hash(self) -> bytes:
        return self._app_hash

    def get(self, key: str) -> str | None:
        return self._kv.get(key)
