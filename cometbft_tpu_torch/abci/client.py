"""ABCI socket client — drive an external application process
(a copy of cometbft_tpu/abci/client.py; reference:
abci/client/socket_client.go:31).

One client = one socket = one logical ABCI connection; the proxy layer
creates four of them (consensus/mempool/query/snapshot) so a slow
CheckTx on the mempool connection never blocks FinalizeBlock on the
consensus connection — process-boundary parity with the in-process
4-connection model.

Call model: synchronous request/response per call under a per-client
lock (the reference pipelines asynchronously and flushes; the four
independent sockets preserve the concurrency that matters while keeping
failure semantics simple — any transport error latches the client dead,
mirroring socket_client.go StopForError).

Where the port departs from its reference: the per-request deadline is
the argument ``request_timeout`` (seconds, 0 = none, the default); the
reference reads ``CMT_ABCI_REQUEST_TIMEOUT`` when it is not given.
"""

from __future__ import annotations

import socket
import threading
import time

from cometbft_tpu_torch.abci import codec
from cometbft_tpu_torch.abci import types as T
from cometbft_tpu_torch.abci.server import MAX_MSG_SIZE, parse_addr
# One error type across local and remote clients, so callers catching
# AbciClientError behind the AppConns interface see both.
from cometbft_tpu_torch.proxy import AbciClientError
from cometbft_tpu_torch.utils.log import Logger, default_logger
from cometbft_tpu_torch.utils.protoio import encode_uvarint, read_uvarint_from
from cometbft_tpu_torch.utils import sync as cmtsync
from cometbft_tpu_torch.utils import trustguard


class SocketClient:
    """(abci/client/socket_client.go socketClient)"""

    def __init__(
        self,
        addr: str,
        connect_timeout: float = 10.0,
        request_timeout: float = 0.0,
        logger: Logger | None = None,
    ):
        self.addr = addr
        self.logger = logger or default_logger().with_fields(
            module="abci-client"
        )
        self._lock = cmtsync.Mutex()
        self._sock: socket.socket | None = None
        self._file = None
        self._error: BaseException | None = None
        self._closed = False
        self._connect_timeout = connect_timeout
        # Optional per-request deadline so a hung external app can be
        # surfaced as AbciClientError instead of blocking forever. Off
        # by default (0), matching the reference socket client, which
        # blocks indefinitely per request — a legitimately slow
        # FinalizeBlock (large replay, heavy app) must not kill the
        # connection.
        self._request_timeout = request_timeout

    def ensure_connected(self) -> None:
        """Connect lazily: construction never blocks (the node builds
        its proxy in __init__; the external app may start later —
        socket_client.go connects in OnStart for the same reason)."""
        with self._lock:
            self._ensure_connected_locked()

    def _ensure_connected_locked(self) -> None:
        if self._sock is not None or self._closed:
            return
        self._connect(self._connect_timeout)

    def _connect(self, timeout: float) -> None:
        kind, target = parse_addr(self.addr)
        deadline = time.monotonic() + timeout
        last_exc: Exception | None = None
        while time.monotonic() < deadline:
            try:
                if kind == "unix":
                    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                    s.connect(target)  # blocking ok: abci_execute — lazy (re)connect is the round-trip's cold path; no progress without the app
                else:
                    s = socket.create_connection(target, timeout=5.0)  # blocking ok: abci_execute — lazy (re)connect is the round-trip's cold path; no progress without the app
                if self._request_timeout > 0:
                    s.settimeout(self._request_timeout)
                else:
                    s.settimeout(None)
                self._sock = s
                self._file = s.makefile("rb")
                return
            except OSError as exc:
                last_exc = exc
                time.sleep(0.1)  # blocking ok: abci_execute — deadline-bounded connect retry backoff
        raise AbciClientError(
            f"cannot connect to ABCI app at {self.addr}: {last_exc}"
        ) from last_exc

    def close(self) -> None:
        with self._lock:
            self._closed = True
            s, self._sock = self._sock, None
            if s is not None:
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                s.close()
            if self._file is not None:
                self._file.close()
                self._file = None

    def error(self) -> BaseException | None:
        return self._error

    # -- request machinery ----------------------------------------------

    def _roundtrip(self, req, want: type):
        with self._lock:
            if self._error is not None:
                raise AbciClientError(
                    f"abci client is dead: {self._error}"
                ) from self._error
            if self._closed:
                raise AbciClientError("abci client is closed")
            try:
                self._ensure_connected_locked()
                payload = codec.encode_request(req)
                self._sock.sendall(  # blocking ok: abci_execute — the ABCI round-trip IS the stage (exec/apply_block span times it)
                    encode_uvarint(len(payload)) + payload
                )
                resp = self._read_response()
            except BaseException as exc:
                self._error = exc
                raise AbciClientError(
                    f"abci connection failed: {exc!r}"
                ) from exc
        if isinstance(resp, codec.ResponseException):
            err = AbciClientError(f"app exception: {resp.error}")
            self._error = err
            raise err
        if not isinstance(resp, want):
            err = AbciClientError(
                f"unexpected response {type(resp).__name__}, "
                f"wanted {want.__name__}"
            )
            self._error = err
            raise err
        return resp

    @trustguard.guarded_seam("abci_response")
    def _read_response(self):
        f = self._file

        def read_exact(n: int) -> bytes:
            data = f.read(n)
            if data is None or len(data) < n:
                raise EOFError("abci server closed the connection")
            return data

        size = read_uvarint_from(read_exact, max_value=MAX_MSG_SIZE)
        return codec.decode_response(read_exact(size))

    # -- Application surface (same shape as proxy._LocalClient) ----------

    def echo(self, message: str) -> str:
        return self._roundtrip(codec.Echo(message=message), codec.Echo).message

    def flush(self) -> None:
        self._roundtrip(codec.Flush(), codec.Flush)

    def info(self, req: T.InfoRequest) -> T.InfoResponse:
        return self._roundtrip(req, T.InfoResponse)

    def query(self, req: T.QueryRequest) -> T.QueryResponse:
        return self._roundtrip(req, T.QueryResponse)

    def check_tx(self, req: T.CheckTxRequest) -> T.CheckTxResponse:
        return self._roundtrip(req, T.CheckTxResponse)

    def init_chain(self, req: T.InitChainRequest) -> T.InitChainResponse:
        return self._roundtrip(req, T.InitChainResponse)

    def prepare_proposal(
        self, req: T.PrepareProposalRequest
    ) -> T.PrepareProposalResponse:
        return self._roundtrip(req, T.PrepareProposalResponse)

    def process_proposal(
        self, req: T.ProcessProposalRequest
    ) -> T.ProcessProposalResponse:
        return self._roundtrip(req, T.ProcessProposalResponse)

    def extend_vote(self, req: T.ExtendVoteRequest) -> T.ExtendVoteResponse:
        return self._roundtrip(req, T.ExtendVoteResponse)

    def verify_vote_extension(
        self, req: T.VerifyVoteExtensionRequest
    ) -> T.VerifyVoteExtensionResponse:
        return self._roundtrip(req, T.VerifyVoteExtensionResponse)

    def finalize_block(
        self, req: T.FinalizeBlockRequest
    ) -> T.FinalizeBlockResponse:
        return self._roundtrip(req, T.FinalizeBlockResponse)

    def commit(self) -> T.CommitResponse:
        return self._roundtrip(codec.CommitRequest(), T.CommitResponse)

    def list_snapshots(self) -> T.ListSnapshotsResponse:
        return self._roundtrip(
            codec.ListSnapshotsRequest(), T.ListSnapshotsResponse
        )

    def offer_snapshot(
        self, req: T.OfferSnapshotRequest
    ) -> T.OfferSnapshotResponse:
        return self._roundtrip(req, T.OfferSnapshotResponse)

    def load_snapshot_chunk(
        self, req: T.LoadSnapshotChunkRequest
    ) -> T.LoadSnapshotChunkResponse:
        return self._roundtrip(req, T.LoadSnapshotChunkResponse)

    def apply_snapshot_chunk(
        self, req: T.ApplySnapshotChunkRequest
    ) -> T.ApplySnapshotChunkResponse:
        return self._roundtrip(req, T.ApplySnapshotChunkResponse)


__all__ = ["AbciClientError", "SocketClient"]
