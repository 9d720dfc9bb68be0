"""ABCI over gRPC — the reference's third ABCI connection mode (a copy
of cometbft_tpu/abci/grpc.py; reference: abci/client/grpc_client.go,
abci/server/grpc_server.go).

Server side wraps an :class:`~cometbft_tpu_torch.abci.types.Application` and
exposes one unary gRPC method per ABCI call; the client mirrors the
SocketClient surface so the proxy layer can swap transports freely
(proxy/client.go DefaultClientCreator "grpc" branch).

Messages on the wire use abci/codec.py, which is proto3-faithful to
proto/cometbft/abci/v1/types.proto (upstream field numbers, plain
varint ints, nested Timestamp/Duration/ConsensusParams messages) — see
the codec module docs and tests/test_abci_wire_compat.py for the
byte-level compatibility proof against the real protobuf runtime.

This is the one module of the port that imports ``grpc``; the proxy
imports it only for a ``grpc://`` address.  Where the port departs
from its reference: the per-request deadline is the argument
``request_timeout`` (seconds, None = none); the reference reads
``CMT_ABCI_REQUEST_TIMEOUT`` when it is not given.
"""

from __future__ import annotations

from concurrent import futures

import grpc

from cometbft_tpu_torch.abci import codec
from cometbft_tpu_torch.abci import types as T
from cometbft_tpu_torch.proxy import AbciClientError
from cometbft_tpu_torch.utils.log import Logger, default_logger
from cometbft_tpu_torch.utils.service import BaseService
from cometbft_tpu_torch.utils import sync as cmtsync

SERVICE = "cometbft.abci.v1.ABCIService"

# method -> (request type, response type); Echo/Flush use the codec's
# private envelope messages
_METHODS = {
    "Echo": (codec.Echo, codec.Echo),
    "Flush": (codec.Flush, codec.Flush),
    "Info": (T.InfoRequest, T.InfoResponse),
    "Query": (T.QueryRequest, T.QueryResponse),
    "CheckTx": (T.CheckTxRequest, T.CheckTxResponse),
    "InitChain": (T.InitChainRequest, T.InitChainResponse),
    "PrepareProposal": (T.PrepareProposalRequest, T.PrepareProposalResponse),
    "ProcessProposal": (T.ProcessProposalRequest, T.ProcessProposalResponse),
    "ExtendVote": (T.ExtendVoteRequest, T.ExtendVoteResponse),
    "VerifyVoteExtension": (
        T.VerifyVoteExtensionRequest,
        T.VerifyVoteExtensionResponse,
    ),
    "FinalizeBlock": (T.FinalizeBlockRequest, T.FinalizeBlockResponse),
    "Commit": (codec.CommitRequest, T.CommitResponse),
    "ListSnapshots": (codec.ListSnapshotsRequest, T.ListSnapshotsResponse),
    "OfferSnapshot": (T.OfferSnapshotRequest, T.OfferSnapshotResponse),
    "LoadSnapshotChunk": (
        T.LoadSnapshotChunkRequest,
        T.LoadSnapshotChunkResponse,
    ),
    "ApplySnapshotChunk": (
        T.ApplySnapshotChunkRequest,
        T.ApplySnapshotChunkResponse,
    ),
}


def _parse_grpc_addr(addr: str) -> str:
    for prefix in ("grpc://", "tcp://"):
        if addr.startswith(prefix):
            return addr[len(prefix):]
    return addr


class GrpcServer(BaseService):
    """Serve an Application over gRPC (abci/server/grpc_server.go)."""

    def __init__(
        self,
        app: T.Application,
        addr: str,
        max_workers: int = 8,
        logger: Logger | None = None,
    ):
        super().__init__(
            name="abci-grpc-server",
            logger=logger
            or default_logger().with_fields(module="abci-grpc-server"),
        )
        self.app = app
        self.addr = _parse_grpc_addr(addr)
        self._app_mtx = cmtsync.Mutex()
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers)
        )
        self._server.add_generic_rpc_handlers((self._handler(),))
        self.port = self._server.add_insecure_port(self.addr)

    def _handler(self) -> grpc.GenericRpcHandler:
        outer = self

        class Handler(grpc.GenericRpcHandler):
            def service(self, handler_call_details):
                path = handler_call_details.method  # "/pkg.Service/Method"
                service, _, method = path.lstrip("/").partition("/")
                if service != SERVICE or method not in _METHODS:
                    return None
                req_cls, _resp_cls = _METHODS[method]

                def unary(request: bytes, context):
                    try:
                        req = codec.decode_msg(req_cls, request)
                        resp = outer._call(method, req)
                        return codec.encode_msg(resp)
                    except Exception as exc:  # noqa: BLE001
                        outer.logger.error(
                            "abci grpc call failed",
                            method=method,
                            err=repr(exc),
                        )
                        context.abort(
                            grpc.StatusCode.INTERNAL, repr(exc)
                        )

                return grpc.unary_unary_rpc_method_handler(
                    unary,
                    request_deserializer=lambda b: b,
                    response_serializer=lambda b: b,
                )

        return Handler()

    def _call(self, method: str, req):
        """One app call; serialized like the sync local client so apps
        need no internal locking."""
        app = self.app
        with self._app_mtx:
            if method == "Echo":
                return codec.Echo(message=req.message)
            if method == "Flush":
                return codec.Flush()
            if method == "Commit":
                return app.commit()
            if method == "ListSnapshots":
                return app.list_snapshots()
            snake = "".join(
                ("_" + c.lower()) if c.isupper() else c for c in method
            ).lstrip("_")
            return getattr(app, snake)(req)

    def on_start(self) -> None:
        self._server.start()
        self.logger.info("abci grpc server listening", addr=self.addr,
                         port=self.port)

    def on_stop(self) -> None:
        self._server.stop(grace=1.0)


class GrpcClient:
    """ABCI gRPC client with the SocketClient surface
    (abci/client/grpc_client.go)."""

    def __init__(
        self,
        addr: str,
        connect_timeout: float = 10.0,
        request_timeout: float | None = None,
        logger: Logger | None = None,
    ):
        self.addr = _parse_grpc_addr(addr)
        self.logger = logger or default_logger().with_fields(
            module="abci-grpc-client"
        )
        self._connect_timeout = connect_timeout
        self._request_timeout = request_timeout
        self._channel: grpc.Channel | None = None
        self._lock = cmtsync.Mutex()
        self._closed = False
        self._error: BaseException | None = None

    def ensure_connected(self) -> None:
        with self._lock:
            self._ensure_locked()

    def _ensure_locked(self) -> None:
        if self._channel is not None or self._closed:
            return
        ch = grpc.insecure_channel(self.addr)
        try:
            grpc.channel_ready_future(ch).result(
                timeout=self._connect_timeout
            )
        except grpc.FutureTimeoutError as exc:
            ch.close()
            raise AbciClientError(
                f"cannot connect to ABCI gRPC app at {self.addr}"
            ) from exc
        self._channel = ch

    def error(self):
        """First fatal RPC error, or None (socket-client parity; the
        AppConns watcher polls this for fail-stop)."""
        return self._error

    def close(self) -> None:
        # Deliberately NOT taking self._lock: grpc.Channel.close() is
        # thread-safe and cancels in-flight RPCs, so a request hung in
        # _roundtrip (which holds the lock) can't wedge shutdown.
        self._closed = True
        ch = self._channel
        self._channel = None
        if ch is not None:
            ch.close()

    def _roundtrip(self, method: str, req):
        req_cls, resp_cls = _METHODS[method]
        if not isinstance(req, req_cls):
            raise AbciClientError(
                f"{method} wants {req_cls.__name__}, got {type(req).__name__}"
            )
        with self._lock:
            self._ensure_locked()
            if self._channel is None:
                raise AbciClientError("abci grpc client is closed")
            fn = self._channel.unary_unary(
                f"/{SERVICE}/{method}",
                request_serializer=lambda b: b,
                response_deserializer=lambda b: b,
            )
            try:
                raw = fn(
                    codec.encode_msg(req), timeout=self._request_timeout
                )
            except grpc.RpcError as exc:
                # latch for AppConns' fail-stop watcher (the socket
                # client's error() analog, abci/client.py)
                if self._error is None and not self._closed:
                    self._error = exc
                raise AbciClientError(
                    f"abci grpc call {method} failed: {exc}"
                ) from exc
        return codec.decode_msg(resp_cls, raw)

    # -- Application surface (same shape as abci.client.SocketClient) ---

    def echo(self, message: str) -> str:
        return self._roundtrip("Echo", codec.Echo(message=message)).message

    def flush(self) -> None:
        self._roundtrip("Flush", codec.Flush())

    def info(self, req: T.InfoRequest) -> T.InfoResponse:
        return self._roundtrip("Info", req)

    def query(self, req: T.QueryRequest) -> T.QueryResponse:
        return self._roundtrip("Query", req)

    def check_tx(self, req: T.CheckTxRequest) -> T.CheckTxResponse:
        return self._roundtrip("CheckTx", req)

    def init_chain(self, req: T.InitChainRequest) -> T.InitChainResponse:
        return self._roundtrip("InitChain", req)

    def prepare_proposal(
        self, req: T.PrepareProposalRequest
    ) -> T.PrepareProposalResponse:
        return self._roundtrip("PrepareProposal", req)

    def process_proposal(
        self, req: T.ProcessProposalRequest
    ) -> T.ProcessProposalResponse:
        return self._roundtrip("ProcessProposal", req)

    def extend_vote(self, req: T.ExtendVoteRequest) -> T.ExtendVoteResponse:
        return self._roundtrip("ExtendVote", req)

    def verify_vote_extension(
        self, req: T.VerifyVoteExtensionRequest
    ) -> T.VerifyVoteExtensionResponse:
        return self._roundtrip("VerifyVoteExtension", req)

    def finalize_block(
        self, req: T.FinalizeBlockRequest
    ) -> T.FinalizeBlockResponse:
        return self._roundtrip("FinalizeBlock", req)

    def commit(self) -> T.CommitResponse:
        return self._roundtrip("Commit", codec.CommitRequest())

    def list_snapshots(self) -> T.ListSnapshotsResponse:
        return self._roundtrip("ListSnapshots", codec.ListSnapshotsRequest())

    def offer_snapshot(
        self, req: T.OfferSnapshotRequest
    ) -> T.OfferSnapshotResponse:
        return self._roundtrip("OfferSnapshot", req)

    def load_snapshot_chunk(
        self, req: T.LoadSnapshotChunkRequest
    ) -> T.LoadSnapshotChunkResponse:
        return self._roundtrip("LoadSnapshotChunk", req)

    def apply_snapshot_chunk(
        self, req: T.ApplySnapshotChunkRequest
    ) -> T.ApplySnapshotChunkResponse:
        return self._roundtrip("ApplySnapshotChunk", req)
