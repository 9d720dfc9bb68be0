"""ABCI socket server — serve an application to an external node
process (a copy of cometbft_tpu/abci/server.py; reference:
abci/server/socket_server.go).

Framing: length-prefixed (uvarint) Request/Response envelopes
(abci/codec).  The node opens four connections (consensus, mempool,
query, snapshot); each connection is served by its own thread, with a
process-wide application lock serializing calls — the same model as the
reference's local-client mutex: correctness first, the app opts into
concurrency by running unsync (its own locking).

Address forms: ``tcp://host:port`` or ``unix:///path.sock``.

``main`` is the port's ``abci-cli kvstore``: ``python -m
cometbft_tpu_torch.abci.server --app kvstore --addr unix:///tmp/app.sock``.
The app is host code: the server never touches a card.
"""

from __future__ import annotations

import os
import socket
import threading

from cometbft_tpu_torch.abci import codec
from cometbft_tpu_torch.abci import types as T
from cometbft_tpu_torch.abci.types import Application
from cometbft_tpu_torch.utils.log import Logger, default_logger
from cometbft_tpu_torch.utils.protoio import encode_uvarint, read_uvarint_from
from cometbft_tpu_torch.utils.service import BaseService
from cometbft_tpu_torch.utils import sync as cmtsync

MAX_MSG_SIZE = 64 << 20  # generous: FinalizeBlock carries whole blocks


def parse_addr(addr: str) -> tuple[str, object]:
    """-> ("tcp", (host, port)) | ("unix", path)."""
    if addr.startswith("unix://"):
        return "unix", addr[len("unix://"):]
    if addr.startswith("tcp://"):
        hostport = addr[len("tcp://"):]
        host, _, port = hostport.rpartition(":")
        return "tcp", (host or "127.0.0.1", int(port))
    raise ValueError(f"unsupported ABCI address {addr!r}")


def _read_frame(sock_file) -> bytes | None:
    def read_exact(n: int) -> bytes:
        data = sock_file.read(n)
        if data is None or len(data) < n:
            raise EOFError
        return data

    try:
        size = read_uvarint_from(read_exact, max_value=MAX_MSG_SIZE)
        return read_exact(size)
    except EOFError:
        return None


def _write_frame(sock, payload: bytes) -> None:
    sock.sendall(encode_uvarint(len(payload)) + payload)


class SocketServer(BaseService):
    """(abci/server/socket_server.go SocketServer)"""

    def __init__(
        self,
        addr: str,
        app: Application,
        logger: Logger | None = None,
    ):
        super().__init__(name="abci-server")
        self.addr = addr
        self.app = app
        self.logger = logger or default_logger().with_fields(
            module="abci-server"
        )
        self._app_lock = cmtsync.Mutex()
        self._listener: socket.socket | None = None
        self._conns: list[socket.socket] = []
        self._conns_mtx = cmtsync.Mutex()
        self._unix_path: str | None = None

    # -- lifecycle -------------------------------------------------------

    def on_start(self) -> None:
        kind, target = parse_addr(self.addr)
        if kind == "unix":
            self._unix_path = target
            try:
                os.unlink(target)
            except FileNotFoundError:
                pass
            ls = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            ls.bind(target)
        else:
            ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            ls.bind(target)
        ls.listen(16)
        self._listener = ls
        threading.Thread(
            target=self._accept_loop, name="abci-accept", daemon=True
        ).start()
        self.logger.info("abci server listening", addr=self.addr)

    def on_stop(self) -> None:
        ls, self._listener = self._listener, None
        if ls is not None:
            try:
                ls.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            ls.close()
        with self._conns_mtx:
            conns, self._conns = self._conns, []
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            c.close()
        if self._unix_path:
            try:
                os.unlink(self._unix_path)
            except FileNotFoundError:
                pass

    @property
    def listen_addr(self) -> str:
        """Actual address (resolves tcp port 0)."""
        if self._listener is None:
            return self.addr
        kind, _ = parse_addr(self.addr)
        if kind == "unix":
            return self.addr
        host, port = self._listener.getsockname()[:2]
        return f"tcp://{host}:{port}"

    # -- serving ---------------------------------------------------------

    def _accept_loop(self) -> None:
        while self.is_running():
            ls = self._listener
            if ls is None:
                return
            try:
                conn, _ = ls.accept()
            except OSError:
                return
            with self._conns_mtx:
                self._conns.append(conn)
            if not self.is_running():
                # lost the race with on_stop: don't serve on a stopped app
                try:
                    conn.close()
                except OSError:
                    pass
                continue
            threading.Thread(
                target=self._serve_conn,
                args=(conn,),
                name="abci-conn",
                daemon=True,
            ).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        f = conn.makefile("rb")
        try:
            while self.is_running():
                frame = _read_frame(f)
                if frame is None:
                    return
                try:
                    req = codec.decode_request(frame)
                    resp = self._dispatch(req)
                except Exception as exc:  # noqa: BLE001
                    self.logger.error(
                        "abci request failed", err=repr(exc)
                    )
                    resp = codec.ResponseException(error=repr(exc))
                _write_frame(conn, codec.encode_response(resp))
        except (OSError, ValueError):
            pass
        finally:
            f.close()
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, req):
        """Request -> app call (socket_server.go handleRequest)."""
        app = self.app
        if isinstance(req, codec.Echo):
            return codec.Echo(message=req.message)
        if isinstance(req, codec.Flush):
            return codec.Flush()
        with self._app_lock:
            if isinstance(req, T.InfoRequest):
                return app.info(req)
            if isinstance(req, T.QueryRequest):
                return app.query(req)
            if isinstance(req, T.CheckTxRequest):
                return app.check_tx(req)
            if isinstance(req, T.InitChainRequest):
                return app.init_chain(req)
            if isinstance(req, T.PrepareProposalRequest):
                return app.prepare_proposal(req)
            if isinstance(req, T.ProcessProposalRequest):
                return app.process_proposal(req)
            if isinstance(req, T.ExtendVoteRequest):
                return app.extend_vote(req)
            if isinstance(req, T.VerifyVoteExtensionRequest):
                return app.verify_vote_extension(req)
            if isinstance(req, T.FinalizeBlockRequest):
                return app.finalize_block(req)
            if isinstance(req, codec.CommitRequest):
                return app.commit()
            if isinstance(req, codec.ListSnapshotsRequest):
                return app.list_snapshots()
            if isinstance(req, T.OfferSnapshotRequest):
                return app.offer_snapshot(req)
            if isinstance(req, T.LoadSnapshotChunkRequest):
                return app.load_snapshot_chunk(req)
            if isinstance(req, T.ApplySnapshotChunkRequest):
                return app.apply_snapshot_chunk(req)
        raise codec.AbciCodecError(
            f"unknown request type {type(req).__name__}"
        )


def main(argv=None) -> int:
    """Run an example app as a standalone ABCI server process:
    ``python -m cometbft_tpu_torch.abci.server --app kvstore --addr tcp://127.0.0.1:26658``
    (reference analog: abci-cli kvstore)."""
    import argparse
    import signal

    parser = argparse.ArgumentParser(description="ABCI app server")
    parser.add_argument("--app", default="kvstore", choices=["kvstore", "noop"])
    parser.add_argument("--addr", default="tcp://127.0.0.1:26658")
    parser.add_argument(
        "--persist-dir", default=None, help="kvstore persistence dir"
    )
    args = parser.parse_args(argv)

    if args.app == "kvstore":
        from cometbft_tpu_torch.abci.kvstore import KVStoreApp
        from cometbft_tpu_torch.utils.db import open_db

        db = (
            open_db("kvstore", backend="sqlite", dir_=args.persist_dir)
            if args.persist_dir
            else None
        )
        app = KVStoreApp(db=db)
    else:
        app = Application()

    srv = SocketServer(args.addr, app)
    srv.start()
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    try:
        while not stop.is_set():
            stop.wait(0.5)
    finally:
        srv.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
