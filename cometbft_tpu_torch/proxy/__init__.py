"""Proxy — four typed application connections over one app (a copy of
cometbft_tpu/proxy/__init__.py; reference: proxy/multi_app_conn.go:42-58,
proxy/app_conn.go, proxy/client.go).

The reference multiplexes the ABCI app behind four logical connections
(consensus, mempool, query, snapshot) so a slow CheckTx can never block
FinalizeBlock.  In-process that property comes from the locking
discipline: the default creator shares one reentrant lock (the
reference's local client), while the unsync creator leaves
synchronization to the application (the reference's unsync-local
client, used by apps that do their own locking).

An external app is reached over the ABCI socket protocol
(``RemoteClientCreator``, ``abci/client.py``) or gRPC
(``GrpcRemoteClientCreator``, ``abci/grpc.py``, imported only for a
``grpc://`` address): one client, and so one socket or channel, per
logical connection.  ``AppConns`` connects each at its start and, for
clients without an in-call hook, polls their latched ``error()`` from
a watcher thread that fires ``on_error`` once.  Locks are
``utils/sync``'s ``RMutex()``/``Mutex()``, as in the reference.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

from cometbft_tpu_torch.abci.types import Application
from cometbft_tpu_torch.utils.flight import FLIGHT
from cometbft_tpu_torch.utils.service import BaseService
from cometbft_tpu_torch.utils import sync as cmtsync
from cometbft_tpu_torch.utils.trace import TRACER


class AbciClientError(Exception):
    pass


class _LocalClient:
    """Synchronous in-process ABCI client (abci/client/local_client.go).

    Every call round-trips to the app under ``lock`` (a no-op lock for
    unsync mode).  Methods mirror the Application surface 1:1.
    """

    def __init__(
        self, app: Application, lock, shared_error: list, on_error=None
    ):
        self._app = app
        self._lock = lock
        # One-slot error latch shared by all four connections: a fatal
        # app error on any connection poisons the whole proxy, since the
        # app's state is unknown (multiAppConn StopForError semantics).
        self._shared_error = shared_error
        self._on_error = on_error

    def _call(self, fn: Callable, *args):
        with self._lock:
            if self._shared_error:
                raise AbciClientError(
                    f"abci client is dead: {self._shared_error[0]}"
                ) from self._shared_error[0]
            try:
                return fn(*args)
            except BaseException as exc:
                first = not self._shared_error
                self._shared_error.append(exc)
                if first and self._on_error is not None:
                    # fail-stop, the reference way (a Go app panic takes
                    # the node process down; multiAppConn killChan):
                    # fire OUTSIDE the app lock on a fresh thread — the
                    # stop path joins threads that may be blocked on
                    # this very lock.  Once-delivery is latched at the
                    # AppConns level.
                    threading.Thread(
                        target=self._on_error, args=(exc,),
                        name="proxy-fail-stop", daemon=True,
                    ).start()
                raise

    def error(self) -> BaseException | None:
        return self._shared_error[0] if self._shared_error else None

    # query connection
    def info(self, req):
        return self._call(self._app.info, req)

    def query(self, req):
        return self._call(self._app.query, req)

    # mempool connection
    def check_tx(self, req):
        return self._call(self._app.check_tx, req)

    def flush(self) -> None:
        """No queue to drain in-process (socket client parity no-op)."""

    # consensus connection
    def init_chain(self, req):
        return self._call(self._app.init_chain, req)

    def prepare_proposal(self, req):
        return self._call(self._app.prepare_proposal, req)

    def process_proposal(self, req):
        return self._call(self._app.process_proposal, req)

    def finalize_block(self, req):
        return self._call(self._app.finalize_block, req)

    def extend_vote(self, req):
        return self._call(self._app.extend_vote, req)

    def verify_vote_extension(self, req):
        return self._call(self._app.verify_vote_extension, req)

    def commit(self):
        return self._call(self._app.commit)

    # snapshot connection
    def list_snapshots(self):
        return self._call(self._app.list_snapshots)

    def offer_snapshot(self, req):
        return self._call(self._app.offer_snapshot, req)

    def load_snapshot_chunk(self, req):
        return self._call(self._app.load_snapshot_chunk, req)

    def apply_snapshot_chunk(self, req):
        return self._call(self._app.apply_snapshot_chunk, req)


class _NopLock:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


#: the ABCI method surface timed at the proxy seam — every call on any
#: of the four logical connections lands in
#: abci_method_timing_seconds{method,connection} (proxy/metrics.go
#: MethodTiming) plus an abci/<method> span and a flight-recorder event
_TIMED_METHODS = frozenset(
    {
        "info",
        "query",
        "check_tx",
        "flush",
        "init_chain",
        "prepare_proposal",
        "process_proposal",
        "finalize_block",
        "extend_vote",
        "verify_vote_extension",
        "commit",
        "list_snapshots",
        "offer_snapshot",
        "load_snapshot_chunk",
        "apply_snapshot_chunk",
    }
)


class _TimedConn:
    """Wraps one logical ABCI connection, timing every method into the
    proxy metrics struct (local AND remote clients get the same
    instrumentation, since the wrap happens at the AppConns seam).
    Non-ABCI attributes (``ensure_connected``, ``error``, ``close``)
    pass through untouched."""

    def __init__(self, client, connection: str, metrics):
        self._client = client
        self._connection = connection
        self._metrics = metrics

    def __getattr__(self, name):
        attr = getattr(self._client, name)
        if name not in _TIMED_METHODS or not callable(attr):
            return attr
        connection, metrics = self._connection, self._metrics

        def call(*args, **kwargs):
            t0 = time.perf_counter()
            with TRACER.span(
                f"abci/{name}", cat="abci", connection=connection
            ):
                try:
                    return attr(*args, **kwargs)
                finally:
                    elapsed = time.perf_counter() - t0
                    metrics.method_timing_seconds.labels(
                        method=name, connection=connection
                    ).observe(elapsed)
                    FLIGHT.record(
                        "abci", method=name, connection=connection,
                        ms=round(elapsed * 1e3, 3),
                    )

        call.__name__ = name
        # cache: later lookups hit the instance dict, skipping
        # __getattr__ and the closure rebuild
        self.__dict__[name] = call
        return call


class ClientCreator:
    """Builds one client per logical connection (proxy/client.go)."""

    def __init__(self, app: Application, sync: bool = True):
        self._app = app
        self._lock = cmtsync.RMutex() if sync else _NopLock()
        self._shared_error: list = []
        self._on_error = None

    def set_on_error(self, cb) -> None:
        """``cb(exc)`` is invoked on the first app exception — the
        node wires its stop here (multiAppConn killChan analog: an app
        whose state is unknown must take the node down, not leave a
        poisoned zombie answering RPC).  Once-delivery is the caller's
        concern (AppConns latches)."""
        self._on_error = cb

    def new_client(self) -> _LocalClient:
        return _LocalClient(
            self._app, self._lock, self._shared_error,
            on_error=lambda exc: self._fire(exc),
        )

    def _fire(self, exc) -> None:
        if self._on_error is not None:
            self._on_error(exc)


def local_client_creator(app: Application) -> ClientCreator:
    """Shared-mutex local client (proxy/client.go NewLocalClientCreator)."""
    return ClientCreator(app, sync=True)


def unsync_local_client_creator(app: Application) -> ClientCreator:
    """App-managed locking (NewUnsyncLocalClientCreator) — lets CheckTx
    run concurrently with FinalizeBlock, the 4-connection point."""
    return ClientCreator(app, sync=False)


class RemoteClientCreator:
    """Clients for an external app over the ABCI socket protocol —
    one fresh socket per logical connection (proxy/client.go
    NewRemoteClientCreator + abci/client/socket_client.go)."""

    def __init__(self, addr: str, connect_timeout: float = 10.0):
        self._addr = addr
        self._connect_timeout = connect_timeout

    def new_client(self):
        from cometbft_tpu_torch.abci.client import SocketClient

        return SocketClient(
            self._addr, connect_timeout=self._connect_timeout
        )


def remote_client_creator(
    addr: str, connect_timeout: float = 10.0
) -> RemoteClientCreator:
    return RemoteClientCreator(addr, connect_timeout)


class GrpcRemoteClientCreator:
    """Clients for an external app over ABCI gRPC — one channel-backed
    client per logical connection (proxy/client.go NewRemoteClientCreator
    with transport "grpc" + abci/client/grpc_client.go)."""

    def __init__(self, addr: str, connect_timeout: float = 10.0):
        self._addr = addr
        self._connect_timeout = connect_timeout

    def new_client(self):
        from cometbft_tpu_torch.abci.grpc import GrpcClient

        return GrpcClient(self._addr, connect_timeout=self._connect_timeout)


def default_client_creator(proxy_app: str, app: Application | None = None):
    """config.proxy_app -> creator (proxy/client.go DefaultClientCreator):
    tcp:// and unix:// addresses mean an external app over the socket
    protocol, grpc:// over gRPC; anything else is a builtin served
    in-process."""
    if proxy_app.startswith("grpc://"):
        return GrpcRemoteClientCreator(proxy_app)
    if proxy_app.startswith(("tcp://", "unix://")):
        return remote_client_creator(proxy_app)
    if app is None:
        raise ValueError(f"builtin app {proxy_app!r} requires an instance")
    return local_client_creator(app)


class AppConns(BaseService):
    """The four typed connections (proxy/multi_app_conn.go:42), each
    wrapped in method timing (`abci_method_timing_seconds`) labeled by
    its logical connection name."""

    def __init__(self, creator: ClientCreator, metrics=None):
        super().__init__(name="proxyApp")
        from cometbft_tpu_torch.metrics import ProxyMetrics

        self._creator = creator
        self.metrics = metrics if metrics is not None else ProxyMetrics()
        self.consensus = _TimedConn(
            creator.new_client(), "consensus", self.metrics
        )
        self.mempool = _TimedConn(
            creator.new_client(), "mempool", self.metrics
        )
        self.query = _TimedConn(creator.new_client(), "query", self.metrics)
        self.snapshot = _TimedConn(
            creator.new_client(), "snapshot", self.metrics
        )
        self._on_error = None
        self._fire_lock = cmtsync.Mutex()
        self._sync_hook = False
        self._watch_stop = threading.Event()
        self._watcher: threading.Thread | None = None

    def set_on_error(self, cb) -> None:
        """``cb(exc)`` fires once on the first fatal client error
        (multiAppConn startWatchersForClientErrors).  In-process apps
        report synchronously through the creator; remote (socket/grpc)
        clients latch their error and are polled by a watcher thread
        started in on_start."""
        self._on_error = cb
        setter = getattr(self._creator, "set_on_error", None)
        self._sync_hook = setter is not None
        if setter is not None:
            setter(self._fire)

    def _fire(self, exc) -> None:
        # once-delivery is the documented contract: the latch swap must
        # be atomic or the sync hook and the watcher (or two erroring
        # connections) racing could both observe a non-None cb
        with self._fire_lock:
            cb, self._on_error = self._on_error, None
        if cb is not None:
            cb(exc)

    def _watch_errors(self) -> None:
        clients = (self.consensus, self.mempool, self.query, self.snapshot)
        while not self._watch_stop.wait(1.0):
            for c in clients:
                err_fn = getattr(c, "error", None)
                err = err_fn() if err_fn is not None else None
                if err is not None:
                    self._fire(err)
                    return

    def on_start(self) -> None:
        # Remote clients connect lazily; surface connection failures at
        # service start (node.OnStart) rather than first use.
        for client in (
            self.consensus,
            self.mempool,
            self.query,
            self.snapshot,
        ):
            connect = getattr(client, "ensure_connected", None)
            if connect is not None:
                connect()
        if self._on_error is not None and not self._sync_hook:
            # no synchronous in-call hook wired: poll client errors
            self._watcher = threading.Thread(
                target=self._watch_errors, name="proxy-err-watch",
                daemon=True,
            )
            self._watcher.start()

    def on_stop(self) -> None:
        self._watch_stop.set()
        for client in (
            self.consensus,
            self.mempool,
            self.query,
            self.snapshot,
        ):
            close = getattr(client, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:  # noqa: BLE001 — best-effort teardown
                    pass


def new_app_conns(creator: ClientCreator, metrics=None) -> AppConns:
    return AppConns(creator, metrics=metrics)


__all__ = [
    "AbciClientError",
    "AppConns",
    "ClientCreator",
    "GrpcRemoteClientCreator",
    "RemoteClientCreator",
    "default_client_creator",
    "local_client_creator",
    "new_app_conns",
    "remote_client_creator",
    "unsync_local_client_creator",
]
