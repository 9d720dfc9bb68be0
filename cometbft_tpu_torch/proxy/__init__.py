"""Proxy — four typed application connections over one app (a part of
cometbft_tpu/proxy/__init__.py; reference: proxy/multi_app_conn.go:42-58,
proxy/app_conn.go).

The reference multiplexes the ABCI app behind four logical connections
(consensus, mempool, query, snapshot) so a slow CheckTx can never block
FinalizeBlock.  In-process that property comes from the locking
discipline: the default creator shares one reentrant lock (the
reference's local client), while the unsync creator leaves
synchronization to the application (the reference's unsync-local
client, used by apps that do their own locking).

Only the shared-lock local client is ported: ``RemoteClientCreator``,
``GrpcRemoteClientCreator``, ``default_client_creator``,
``unsync_local_client_creator`` and ``AppConns``' watcher for remote
clients' errors come with ``abci/client.py`` and ``abci/grpc.py``.
Locks are ``utils/sync``'s ``RMutex()``/``Mutex()``, as in the
reference.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

from cometbft_tpu_torch.abci.types import Application
from cometbft_tpu_torch.utils.flight import FLIGHT
from cometbft_tpu_torch.utils.service import BaseService
from cometbft_tpu_torch.utils.trace import TRACER
from cometbft_tpu_torch.utils import sync as cmtsync


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

    def __init__(self, app: Application):
        self._app = app
        self._lock = cmtsync.RMutex()
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
    return ClientCreator(app)


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

    def set_on_error(self, cb) -> None:
        """``cb(exc)`` fires once on the first fatal client error
        (multiAppConn startWatchersForClientErrors): in-process apps
        report synchronously through the creator."""
        self._on_error = cb
        self._creator.set_on_error(self._fire)

    def _fire(self, exc) -> None:
        # once-delivery is the documented contract: the latch swap must
        # be atomic or the sync hook and the watcher (or two erroring
        # connections) racing could both observe a non-None cb
        with self._fire_lock:
            cb, self._on_error = self._on_error, None
        if cb is not None:
            cb(exc)


def new_app_conns(creator: ClientCreator, metrics=None) -> AppConns:
    return AppConns(creator, metrics=metrics)


__all__ = [
    "AbciClientError",
    "AppConns",
    "ClientCreator",
    "local_client_creator",
    "new_app_conns",
]
