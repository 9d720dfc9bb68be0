"""Service lifecycle base class (a copy of cometbft_tpu/utils/service.py;
reference: libs/service/service.go).

Every long-lived component of the port (the verify queue, the health
prober) embeds this: start/stop that refuse a second start or a start
after stop, a quit event, and overridable on_start/on_stop hooks.
"""

from __future__ import annotations

import logging
import threading


class ServiceError(RuntimeError):
    pass


class AlreadyStartedError(ServiceError):
    pass


class AlreadyStoppedError(ServiceError):
    pass


class NotStartedError(ServiceError):
    pass


class BaseService:
    """Start/stop lifecycle (libs/service/service.go:99).

    Subclasses override :meth:`on_start` / :meth:`on_stop` and may wait on
    :meth:`quit_event` in background threads.  ``stop`` is idempotent once
    started."""

    def __init__(self, name: str | None = None, logger: logging.Logger | None = None):
        self._name = name or type(self).__name__
        self.logger = logger or logging.getLogger(f"cometbft_tpu_torch.{self._name}")
        self._mtx = threading.Lock()
        self._started = False
        self._stopped = False
        self._quit = threading.Event()

    def start(self) -> None:
        with self._mtx:
            if self._started:
                raise AlreadyStartedError(f"{self._name} already started")
            if self._stopped:
                raise AlreadyStoppedError(f"{self._name} already stopped")
            self._started = True
        self.logger.info("service start: %s", self._name)
        try:
            self.on_start()
        except BaseException:
            with self._mtx:
                self._started = False
            raise

    def stop(self) -> None:
        with self._mtx:
            if not self._started:
                raise NotStartedError(f"{self._name} not started")
            if self._stopped:
                return
            self._stopped = True
        self.logger.info("service stop: %s", self._name)
        self._quit.set()
        self.on_stop()

    def is_running(self) -> bool:
        with self._mtx:
            return self._started and not self._stopped

    def quit_event(self) -> threading.Event:
        return self._quit

    def wait(self, timeout: float | None = None) -> bool:
        """Block until the service is stopped (or ``timeout`` passes)."""
        return self._quit.wait(timeout)

    def on_start(self) -> None:
        pass

    def on_stop(self) -> None:
        pass

    def __repr__(self) -> str:
        state = "running" if self.is_running() else "stopped"
        return f"<{self._name} {state}>"
