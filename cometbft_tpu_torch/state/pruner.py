"""Background pruner service (a copy of cometbft_tpu/state/pruner.py;
reference: state/pruner.go:25).

Retain heights arrive from two writers — the application (via the
FinalizeBlock retain_height field, persisted by the block executor) and
optionally a privileged data companion (set over the pruning RPC
service). The pruner periodically takes the effective minimum and
deletes blocks, historical state, and ABCI results below it. Heights
are persisted in the state DB so a restart resumes where it left off.

Design: one daemon thread woken every ``interval_s`` (or immediately by
a retain-height update); each run prunes at most up to the newest
persisted target, so a slow prune never blocks consensus — the block
executor only records the target and returns.
"""

from __future__ import annotations

import threading

from cometbft_tpu_torch.utils.log import Logger, default_logger
from cometbft_tpu_torch.utils.service import BaseService

_APP_RETAIN_KEY = b"pruner/appRetainHeight"
_COMPANION_RETAIN_KEY = b"pruner/companionRetainHeight"
_ABCI_RESULTS_RETAIN_KEY = b"pruner/abciResultsRetainHeight"


class PrunerError(Exception):
    pass


class Pruner(BaseService):
    """(state/pruner.go:25 Pruner)"""

    def __init__(
        self,
        state_store,
        block_store,
        tx_indexer=None,
        block_indexer=None,
        interval_s: float = 10.0,
        companion_enabled: bool = False,
        metrics=None,
        logger: Logger | None = None,
    ):
        super().__init__(
            name="pruner",
            logger=logger or default_logger().with_fields(module="pruner"),
        )
        self.state_store = state_store
        self.block_store = block_store
        self.tx_indexer = tx_indexer
        self.block_indexer = block_indexer
        self.interval_s = interval_s
        self.companion_enabled = companion_enabled
        self._wake = threading.Event()
        self._thread: threading.Thread | None = None
        if metrics is None:
            from cometbft_tpu_torch.metrics import StateMetrics

            metrics = StateMetrics()
        self.metrics = metrics

    # -- retain-height persistence (pruner.go:152-190) -------------------

    def _db(self):
        return self.state_store._db

    def _get_height(self, key: bytes) -> int:
        raw = self._db().get(key)
        return int.from_bytes(raw, "big") if raw else 0

    def _set_height(self, key: bytes, height: int) -> None:
        if height <= 0:
            raise PrunerError("retain height must be positive")
        if height > self.block_store.height():
            raise PrunerError(
                f"retain height {height} above store height "
                f"{self.block_store.height()}"
            )
        self._db().set(key, height.to_bytes(8, "big"))
        self._wake.set()

    def set_application_retain_height(self, height: int) -> None:
        """Record the app's FinalizeBlock retain height (pruner.go:146
        SetApplicationBlockRetainHeight). Never moves backwards."""
        if height <= self._get_height(_APP_RETAIN_KEY):
            return
        self._set_height(_APP_RETAIN_KEY, height)

    def set_companion_block_retain_height(self, height: int) -> None:
        """Privileged data-companion target (pruner.go:170)."""
        self._set_height(_COMPANION_RETAIN_KEY, height)

    def set_abci_results_retain_height(self, height: int) -> None:
        self._set_height(_ABCI_RESULTS_RETAIN_KEY, height)

    def get_application_retain_height(self) -> int:
        return self._get_height(_APP_RETAIN_KEY)

    def get_companion_block_retain_height(self) -> int:
        return self._get_height(_COMPANION_RETAIN_KEY)

    def get_abci_results_retain_height(self) -> int:
        return self._get_height(_ABCI_RESULTS_RETAIN_KEY)

    def effective_retain_height(self) -> int:
        """min of the enabled writers' targets (pruner.go:447
        findMinRetainHeight); 0 = nothing to prune."""
        app = self._get_height(_APP_RETAIN_KEY)
        if not self.companion_enabled:
            return app
        companion = self._get_height(_COMPANION_RETAIN_KEY)
        if app == 0 or companion == 0:
            return 0  # wait until both writers have spoken
        return min(app, companion)

    # -- service ---------------------------------------------------------

    def on_start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name="pruner", daemon=True
        )
        self._thread.start()

    def on_stop(self) -> None:
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def _loop(self) -> None:
        while not self._quit.is_set():
            self._wake.clear()
            try:
                self.prune_once()
            except Exception as exc:  # noqa: BLE001 — keep the service up
                self.logger.error("prune run failed", err=repr(exc))
            # sleep until the interval elapses or a new target arrives
            self._wake.wait(self.interval_s)
            if self._quit.is_set():
                return

    def prune_once(self) -> tuple[int, int]:
        """One pruning pass; returns (blocks_pruned, new_base)."""
        target = self.effective_retain_height()
        pruned = 0
        base = self.block_store.base()
        if target > base:
            pruned = self.block_store.prune_blocks(target)
            self.state_store.prune(target)
            for ix in (self.tx_indexer, self.block_indexer):
                prune = getattr(ix, "prune", None)
                if prune is not None:
                    try:
                        prune(target)
                    except Exception as exc:  # noqa: BLE001
                        self.logger.error(
                            "indexer prune failed", err=repr(exc)
                        )
            base = self.block_store.base()
            self.logger.info(
                "pruned blocks", pruned=pruned, new_base=base, target=target
            )
            self.metrics.pruned_blocks.inc(pruned)
        abci_target = self._get_height(_ABCI_RESULTS_RETAIN_KEY)
        if abci_target > 0:
            self.state_store.prune_abci_responses(abci_target)
        return pruned, base
