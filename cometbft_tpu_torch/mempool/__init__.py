"""Mempool (a part of cometbft_tpu/mempool/__init__.py; reference:
mempool/nop_mempool.go): the disabled mempool only, which blocksync's
executor locks and updates around Commit.  ``CListMempool`` and the
mempool reactor come with consensus.
"""

from __future__ import annotations

import threading

from cometbft_tpu_torch.abci.types import CheckTxResponse


class MempoolError(Exception):
    pass


class NopMempool:
    """Disabled mempool (mempool/nop_mempool.go) for apps that disseminate
    txs themselves."""

    def check_tx(self, tx: bytes, sender: str = "") -> CheckTxResponse:
        raise MempoolError("mempool is disabled")

    def size(self) -> int:
        return 0

    def size_bytes(self) -> int:
        return 0

    def contains(self, tx: bytes) -> bool:
        return False

    def reap_max_bytes_max_gas(self, max_bytes, max_gas) -> list[bytes]:
        return []

    def reap_max_txs(self, n) -> list[bytes]:
        return []

    def lock(self) -> None:
        pass

    def unlock(self) -> None:
        pass

    def update(self, *a, **kw) -> None:
        pass

    def flush(self) -> None:
        pass

    def txs_available(self) -> threading.Event:
        return threading.Event()

    def current_seq(self) -> int:
        return 0

    def txs_after(self, seq, exclude_sender="", max_txs=64):
        return []

    def wait_for_txs_after(self, seq, timeout):
        import time as _t

        _t.sleep(timeout)
        return False


__all__ = ["MempoolError", "NopMempool"]
