"""Mempool — pending transactions awaiting block inclusion (a copy of
cometbft_tpu/mempool/__init__.py; reference: mempool/mempool.go:26,
mempool/clist_mempool.go:29).

FIFO tx list with an LRU dedup cache in front of app CheckTx.  The
consensus engine reaps txs for proposals, locks the mempool across
commit, then calls update() with the committed block's txs; remaining
txs are re-checked against the new app state (recheck).

Where the port departs from its reference:
- ``CListMempool`` takes a keyword ``device`` (``cuda`` unless the
  caller names another; without a card only ``device="cpu"`` runs).
  With a verify queue installed a signed tx's signature rides the
  queue's ingest lane, as in the reference; with none, it goes through
  ``create_batch_verifier`` on that device (the ladder sends a lone
  signature to the host tier), where the reference calls
  ``verify_signature``;
- the TxCache's shard count is the constant ``TXCACHE_SHARDS`` (the
  reference reads ``CMT_TPU_TXCACHE_SHARDS``).

The locks are ``utils/sync``'s, the cache shard and the mempool
``@guarded``; ``_verify_tx_signature`` notes the trust guard's
validator and ``check_tx`` is a sink, as in the reference.
"""

from __future__ import annotations

import threading
import time

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable

from cometbft_tpu_torch.abci.types import (
    CHECK_TX_TYPE_CHECK,
    CHECK_TX_TYPE_RECHECK,
    CheckTxRequest,
    CheckTxResponse,
)
from cometbft_tpu_torch.types.block import tx_hash
from cometbft_tpu_torch.utils import sync as cmtsync
from cometbft_tpu_torch.utils import trustguard


class MempoolError(Exception):
    pass


class TxInCacheError(MempoolError):
    """Duplicate submission (mempool/errors.go ErrTxInCache)."""


class TxTooLargeError(MempoolError):
    pass


class MempoolFullError(MempoolError):
    pass


class TxSignatureError(MempoolError):
    """Signed-tx envelope (mempool/ingest.py) failed admission
    signature verification — or claimed the envelope and didn't
    parse."""


@dataclass
class _MempoolTx:
    tx: bytes
    height: int  # height at which the tx entered the mempool
    gas_wanted: int
    seq: int = 0  # monotonic arrival order, drives reactor broadcast
    senders: set = field(default_factory=set)  # peers we got it from


#: TxCache shard count (the reference's default for
#: CMT_TPU_TXCACHE_SHARDS)
TXCACHE_SHARDS = 8


@cmtsync.guarded
class _TxCacheShard:
    """One hash-partitioned shard: its own LRU map under its own
    mutex.  Keys land on a shard by their first hash byte, so the
    partition is uniform and a key's shard is stable for its whole
    cache lifetime (push/has/remove for one tx always contend on the
    same single mutex — never two)."""

    _GUARDED_BY = {"_map": "_mtx"}

    def __init__(self, size: int):
        self._size = size
        self._mtx = cmtsync.Mutex()  # guards _map
        self._map: OrderedDict[bytes, None] = OrderedDict()

    def push_key(self, key: bytes) -> bool:
        with self._mtx:
            if key in self._map:
                self._map.move_to_end(key)
                return False
            self._map[key] = None
            if len(self._map) > self._size:
                self._map.popitem(last=False)
            return True

    def remove_key(self, key: bytes) -> None:
        with self._mtx:
            self._map.pop(key, None)

    def has_key(self, key: bytes) -> bool:
        with self._mtx:
            return key in self._map

    def reset(self) -> None:
        with self._mtx:
            self._map.clear()

    def __len__(self) -> int:
        with self._mtx:
            return len(self._map)


class TxCache:
    """Fixed-size LRU of recently seen tx hashes (mempool/cache.go),
    hash-partitioned across ``shards`` independent locks so admission
    at device-batch throughput no longer serializes every CheckTx on
    one mutex (BENCH_MICRO's cache_push row measured the single-lock
    cache at ~1.1M ops/s on ONE thread; under concurrent RPC ingest
    the lock convoy was the ceiling).  Semantics vs the unsharded
    cache: push/remove/has/reset are identical per key; eviction is
    LRU *per shard* with total capacity >= ``size`` (each shard holds
    ceil(size/shards)), so the cache never remembers less than the
    unsharded one promised.  The tx hash is computed OUTSIDE any lock
    — the former version hashed under the mutex."""

    def __init__(self, size: int, shards: int | None = None):
        n = shards if shards is not None else TXCACHE_SHARDS
        # never more shards than capacity: a size-2 cache with 8
        # shards would evict almost nothing it promised to remember
        n = max(1, min(n, max(1, size)))
        per_shard = -(-max(1, size) // n)  # ceil
        self._shards = tuple(_TxCacheShard(per_shard) for _ in range(n))

    def _shard(self, key: bytes) -> _TxCacheShard:
        return self._shards[key[0] % len(self._shards)]

    def push(self, tx: bytes) -> bool:
        """Returns False if already present (and refreshes recency)."""
        return self.push_hashed(tx_hash(tx))

    def remove(self, tx: bytes) -> None:
        self.remove_hashed(tx_hash(tx))

    def has(self, tx: bytes) -> bool:
        return self.has_hashed(tx_hash(tx))

    # hashed variants: the admission hot path computes tx_hash ONCE in
    # check_tx and threads the key through every cache touch

    def push_hashed(self, key: bytes) -> bool:
        return self._shard(key).push_key(key)

    def remove_hashed(self, key: bytes) -> None:
        self._shard(key).remove_key(key)

    def has_hashed(self, key: bytes) -> bool:
        return self._shard(key).has_key(key)

    def reset(self) -> None:
        for shard in self._shards:
            shard.reset()

    def __len__(self) -> int:
        return sum(len(s) for s in self._shards)


class NopTxCache(TxCache):
    def __init__(self):
        super().__init__(1)

    def push_hashed(self, key: bytes) -> bool:
        return True

    def has_hashed(self, key: bytes) -> bool:
        return False


PreCheckFunc = Callable[[bytes], None]  # raises to reject
PostCheckFunc = Callable[[bytes, CheckTxResponse], None]


def pre_check_max_bytes(max_bytes: int) -> PreCheckFunc:
    """(mempool/mempool.go PreCheckMaxBytes)"""

    def check(tx: bytes) -> None:
        if len(tx) > max_bytes:
            raise TxTooLargeError(
                f"tx size {len(tx)} exceeds max {max_bytes}"
            )

    return check


def post_check_max_gas(max_gas: int) -> PostCheckFunc:
    """(mempool/mempool.go PostCheckMaxGas)"""

    def check(tx: bytes, res: CheckTxResponse) -> None:
        if max_gas >= 0 and res.gas_wanted > max_gas:
            raise MempoolError(
                f"gas wanted {res.gas_wanted} exceeds block max {max_gas}"
            )

    return check


@cmtsync.guarded
class CListMempool:
    """The production mempool (mempool/clist_mempool.go:29).

    ``_mtx`` guards ``_txs``, ``_txs_bytes``, ``_seq``, ``_height``,
    ``_notified_available``, ``pre_check`` and ``post_check``;
    pre_check/post_check are swapped under the lock in update() but read
    lock-free on the CheckTx hot path."""

    _GUARDED_BY = {
        "_txs": "_mtx",
        "_txs_bytes": "_mtx",
        "_seq": "_mtx",
        "_height": "_mtx",
        "_notified_available": "_mtx",
        "pre_check": "_mtx",
        "post_check": "_mtx",
    }

    def __init__(
        self,
        proxy_app_conn,
        height: int = 0,
        size: int = 5000,
        max_tx_bytes: int = 1048576,
        max_txs_bytes: int = 1073741824,
        cache_size: int = 10000,
        keep_invalid_txs_in_cache: bool = False,
        recheck: bool = True,
        metrics=None,
        *,
        device=None,
    ):
        from cometbft_tpu_torch.metrics import MempoolMetrics
        from cometbft_tpu_torch.utils.env import resolve_device

        self.device = resolve_device(device)
        self.metrics = metrics if metrics is not None else MempoolMetrics()
        self._proxy = proxy_app_conn
        self._height = height
        self._size_limit = size
        self._max_tx_bytes = max_tx_bytes
        self._max_txs_bytes = max_txs_bytes
        self._keep_invalid = keep_invalid_txs_in_cache
        self._recheck_enabled = recheck
        self.cache = TxCache(cache_size) if cache_size > 0 else NopTxCache()

        self._mtx = cmtsync.RMutex()  # the consensus Lock()/Unlock()
        self._txs: OrderedDict[bytes, _MempoolTx] = OrderedDict()
        self._txs_bytes = 0
        self._seq = 0  # next arrival sequence number
        self._new_tx_cond = threading.Condition(self._mtx)
        self._notified_available = False
        self._tx_available = threading.Event()
        self.pre_check: PreCheckFunc | None = None
        self.post_check: PostCheckFunc | None = None

    # -- introspection -------------------------------------------------

    def size(self) -> int:
        with self._mtx:
            return len(self._txs)

    def size_bytes(self) -> int:
        with self._mtx:
            return self._txs_bytes

    def is_full(self, tx_len: int) -> bool:
        with self._mtx:
            return (
                len(self._txs) >= self._size_limit
                or self._txs_bytes + tx_len > self._max_txs_bytes
            )

    def contains(self, tx: bytes) -> bool:
        with self._mtx:
            return tx_hash(tx) in self._txs

    def get_tx_by_hash(self, hash_: bytes) -> bytes | None:
        """(mempool.go GetTxByHash — the /unconfirmed_tx RPC)."""
        with self._mtx:
            mt = self._txs.get(hash_)
            return bytes(mt.tx) if mt is not None else None

    # -- CheckTx path --------------------------------------------------

    def check_tx(self, tx: bytes, sender: str = "") -> CheckTxResponse:
        """Validate tx via the app and add it
        (clist_mempool.go:269 CheckTx).

        Admission order: size → pre_check → is_full → cache dedupe →
        envelope signature (mempool/ingest.py, batched through the
        VerifyQueue's ingest lane) → app CheckTx.  The signature comes
        AFTER the cache so a duplicate never pays a second verify, and
        before the app so an invalid sender never costs an ABCI round
        trip."""
        m = self.metrics
        if len(tx) > self._max_tx_bytes:
            m.checktx_total.labels(result="too_large").inc()
            raise TxTooLargeError(
                f"tx size {len(tx)} exceeds max {self._max_tx_bytes}"
            )
        if self.pre_check is not None:  # unguarded: callable ref, swapped atomically under lock in update()
            try:
                self.pre_check(tx)  # unguarded: same audited read as line above
            except MempoolError:
                m.checktx_total.labels(result="precheck").inc()
                raise
        if self.is_full(len(tx)):
            m.checktx_total.labels(result="full").inc()
            raise MempoolFullError(
                f"mempool is full: {self.size()} txs"
            )
        # ONE hash per admission: computed outside every lock, threaded
        # through the cache and the map insert
        key = tx_hash(tx)
        if not self.cache.push_hashed(key):
            # record the sender even on the duplicate path so the
            # broadcast routine never echoes the tx back to them
            # (clist_mempool.go CheckTx ErrTxInCache branch)
            if sender:
                with self._mtx:
                    mt = self._txs.get(key)
                    if mt is not None:
                        mt.senders.add(sender)
            m.checktx_total.labels(result="duplicate").inc()
            raise TxInCacheError("tx already in cache")
        try:
            self._verify_tx_signature(tx)
        except TxSignatureError:
            m.checktx_total.labels(result="sig").inc()
            m.failed_txs.inc()
            if not self._keep_invalid:
                self.cache.remove_hashed(key)
            raise
        try:
            res = self._proxy.check_tx(
                CheckTxRequest(tx=tx, type=CHECK_TX_TYPE_CHECK)
            )
        except BaseException:
            # transport/app failure, not a tx verdict: re-admittable
            m.checktx_total.labels(result="app").inc()
            self.cache.remove_hashed(key)
            raise
        self._handle_check_result(tx, res, sender, key)
        return res

    def _verify_tx_signature(self, tx: bytes) -> None:
        """Admission signature check for enveloped txs (plain txs pass
        through untouched).  When the process-wide VerifyQueue is
        accepting, the signature rides the low-priority ``ingest``
        lane — the micro-batcher coalesces concurrent CheckTx calls
        into one device launch; any queue problem (off, draining,
        busy, failed batch) degrades to the same inline
        ``verify_signature`` call, never a stall and never a dropped
        tx."""
        from cometbft_tpu_torch.crypto import batch as _batch
        from cometbft_tpu_torch.crypto import ed25519 as _ed
        from cometbft_tpu_torch.crypto import verify_queue as _vq
        from cometbft_tpu_torch.mempool import ingest as _ingest

        try:
            parsed = _ingest.parse_signed_tx(tx)
        except _ingest.MalformedSignedTx as exc:
            raise TxSignatureError(str(exc)) from None
        if parsed is None:
            # a plain (un-enveloped) tx: the admission *policy* ran —
            # there is simply no signature to check
            trustguard.note_validated("CListMempool._verify_tx_signature")
            return
        pub, sig, payload = parsed
        t0 = time.perf_counter()
        try:
            pk = _ed.Ed25519PubKey(pub)
        except ValueError as exc:
            raise TxSignatureError(str(exc)) from None
        item = (pk, _ingest.sign_bytes(payload), sig)
        if _vq.speculation_active():
            results, n_inline = _vq.checktx_verify_or_fallback([item])
            ok = results[0]
            # honest route accounting: a queue that degraded THIS tx
            # to the inline path mid-call counts as inline, so the
            # batched/inline pair on /metrics reflects what actually
            # verified each signature
            (self.metrics.checktx_inline if n_inline
             else self.metrics.checktx_batched).inc()
        else:
            bv = _batch.create_batch_verifier(pk, device=self.device)
            bv.add(*item)
            ok = bv.verify()[1][0]
            self.metrics.checktx_inline.inc()
        self.metrics.checktx_sig_seconds.observe(
            time.perf_counter() - t0
        )
        if not ok:
            raise TxSignatureError("invalid tx signature")
        trustguard.note_validated("CListMempool._verify_tx_signature")

    def _handle_check_result(
        self, tx: bytes, res: CheckTxResponse, sender: str,
        key: bytes | None = None,
    ) -> None:
        """(clist_mempool.go:328 handleCheckTxResponse)"""
        trustguard.check_sink("mempool.check_tx")
        post_err = None
        if self.post_check is not None:  # unguarded: callable ref, swapped atomically under lock in update()
            try:
                self.post_check(tx, res)  # unguarded: same audited read as line above
            except MempoolError as e:
                post_err = e
        # ONE hash per admission (reused from check_tx when available),
        # computed before any lock
        if key is None:
            key = tx_hash(tx)
        if res.code != 0 or post_err is not None:
            self.metrics.failed_txs.inc()
            self.metrics.checktx_total.labels(result="app").inc()
            if not self._keep_invalid:
                self.cache.remove_hashed(key)
            if post_err is not None:
                raise post_err
            return
        with self._mtx:
            if self.is_full(len(tx)):
                self.cache.remove_hashed(key)
                self.metrics.checktx_total.labels(result="full").inc()
                raise MempoolFullError("mempool is full")
            if key in self._txs:
                if sender:
                    self._txs[key].senders.add(sender)
                # already in the pool (cache evicted the hash while
                # the tx still sat in _txs): a duplicate admission
                # outcome — every path lands in exactly one bucket
                self.metrics.checktx_total.labels(
                    result="duplicate"
                ).inc()
                return
            self._seq += 1
            self._txs[key] = _MempoolTx(
                tx=tx,
                height=self._height,
                gas_wanted=res.gas_wanted,
                seq=self._seq,
                senders={sender} if sender else set(),
            )
            self._txs_bytes += len(tx)
            # the size gauges stay UNDER the lock: snapshot-then-set
            # outside would let this (older) value overwrite the one a
            # concurrent update() just published for an emptier pool
            self.metrics.size.set(len(self._txs))
            self.metrics.size_bytes.set(self._txs_bytes)
            self._notify_available()
            self._new_tx_cond.notify_all()
        self.metrics.tx_size_bytes.observe(len(tx))
        self.metrics.checktx_total.labels(result="accepted").inc()

    def _notify_available(self) -> None:  # holds _mtx
        if not self._notified_available and len(self._txs) > 0:
            self._notified_available = True
            self._tx_available.set()

    def txs_available(self) -> threading.Event:
        """Fires once per height when txs exist (TxsAvailable)."""
        return self._tx_available

    # -- reap ----------------------------------------------------------

    def reap_max_bytes_max_gas(
        self, max_bytes: int, max_gas: int
    ) -> list[bytes]:
        """FIFO txs within the block's byte/gas budget
        (clist_mempool.go ReapMaxBytesMaxGas)."""
        with self._mtx:
            out: list[bytes] = []
            total_bytes = 0
            total_gas = 0
            for mt in self._txs.values():
                if max_bytes > -1 and total_bytes + len(mt.tx) > max_bytes:
                    break
                if max_gas > -1 and total_gas + mt.gas_wanted > max_gas:
                    break
                out.append(mt.tx)
                total_bytes += len(mt.tx)
                total_gas += mt.gas_wanted
            return out

    def reap_max_txs(self, n: int) -> list[bytes]:
        with self._mtx:
            txs = [mt.tx for mt in self._txs.values()]
            return txs if n < 0 else txs[:n]

    # -- reactor iteration (clist_mempool.go TxsWaitChan/TxsFront) ------

    def txs_after(
        self, seq: int, exclude_sender: str = "", max_txs: int = 64
    ) -> list[tuple[int, bytes]]:
        """Txs that arrived after ``seq``, skipping ones received from
        ``exclude_sender`` (their seq is still consumed so the cursor
        advances past them)."""
        with self._mtx:
            out: list[tuple[int, bytes]] = []
            for mt in self._txs.values():
                if mt.seq <= seq:
                    continue
                if len(out) >= max_txs:
                    break
                if exclude_sender and exclude_sender in mt.senders:
                    out.append((mt.seq, b""))
                    continue
                out.append((mt.seq, mt.tx))
            return out

    def current_seq(self) -> int:
        """Latest arrival sequence number handed out."""
        with self._mtx:
            return self._seq

    def wait_for_txs_after(self, seq: int, timeout: float) -> bool:
        """Block until a tx with seq > ``seq`` may exist."""
        with self._mtx:
            if self._seq > seq:
                return True
            return self._new_tx_cond.wait(timeout)

    # -- consensus integration -----------------------------------------

    def lock(self) -> None:
        """Held across FinalizeBlock→Commit (state/execution.go:405)."""
        self._mtx.acquire()  # blocking ok: abci_execute — mempool is locked across the commit-side update, inside the exec/apply_block span

    def unlock(self) -> None:
        self._mtx.release()

    def update(
        self,
        height: int,
        txs: list[bytes],
        tx_results: list,
        new_pre_check: PreCheckFunc | None = None,
        new_post_check: PostCheckFunc | None = None,
    ) -> None:  # holds _mtx
        """Remove committed txs + recheck the rest.  Caller must hold
        the lock (clist_mempool.go:Update contract)."""
        self._height = height
        self._notified_available = False
        self._tx_available.clear()
        if new_pre_check is not None:
            self.pre_check = new_pre_check
        if new_post_check is not None:
            self.post_check = new_post_check
        for i, tx in enumerate(txs):
            result_ok = (
                tx_results[i].code == 0 if i < len(tx_results) else False
            )
            if result_ok:
                self.cache.push(tx)  # keep committed txs in cache
            elif not self._keep_invalid:
                self.cache.remove(tx)
            mt = self._txs.pop(tx_hash(tx), None)
            if mt is not None:
                self._txs_bytes -= len(mt.tx)
        if self._recheck_enabled and self._txs:
            self._recheck_txs()
        # gauges must track shrinkage too, or an emptying mempool keeps
        # reporting its old size until the next successful add
        self.metrics.size.set(len(self._txs))
        self.metrics.size_bytes.set(self._txs_bytes)
        if self._txs:
            self._notify_available()

    def _recheck_txs(self) -> None:  # holds _mtx
        """Re-run CheckTx on everything left after a block
        (clist_mempool.go recheckTxs)."""
        self.metrics.recheck_times.inc()
        for key in list(self._txs.keys()):
            mt = self._txs.get(key)
            if mt is None:
                continue
            res = self._proxy.check_tx(
                CheckTxRequest(tx=mt.tx, type=CHECK_TX_TYPE_RECHECK)
            )
            if res.code != 0:
                self._txs.pop(key, None)
                self._txs_bytes -= len(mt.tx)
                self.metrics.evicted_txs.inc()
                if not self._keep_invalid:
                    self.cache.remove(mt.tx)

    def flush(self) -> None:
        with self._mtx:
            self._txs.clear()
            self._txs_bytes = 0
            self.cache.reset()
            self.metrics.size.set(0)
            self.metrics.size_bytes.set(0)


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
        time.sleep(timeout)
        return False


__all__ = [
    "CListMempool",
    "MempoolError",
    "MempoolFullError",
    "NopMempool",
    "NopTxCache",
    "TXCACHE_SHARDS",
    "TxCache",
    "TxInCacheError",
    "TxSignatureError",
    "TxTooLargeError",
    "post_check_max_gas",
    "pre_check_max_bytes",
]
