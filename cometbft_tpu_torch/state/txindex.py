"""Transaction and block indexing (a copy of
cometbft_tpu/state/txindex.py; reference: state/txindex/,
state/indexer/block/kv/).

The IndexerService subscribes to the event bus and writes two indexes:
- tx index: tx hash → ExecTxResult, plus ``{type}.{attr}`` composite
  event keys → tx hashes (state/txindex/kv/kv.go:42);
- block index: event keys → heights (state/indexer/block/kv).

Search supports the pubsub query DSL (``tx.height > 5 AND
transfer.amount = '100'``) — the same language the event bus uses.

Where the port departs from its reference: ``build_indexers(config,
chain_id)``, the node's choice of kv, psql or null indexers from its
``Config``, comes with ``Config`` and the node; a caller builds
``TxIndexer(db)`` and ``BlockIndexer(db)`` itself.
"""

from __future__ import annotations

import threading

from cometbft_tpu_torch.abci.types import ExecTxResult
from cometbft_tpu_torch.types.block import tx_hash
from cometbft_tpu_torch.types.event_bus import (
    EVENT_QUERY_NEW_BLOCK,
    EventBus,
    flatten_abci_events,
)
from cometbft_tpu_torch.utils.db import DB
from cometbft_tpu_torch.utils.log import Logger, default_logger
from cometbft_tpu_torch.utils.protoio import ProtoReader, ProtoWriter
from cometbft_tpu_torch.utils.pubsub import Query
from cometbft_tpu_torch.utils.service import BaseService
from cometbft_tpu_torch.utils import sync as cmtsync

_PREFIX_RESULT = b"tx/"       # tx hash -> stored result
_PREFIX_TXKEY = b"txk/"       # composite event key -> tx hash
_PREFIX_BLOCKKEY = b"blk/"    # composite event key -> height
_PREFIX_TXHEIGHT = b"txh/"    # height/index -> tx hash


def _encode_result(height: int, index: int, tx: bytes,
                   result: ExecTxResult) -> bytes:
    w = ProtoWriter()
    w.varint(1, height)
    w.varint(2, index)
    w.bytes_(3, tx)
    w.varint(4, result.code)
    w.bytes_(5, result.data)
    w.string(6, result.log)
    w.varint(7, result.gas_wanted & 0xFFFFFFFFFFFFFFFF)
    w.varint(8, result.gas_used & 0xFFFFFFFFFFFFFFFF)
    ev = ProtoWriter()
    for event in result.events or ():
        e = ProtoWriter()
        e.string(1, event.type)
        for attr in event.attributes:
            a = ProtoWriter()
            a.string(1, attr.key)
            a.string(2, attr.value)
            a.bool_(3, attr.index)
            e.message(2, a.finish())
        ev.message(1, e.finish())
    w.message(9, ev.finish())
    return w.finish()


def _decode_result(data: bytes) -> dict:
    from cometbft_tpu_torch.abci.types import Event, EventAttribute

    f = ProtoReader(data).to_dict()
    events = []
    if 9 in f:
        ef = ProtoReader(bytes(f[9][0])).to_dict()
        for raw in ef.get(1, []):
            e = ProtoReader(bytes(raw)).to_dict()
            attrs = []
            for araw in e.get(2, []):
                a = ProtoReader(bytes(araw)).to_dict()
                attrs.append(
                    EventAttribute(
                        key=bytes(a.get(1, [b""])[0]).decode(),
                        value=bytes(a.get(2, [b""])[0]).decode(),
                        index=bool(a.get(3, [0])[0]),
                    )
                )
            events.append(
                Event(
                    type=bytes(e.get(1, [b""])[0]).decode(),
                    attributes=tuple(attrs),
                )
            )
    return {
        "height": int(f.get(1, [0])[0]),
        "index": int(f.get(2, [0])[0]),
        "tx": bytes(f.get(3, [b""])[0]),
        "result": ExecTxResult(
            code=int(f.get(4, [0])[0]),
            data=bytes(f.get(5, [b""])[0]),
            log=bytes(f.get(6, [b""])[0]).decode(),
            gas_wanted=int(f.get(7, [0])[0]),
            gas_used=int(f.get(8, [0])[0]),
            events=tuple(events),
        ),
    }


class TxIndexer:
    """KV tx indexer (state/txindex/kv/kv.go:42)."""

    def __init__(self, db: DB):
        self.db = db
        self._mtx = cmtsync.Mutex()

    def index(self, height: int, index: int, tx: bytes,
              result: ExecTxResult) -> None:
        h = tx_hash(tx)
        ops: list[tuple[bytes, bytes | None]] = [
            (
                _PREFIX_RESULT + h,
                _encode_result(height, index, tx, result),
            ),
            (
                _PREFIX_TXHEIGHT
                + height.to_bytes(8, "big")
                + index.to_bytes(4, "big"),
                h,
            ),
        ]
        events = flatten_abci_events(
            result.events, {}, indexed_only=True
        )
        for key, values in events.items():
            for value in values:
                ops.append(
                    (
                        _PREFIX_TXKEY
                        + key.encode()
                        + b"/"
                        + value.encode()
                        + b"/"
                        + height.to_bytes(8, "big")
                        + index.to_bytes(4, "big"),
                        h,
                    )
                )
        with self._mtx:
            self.db.write_batch(ops)

    def get(self, hash_: bytes) -> dict | None:
        raw = self.db.get(_PREFIX_RESULT + hash_)
        return _decode_result(bytes(raw)) if raw is not None else None

    def prune(self, retain_height: int) -> None:
        """Drop tx entries below ``retain_height`` (the pruner's indexer
        axis; reference kv.go Prune). Event keys embed the height before
        a 4-byte index, result records are located via the height rows."""
        ops: list[tuple[bytes, bytes | None]] = []
        bound = retain_height.to_bytes(8, "big")
        for key, h in self.db.iterator(
            _PREFIX_TXHEIGHT, _PREFIX_TXHEIGHT + bound
        ):
            ops.append((bytes(key), None))
            # The result record is keyed by tx hash only; if the same
            # tx bytes were re-indexed at a retained height, the hash
            # row now holds the NEWER record — leave it alive.
            rec = self.get(bytes(h))
            if rec is None or rec["height"] < retain_height:
                ops.append((_PREFIX_RESULT + bytes(h), None))
        for key, _ in self.db.prefix_iterator(_PREFIX_TXKEY):
            height = int.from_bytes(key[-12:-4], "big")
            if height < retain_height:
                ops.append((bytes(key), None))
        if ops:
            with self._mtx:
                self.db.write_batch(ops)

    def search(self, query: Query | str, limit: int = 100) -> list[dict]:
        """Match indexed txs against a pubsub query.  Conditions on
        ``tx.height`` / ``tx.hash`` plus event attributes are supported
        by re-evaluating the query against each tx's flattened events —
        correctness-first (kv.go Search does key-range planning)."""
        if isinstance(query, str):
            query = Query.parse(query)
        out: list[dict] = []
        seen: set[bytes] = set()
        for _, h in self.db.prefix_iterator(_PREFIX_TXHEIGHT):
            h = bytes(h)
            if h in seen:
                continue
            seen.add(h)
            entry = self.get(h)
            if entry is None:
                continue
            events = flatten_abci_events(
                entry["result"].events,
                {
                    "tx.hash": [h.hex().upper()],
                    "tx.height": [str(entry["height"])],
                },
            )
            if query.matches(events):
                out.append(entry)
                if len(out) >= limit:
                    break
        return out


class BlockIndexer:
    """KV block-event indexer (state/indexer/block/kv/kv.go)."""

    def __init__(self, db: DB):
        self.db = db
        self._mtx = cmtsync.Mutex()

    def index(self, height: int, finalize_events) -> None:
        events = flatten_abci_events(
            finalize_events, {}, indexed_only=True
        )
        ops: list[tuple[bytes, bytes | None]] = [
            (_PREFIX_BLOCKKEY + b"height/" + height.to_bytes(8, "big"),
             b"\x01")
        ]
        for key, values in events.items():
            for value in values:
                ops.append(
                    (
                        _PREFIX_BLOCKKEY
                        + key.encode()
                        + b"/"
                        + value.encode()
                        + b"/"
                        + height.to_bytes(8, "big"),
                        b"\x01",
                    )
                )
        with self._mtx:
            self.db.write_batch(ops)

    def prune(self, retain_height: int) -> None:
        """Drop block-event entries below ``retain_height``."""
        ops: list[tuple[bytes, bytes | None]] = []
        for key, _ in self.db.prefix_iterator(_PREFIX_BLOCKKEY):
            height = int.from_bytes(key[-8:], "big")
            if height < retain_height:
                ops.append((bytes(key), None))
        if ops:
            with self._mtx:
                self.db.write_batch(ops)

    def search(self, query: Query | str, limit: int = 100) -> list[int]:
        """Heights whose block events match the query."""
        if isinstance(query, str):
            query = Query.parse(query)
        matches: list[int] = []
        # collect per-height flattened events
        by_height: dict[int, dict[str, list[str]]] = {}
        for key, _ in self.db.prefix_iterator(_PREFIX_BLOCKKEY):
            rest = key[len(_PREFIX_BLOCKKEY):]
            height = int.from_bytes(rest[-8:], "big")
            body = rest[:-8].rstrip(b"/")
            ev = by_height.setdefault(
                height, {"block.height": [str(height)]}
            )
            if body and body != b"height":
                k, _, v = body.rpartition(b"/")
                ev.setdefault(k.decode(), []).append(v.decode())
        for height in sorted(by_height):
            if query.matches(by_height[height]):
                matches.append(height)
                if len(matches) >= limit:
                    break
        return matches


class NullIndexer:
    """(state/txindex/null, indexer/block/null)"""

    def index(self, *a, **kw) -> None:
        pass

    def get(self, hash_: bytes) -> None:
        return None

    def search(self, query, limit: int = 100) -> list:
        return []

    def prune(self, retain_height: int) -> None:
        pass


class IndexerService(BaseService):
    """Subscribes to the event bus and drives both indexers
    (state/txindex/indexer_service.go).

    Each ``NewBlock`` is indexed whole, its block events and then every
    tx with its FinalizeBlock result, as CometBFT's service indexes a
    block and its ``NumTxs`` txs as one batch.  The reference takes one
    message from a NewBlock and a Tx subscription in turn, each after up
    to 0.1 s: about ten txs a second while no block arrives, so a block
    of 256 txs takes ~26 s and the pruner can remove a height's rows
    before the rest of them are written, which then stay below its
    retain height."""

    def __init__(
        self,
        tx_indexer,
        block_indexer,
        event_bus: EventBus,
        logger: Logger | None = None,
    ):
        super().__init__(
            name="indexer",
            logger=logger or default_logger().with_fields(module="indexer"),
        )
        self.tx_indexer = tx_indexer
        self.block_indexer = block_indexer
        self.event_bus = event_bus
        self._thread: threading.Thread | None = None

    def on_start(self) -> None:
        self._block_sub = self.event_bus.subscribe(
            "indexer", EVENT_QUERY_NEW_BLOCK, capacity=200
        )
        self._thread = threading.Thread(
            target=self._run, name="indexer", daemon=True
        )
        self._thread.start()

    def on_stop(self) -> None:
        try:
            self.event_bus.unsubscribe_all("indexer")
        except Exception:  # noqa: BLE001
            pass
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def _run(self) -> None:
        while not self._quit.is_set():
            try:
                msg = self._block_sub.next(timeout=0.1)
            except TimeoutError:
                continue
            except Exception:  # noqa: BLE001 — bus stopped
                return
            try:
                self._on_block(msg.data)
            except Exception as exc:  # noqa: BLE001
                self.logger.error("indexing failed", err=repr(exc))

    def _on_block(self, data) -> None:
        from cometbft_tpu_torch.utils.trace import TRACER

        height = data.block.header.height
        resp = data.result_finalize_block
        # runs on the indexer thread: explicit parent arg links it into
        # the height's span tree (the stack can't — different thread)
        with TRACER.span(
            "indexer/index_block", cat="indexer", height=height,
            parent="height/pipeline",
        ):
            self.block_indexer.index(height, resp.events if resp else ())
            for i, tx in enumerate(data.block.data.txs if resp else ()):
                self.tx_indexer.index(height, i, tx, resp.tx_results[i])


__all__ = [
    "BlockIndexer",
    "IndexerService",
    "NullIndexer",
    "TxIndexer",
]
