"""EventBus — typed domain events over pub/sub (a copy of
cometbft_tpu/types/event_bus.py; reference: types/event_bus.go:34,
types/events.go).

Everything consensus does is announced here; RPC WebSocket subscribers
and the tx/block indexers are the consumers.  ABCI events are flattened
into composite keys (``{type}.{attr_key}``) so the query DSL can filter
on app-defined attributes.

The bus locks through ``utils/sync`` (``Mutex()``, ``@guarded``) and
logs through ``utils.log``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

from cometbft_tpu_torch.utils.log import default_logger
from cometbft_tpu_torch.utils.pubsub import Query, Server, Subscription
from cometbft_tpu_torch.utils.service import BaseService
from cometbft_tpu_torch.utils import sync as cmtsync

# Event type values (types/events.go)
EVENT_NEW_BLOCK = "NewBlock"
EVENT_NEW_BLOCK_HEADER = "NewBlockHeader"
EVENT_NEW_BLOCK_EVENTS = "NewBlockEvents"
EVENT_NEW_EVIDENCE = "NewEvidence"
EVENT_TX = "Tx"
EVENT_NEW_ROUND_STEP = "NewRoundStep"
EVENT_NEW_ROUND = "NewRound"
EVENT_COMPLETE_PROPOSAL = "CompleteProposal"
EVENT_VOTE = "Vote"
EVENT_POLKA = "Polka"
EVENT_TIMEOUT_PROPOSE = "TimeoutPropose"
EVENT_TIMEOUT_WAIT = "TimeoutWait"
EVENT_VALIDATOR_SET_UPDATES = "ValidatorSetUpdates"
EVENT_PROPOSAL_BLOCK_PART = "ProposalBlockPart"

EVENT_TYPE_KEY = "tm.event"
TX_HASH_KEY = "tx.hash"
TX_HEIGHT_KEY = "tx.height"
BLOCK_HEIGHT_KEY = "block.height"


def query_for_event(event_type: str) -> Query:
    return Query.parse(f"{EVENT_TYPE_KEY}='{event_type}'")


EVENT_QUERY_NEW_BLOCK = query_for_event(EVENT_NEW_BLOCK)
EVENT_QUERY_NEW_BLOCK_HEADER = query_for_event(EVENT_NEW_BLOCK_HEADER)
EVENT_QUERY_TX = query_for_event(EVENT_TX)
EVENT_QUERY_VOTE = query_for_event(EVENT_VOTE)


def flatten_abci_events(
    abci_events, base: dict[str, list[str]], indexed_only: bool = False
) -> dict[str, list[str]]:
    """{type}.{key} composite keys (event_bus.go validateAndStringifyEvents)."""
    out = dict(base)
    for ev in abci_events or ():
        if not ev.type:
            continue
        for attr in ev.attributes:
            if indexed_only and not attr.index:
                continue
            key = f"{ev.type}.{attr.key}"
            out.setdefault(key, []).append(attr.value)
    return out


@dataclass
class EventDataNewBlock:
    block: Any
    block_id: Any
    result_finalize_block: Any = None


@dataclass
class EventDataNewBlockHeader:
    header: Any


@dataclass
class EventDataTx:
    height: int
    index: int
    tx: bytes
    result: Any


@dataclass
class EventDataVote:
    vote: Any


@dataclass
class EventDataRoundState:
    height: int
    round: int
    step: str


@dataclass
class EventDataNewRound:
    height: int
    round: int
    step: str
    proposer_address: bytes = b""


@dataclass
class EventDataCompleteProposal:
    height: int
    round: int
    step: str
    block_id: Any = None


@dataclass
class EventDataValidatorSetUpdates:
    validator_updates: tuple


@dataclass
class EventDataEvidence:
    evidence: Any
    height: int


@cmtsync.guarded
class EventBus(BaseService):
    """(types/event_bus.go:34)"""

    _GUARDED_BY = {"_gauged_clients": "_gauged_mtx"}

    def __init__(self, capacity: int = 1000, metrics=None):
        super().__init__(name="EventBus",
                         logger=default_logger().with_fields(module="EventBus"))
        from cometbft_tpu_torch.metrics import EventBusMetrics

        self.metrics = (
            metrics if metrics is not None else EventBusMetrics()
        )
        self._server = Server(capacity=capacity, on_drop=self._on_drop)
        #: clients currently holding a queue-depth gauge child, so a
        #: departed client's series is retired instead of lingering;
        #: the sweep is serialized (publish thread vs RPC unsubscribe)
        #: or a race could re-mint a child after its retirement and
        #: leak the series forever (per-connection ids never return)
        self._gauged_clients: set[str] = set()
        self._gauged_mtx = cmtsync.Mutex()

    def _on_drop(self, client_id: str) -> None:
        # per-client attribution lives in the log (client ids are
        # per-connection; labeling the counter would leak children)
        self.logger.info(
            "slow subscriber canceled", client=client_id
        )
        self.metrics.subscriber_dropped_total.inc()

    def on_start(self) -> None:
        pass

    def on_stop(self) -> None:
        pass

    # -- subscriptions -------------------------------------------------

    def subscribe(
        self, client_id: str, query: Query | str, capacity: int | None = None
    ) -> Subscription:
        return self._server.subscribe(client_id, query, capacity)

    def unsubscribe(self, client_id: str, query: Query | str) -> None:
        self._server.unsubscribe(client_id, query)
        # retire the departed client's gauge child NOW — waiting for
        # the next publish leaves a stale depth on /metrics exactly
        # when the bus goes idle (e.g. a halted chain mid-incident)
        if self.metrics.subscriber_queue_depth:
            self._update_queue_gauges()

    def unsubscribe_all(self, client_id: str) -> None:
        self._server.unsubscribe_all(client_id)
        if self.metrics.subscriber_queue_depth:
            self._update_queue_gauges()

    def num_clients(self) -> int:
        return self._server.num_clients()

    def num_client_subscriptions(self, client_id: str) -> int:
        return self._server.num_client_subscriptions(client_id)

    # -- publishers (event_bus.go PublishEvent*) ----------------------

    def _publish(self, event_type: str, data, events=None) -> None:
        base = {EVENT_TYPE_KEY: [event_type]}
        if events:
            for k, v in events.items():
                base.setdefault(k, []).extend(v)
        t0 = time.perf_counter()
        self._server.publish(data, base)
        self.metrics.publish_duration_seconds.observe(
            time.perf_counter() - t0
        )
        # the depth sweep re-locks the pubsub server and walks every
        # subscription — skip it entirely when nothing consumes it
        # (the no-op sink is falsy)
        if self.metrics.subscriber_queue_depth:
            self._update_queue_gauges()

    def _update_queue_gauges(self) -> None:
        """Mirror per-subscriber backlog into the queue-depth gauge and
        retire children of clients that have unsubscribed/been dropped
        (label-cardinality hygiene under WS client churn)."""
        with self._gauged_mtx:
            depths = self._server.queue_depths()
            gauge = self.metrics.subscriber_queue_depth
            for client_id, depth in depths.items():
                gauge.labels(client_id=client_id).set(depth)
            for client_id in self._gauged_clients - set(depths):
                gauge.remove(client_id=client_id)
            self._gauged_clients = set(depths)

    def publish_new_block(self, data: EventDataNewBlock) -> None:
        events = {BLOCK_HEIGHT_KEY: [str(data.block.header.height)]}
        resp = data.result_finalize_block
        merged = flatten_abci_events(
            getattr(resp, "events", ()), events
        )
        self._publish(EVENT_NEW_BLOCK, data, merged)

    def publish_new_block_header(self, data: EventDataNewBlockHeader) -> None:
        self._publish(
            EVENT_NEW_BLOCK_HEADER,
            data,
            {BLOCK_HEIGHT_KEY: [str(data.header.height)]},
        )

    def publish_new_block_events(self, height: int, abci_events) -> None:
        merged = flatten_abci_events(
            abci_events, {BLOCK_HEIGHT_KEY: [str(height)]}
        )
        self._publish(EVENT_NEW_BLOCK_EVENTS, height, merged)

    def publish_tx(self, data: EventDataTx) -> None:
        from cometbft_tpu_torch.types.block import tx_hash

        base = {
            TX_HASH_KEY: [tx_hash(data.tx).hex().upper()],
            TX_HEIGHT_KEY: [str(data.height)],
        }
        merged = flatten_abci_events(
            getattr(data.result, "events", ()), base
        )
        self._publish(EVENT_TX, data, merged)

    def publish_vote(self, data: EventDataVote) -> None:
        self._publish(EVENT_VOTE, data)

    def publish_new_round_step(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_NEW_ROUND_STEP, data)

    def publish_new_round(self, data: EventDataNewRound) -> None:
        self._publish(EVENT_NEW_ROUND, data)

    def publish_complete_proposal(self, data: EventDataCompleteProposal) -> None:
        self._publish(EVENT_COMPLETE_PROPOSAL, data)

    def publish_polka(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_POLKA, data)

    def publish_timeout_propose(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_TIMEOUT_PROPOSE, data)

    def publish_timeout_wait(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_TIMEOUT_WAIT, data)

    def publish_validator_set_updates(
        self, data: EventDataValidatorSetUpdates
    ) -> None:
        self._publish(EVENT_VALIDATOR_SET_UPDATES, data)

    def publish_new_evidence(self, data: EventDataEvidence) -> None:
        self._publish(EVENT_NEW_EVIDENCE, data)
