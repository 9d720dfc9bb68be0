"""Event pub/sub with a query DSL (a copy of cometbft_tpu/utils/pubsub.py;
reference: libs/pubsub/pubsub.go:93, libs/pubsub/query/query.go).

Subscribers register a client id + query ("tm.event='NewBlock' AND
tx.height > 5"); published messages carry a map of composite-keyed
event attributes the queries match against.  Feeds WebSocket
subscribers and the tx/block indexers.

The server locks with ``utils/sync``'s ``RMutex()``.
"""

from __future__ import annotations

import queue
import re
import threading
from dataclasses import dataclass, field
from typing import Any

from cometbft_tpu_torch.utils import sync as cmtsync


class PubSubError(Exception):
    pass


class QueryError(PubSubError):
    pass


# -- query DSL ---------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""\s*(?:
        (?P<and>AND\b)
      | (?P<contains>CONTAINS\b)
      | (?P<exists>EXISTS\b)
      | (?P<op><=|>=|=|<|>)
      | (?P<str>'[^']*')
      | (?P<num>-?\d+(?:\.\d+)?)
      | (?P<key>[A-Za-z_][A-Za-z0-9_.\-]*)
    )""",
    re.VERBOSE,
)


@dataclass(frozen=True)
class _Condition:
    key: str
    op: str  # '=', '<', '>', '<=', '>=', 'CONTAINS', 'EXISTS'
    value: str | float | None = None

    def matches(self, events: dict[str, list[str]]) -> bool:
        vals = events.get(self.key)
        if vals is None:
            return False
        if self.op == "EXISTS":
            return True
        if self.op == "CONTAINS":
            return any(str(self.value) in v for v in vals)
        if self.op == "=":
            if isinstance(self.value, float):
                return any(_as_num(v) == self.value for v in vals)
            return any(v == self.value for v in vals)
        # numeric comparisons
        for v in vals:
            n = _as_num(v)
            if n is None:
                continue
            if (
                (self.op == "<" and n < self.value)
                or (self.op == ">" and n > self.value)
                or (self.op == "<=" and n <= self.value)
                or (self.op == ">=" and n >= self.value)
            ):
                return True
        return False


def _as_num(s: str) -> float | None:
    try:
        return float(s)
    except ValueError:
        return None


class Query:
    """Conjunctive query over event attributes (query/query.go)."""

    def __init__(self, conditions: tuple[_Condition, ...], source: str):
        self.conditions = conditions
        self._source = source

    @classmethod
    def parse(cls, s: str) -> "Query":
        if not s.strip():
            raise QueryError("empty query")
        tokens: list[tuple[str, str]] = []
        pos = 0
        while pos < len(s):
            m = _TOKEN_RE.match(s, pos)
            if m is None or m.end() == pos:
                if s[pos:].strip():
                    raise QueryError(f"cannot parse query at: {s[pos:]!r}")
                break
            pos = m.end()
            for name, val in m.groupdict().items():
                if val is not None:
                    tokens.append((name, val))
        conds: list[_Condition] = []
        i = 0
        while i < len(tokens):
            kind, val = tokens[i]
            if kind != "key":
                raise QueryError(f"expected attribute key, got {val!r}")
            if i + 1 >= len(tokens):
                raise QueryError("truncated query")
            okind, oval = tokens[i + 1]
            if okind == "exists":
                conds.append(_Condition(val, "EXISTS"))
                i += 2
            elif okind in ("op", "contains"):
                if i + 2 >= len(tokens):
                    raise QueryError("missing operand")
                vkind, vval = tokens[i + 2]
                if vkind == "str":
                    operand: str | float = vval[1:-1]
                elif vkind == "num":
                    operand = float(vval)
                else:
                    raise QueryError(f"bad operand {vval!r}")
                op = "CONTAINS" if okind == "contains" else oval
                if op in ("<", ">", "<=", ">=") and not isinstance(
                    operand, float
                ):
                    raise QueryError(f"operator {op} needs a number")
                conds.append(_Condition(val, op, operand))
                i += 3
            else:
                raise QueryError(f"expected operator after {val!r}")
            if i < len(tokens):
                akind, aval = tokens[i]
                if akind != "and":
                    raise QueryError(f"expected AND, got {aval!r}")
                i += 1
        return cls(tuple(conds), s)

    def matches(self, events: dict[str, list[str]]) -> bool:
        return all(c.matches(events) for c in self.conditions)

    def __str__(self) -> str:
        return self._source

    def __eq__(self, other) -> bool:
        return isinstance(other, Query) and self.conditions == other.conditions

    def __hash__(self) -> int:
        return hash(self.conditions)


ALL = Query((), "ALL")  # matches everything (query.All)


# -- server ------------------------------------------------------------

@dataclass
class Message:
    data: Any
    events: dict[str, list[str]] = field(default_factory=dict)


class Subscription:
    """One client's subscription; delivered via a bounded queue
    (pubsub.go Subscription)."""

    def __init__(self, client_id: str, query: Query, capacity: int):
        self.client_id = client_id
        self.query = query
        self._q: queue.Queue[Message] = queue.Queue(maxsize=max(capacity, 1))
        self._canceled = threading.Event()
        self.cancel_reason: str | None = None

    def next(self, timeout: float | None = None) -> Message:
        """Block for the next message; raises PubSubError if canceled."""
        while True:
            if self._canceled.is_set() and self._q.empty():
                raise PubSubError(
                    f"subscription canceled: {self.cancel_reason}"
                )
            try:
                return self._q.get(timeout=0.05 if timeout is None else min(timeout, 0.05))
            except queue.Empty:
                if timeout is not None:
                    timeout -= 0.05
                    if timeout <= 0:
                        raise TimeoutError("no message") from None

    def try_next(self) -> Message | None:
        try:
            return self._q.get_nowait()
        except queue.Empty:
            return None

    def _deliver(self, msg: Message) -> bool:
        try:
            self._q.put_nowait(msg)
            return True
        except queue.Full:
            return False

    def _cancel(self, reason: str) -> None:
        self.cancel_reason = reason
        self._canceled.set()

    @property
    def canceled(self) -> bool:
        return self._canceled.is_set()


class Server:
    """Pub/sub hub (pubsub.go Server).  Slow subscribers are canceled
    rather than blocking publishers (out-of-capacity policy).

    ``on_drop(client_id)`` fires once per out-of-capacity cancellation
    — the event bus feeds it into the subscriber-drop counter without
    this module depending on the metrics plane."""

    def __init__(self, capacity: int = 100, on_drop=None):
        self._mtx = cmtsync.RMutex()
        self._capacity = capacity
        self._on_drop = on_drop
        self._subs: dict[tuple[str, Query], Subscription] = {}

    def subscribe(
        self, client_id: str, query: Query | str, capacity: int | None = None
    ) -> Subscription:
        if isinstance(query, str):
            query = Query.parse(query)
        with self._mtx:
            key = (client_id, query)
            if key in self._subs:
                raise PubSubError(
                    f"already subscribed: {client_id} / {query}"
                )
            sub = Subscription(
                client_id, query, capacity or self._capacity
            )
            self._subs[key] = sub
            return sub

    def unsubscribe(self, client_id: str, query: Query | str) -> None:
        if isinstance(query, str):
            query = Query.parse(query)
        with self._mtx:
            sub = self._subs.pop((client_id, query), None)
            if sub is None:
                raise PubSubError("subscription not found")
            sub._cancel("unsubscribed")

    def unsubscribe_all(self, client_id: str) -> None:
        with self._mtx:
            keys = [k for k in self._subs if k[0] == client_id]
            if not keys:
                raise PubSubError("subscription not found")
            for k in keys:
                self._subs.pop(k)._cancel("unsubscribed")

    def publish(self, data: Any, events: dict[str, list[str]] | None = None):
        msg = Message(data=data, events=events or {})
        with self._mtx:
            dead = []
            for key, sub in self._subs.items():
                if sub.query.matches(msg.events):
                    if not sub._deliver(msg):
                        sub._cancel("out of capacity")
                        dead.append(key)
            for key in dead:
                del self._subs[key]
        for key in dead:
            if self._on_drop is not None:
                try:
                    self._on_drop(key[0])
                except Exception:  # noqa: BLE001 — telemetry must not kill publish
                    pass

    def queue_depths(self) -> dict[str, int]:
        """Deepest undelivered-message queue per client id — the
        backpressure signal the event-bus gauge exposes."""
        with self._mtx:
            out: dict[str, int] = {}
            for (cid, _), sub in self._subs.items():
                depth = sub._q.qsize()
                if depth > out.get(cid, -1):
                    out[cid] = depth
            return out

    def num_clients(self) -> int:
        with self._mtx:
            return len({cid for cid, _ in self._subs})

    def num_client_subscriptions(self, client_id: str) -> int:
        with self._mtx:
            return sum(1 for cid, _ in self._subs if cid == client_id)
