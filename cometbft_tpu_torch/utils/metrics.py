"""Prometheus metrics: a dependency-free registry and the text
exposition (a copy of the registry half of cometbft_tpu/utils/metrics.py;
reference: the Metrics structs scripts/metricsgen generates).

Counter, Gauge and Histogram with labels, and the text exposition
format (version 0.0.4) that Prometheus scrapes.  The HTTP server and
its /debug routes are not part of the port yet.
"""

from __future__ import annotations

import bisect
import threading


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


class _Child:
    __slots__ = ("_value", "_mtx")

    def __init__(self):
        self._value = 0.0
        self._mtx = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._mtx:
            self._value += amount

    def set(self, value: float) -> None:
        with self._mtx:
            self._value = float(value)

    def get(self) -> float:
        with self._mtx:
            return self._value


class _HistChild:
    __slots__ = ("_buckets", "_counts", "_sum", "_count", "_mtx")

    def __init__(self, buckets: tuple[float, ...]):
        self._buckets = buckets
        self._counts = [0] * len(buckets)
        self._sum = 0.0
        self._count = 0
        self._mtx = threading.Lock()

    def observe(self, value: float) -> None:
        with self._mtx:
            self._sum += value
            self._count += 1
            # per-bucket counts; expose() cumulates them (the last bucket
            # is +Inf, so the index is always in range)
            self._counts[bisect.bisect_left(self._buckets, value)] += 1


class Metric:
    """One metric family; ``labels(**kv)`` returns the per-labelset
    child (the family itself serves a label-less metric)."""

    def __init__(self, kind: str, name: str, help_: str,
                 label_names: tuple[str, ...] = (), buckets: tuple[float, ...] = ()):
        self.kind = kind
        self.name = name
        self.help = help_
        self.label_names = label_names
        self.buckets = tuple(buckets) + (float("inf"),) if buckets else ()
        self._children: dict[tuple[str, ...], object] = {}
        self._mtx = threading.Lock()
        if not label_names:
            self._children[()] = self._new_child()

    def _new_child(self):
        if self.kind == "histogram":
            return _HistChild(self.buckets)
        return _Child()

    def labels(self, **kv: str):
        return self.child(*[str(kv.get(n, "")) for n in self.label_names])

    def child(self, *values: str):
        """``labels`` with the values as strings in ``label_names`` order:
        the per-batch call sites' form, no keyword dict built."""
        child = self._children.get(values)  # a hit takes no lock
        if child is None:
            with self._mtx:
                child = self._children.setdefault(values, self._new_child())
        return child

    def remove(self, **kv: str) -> None:
        """Drop one labelset's child so a retired label value (a
        departed peer, a closed WS client) stops exposing a stale
        series instead of lingering forever."""
        if not self.label_names:
            return  # the label-less child always exists
        key = tuple(str(kv.get(n, "")) for n in self.label_names)
        with self._mtx:
            self._children.pop(key, None)

    # label-less convenience passthroughs
    def inc(self, amount: float = 1.0) -> None:
        self._children[()].inc(amount)

    def set(self, value: float) -> None:
        self._children[()].set(value)

    def observe(self, value: float) -> None:
        self._children[()].observe(value)

    def expose(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} {self.kind}"]
        with self._mtx:
            children = dict(self._children)
        for key, child in sorted(children.items()):
            labels = dict(zip(self.label_names, key))
            if self.kind == "histogram":
                cum = 0
                for ub, c in zip(child._buckets, child._counts):
                    cum += c
                    bl = dict(labels, le=_fmt_value(ub))
                    lines.append(f"{self.name}_bucket{_fmt_labels(bl)} {cum}")
                lines.append(f"{self.name}_sum{_fmt_labels(labels)} {_fmt_value(child._sum)}")
                lines.append(f"{self.name}_count{_fmt_labels(labels)} {child._count}")
            else:
                lines.append(f"{self.name}{_fmt_labels(labels)} {_fmt_value(child.get())}")
        return lines


class Registry:
    """Metric registry (prometheus.Registry analog)."""

    def __init__(self, namespace: str = "cometbft"):
        self.namespace = namespace
        self._metrics: list[Metric] = []
        self._mtx = threading.Lock()

    def _register(self, metric: Metric) -> Metric:
        with self._mtx:
            if any(m.name == metric.name for m in self._metrics):
                raise ValueError(f"duplicate metric {metric.name}")
            self._metrics.append(metric)
        return metric

    def _full_name(self, subsystem: str, name: str) -> str:
        return "_".join(p for p in (self.namespace, subsystem, name) if p)

    def counter(self, subsystem: str, name: str, help_: str,
                labels: tuple[str, ...] = ()) -> Metric:
        return self._register(Metric("counter", self._full_name(subsystem, name), help_, labels))

    def gauge(self, subsystem: str, name: str, help_: str,
              labels: tuple[str, ...] = ()) -> Metric:
        return self._register(Metric("gauge", self._full_name(subsystem, name), help_, labels))

    def histogram(self, subsystem: str, name: str, help_: str, buckets: tuple[float, ...],
                  labels: tuple[str, ...] = ()) -> Metric:
        return self._register(Metric("histogram", self._full_name(subsystem, name), help_,
                                     labels, buckets))

    def expose(self) -> str:
        with self._mtx:
            metrics = list(self._metrics)
        lines: list[str] = []
        for m in metrics:
            lines.extend(m.expose())
        return "\n".join(lines) + "\n"


DEFAULT_TIME_BUCKETS = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)
