"""The port's span tracer (cometbft_tpu_torch/utils/trace.py) against the
reference's (cometbft_tpu/utils/trace.py): one scripted sequence of
spans on both gives the same events (names, categories, phases and
arguments, the parent links included), and the same export structure.
Times are the clocks' and are only checked for containment."""

import json
import threading

import pytest

from cometbft_tpu.utils.trace import SpanTracer as JSpanTracer
from cometbft_tpu_torch.utils import trace as T


def _script(tracer):
    with tracer.span("outer", cat="crypto", batch=4) as sp:
        with tracer.span("device_launch", cat="device", kernel="keyed", batch=256,
                         bucket=128, window_bits=8):
            pass
        sp.set(ok=True)
    with pytest.raises(ValueError):
        with tracer.span("verify_queue/launch", cat="crypto", batch=3, priority="prefetch"):
            raise ValueError("boom")
    tracer.add_complete("step", 0.0, 0.001, cat="consensus", args={"height": 7})

    def other():
        with tracer.span("verify_queue/prepare", cat="crypto", batch=2, priority="ingest"):
            pass

    t = threading.Thread(target=other, name="collector")
    t.start()
    t.join(10)
    return [(e["name"], e["cat"], e["ph"], e["args"]) for e in tracer.events()]


def test_span_events_match_reference():
    port, ref = T.SpanTracer(capacity=64), JSpanTracer(capacity=64, enabled=True)
    assert _script(port) == _script(ref)
    events = port.events()
    inner, outer = events[0], events[1]
    assert inner["args"]["parent"] == "outer" and "parent" not in outer["args"]
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert events[2]["args"]["error"] == "ValueError"
    assert port.current_spans() == {}


def test_export_matches_reference_structure(tmp_path):
    port, ref = T.SpanTracer(capacity=64), JSpanTracer(capacity=64, enabled=True)
    _script(port)
    _script(ref)
    pe, re_ = port.export(), ref.export()
    assert pe.keys() == re_.keys() and pe["displayTimeUnit"] == re_["displayTimeUnit"]
    strip = lambda doc: [(e["name"], e["ph"], e["args"].get("name")) for e in doc["traceEvents"]
                         if e["ph"] == "M"]  # noqa: E731
    assert sorted(strip(pe), key=str) == sorted(strip(re_), key=str)
    assert sorted(pe["otherData"]) == sorted(re_["otherData"])
    path = tmp_path / "trace.json"
    port.dump(str(path))
    assert json.loads(path.read_text())["traceEvents"] == json.loads(port.export_json())[
        "traceEvents"]


def test_ring_bounds_and_disabled_tracer():
    port, ref = T.SpanTracer(capacity=2), JSpanTracer(capacity=2, enabled=True)
    for tracer in (port, ref):
        for i in range(5):
            with tracer.span("s%d" % i):
                pass
    assert [e["name"] for e in port.events()] == [e["name"] for e in ref.events()] == ["s3", "s4"]
    assert port.export()["otherData"]["dropped_spans"] == 3
    port.set_enabled(False)
    assert port.span("x") is T.NOP_SPAN
    with port.span("x") as sp:
        sp.set(a=1)
    port.add_complete("y", 0.0, 1.0)
    assert len(port.events()) == 2
    port.clear()
    assert port.events() == [] and port.export()["otherData"]["dropped_spans"] == 0
    assert T.TRACER.enabled
