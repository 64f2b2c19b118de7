"""The readers of the port's spans on the CPU: per-call ms from a synthetic
span buffer, None without spans or without the port's buffer, and nested
spans of one name counted once (`perfbench/spans.py`)."""

import importlib.util
from pathlib import Path

import pytest

from perfbench import spans
from perfbench.harness import Reading

METRICS = Path(__file__).resolve().parents[1] / "metrics"
SWAP_READERS = {"upload_ms": "upload", "parse_ms": "parse", "invert_ms": "invert",
                "merge_ms": "merge", "synthesis_ms": "synthesis",
                "composite_ms": "composite"}
BATCH_READERS = {"enhance_ms": "enhance", "core_swap_ms": "core_swap",
                 "recolor_ms": "recolor", "inpaint_ms": "inpaint"}


def reader(name):
    spec = importlib.util.spec_from_file_location(f"reader_{name}", METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _span(i, name, parent, call, host_ms, device_ms):
    return {"id": i, "name": name, "parent": parent, "call": call, "start_s": 0.0,
            "end_s": 0.0, "host_ms": host_ms, "device_ms": device_ms}


def swap_buffer(calls):
    """`calls` swap_aligned calls as the port records them, closing order:
    stage k of call c takes (k + 1) device ms, its entry 100 + c host ms."""
    out, i = [], 0
    for c in range(calls):
        entry = i = i + 1
        for k, name in enumerate(["upload", "upload", "parse", "invert", "merge",
                                  "synthesis", "composite"]):
            i += 1
            out.append(_span(i, name, entry, c, 0.5, float(k + 1)))
        out.append(_span(entry, "swap_aligned", None, c, 100.0 + c, 80.0))
    return out


def test_swap_readers_give_device_ms_per_call(monkeypatch):
    monkeypatch.setattr(spans, "recorded", lambda: swap_buffer(4))
    r = Reading(kind="test", slice_calls=4)
    got = {name: reader(name)(r) for name in SWAP_READERS}
    assert got == {"upload_ms": 3.0, "parse_ms": 3.0, "invert_ms": 4.0, "merge_ms": 5.0,
                   "synthesis_ms": 6.0, "composite_ms": 7.0}
    assert reader("dispatch_ms")(r) == pytest.approx(101.5)     # host ms, 100 .. 103


def test_batch_readers_give_device_ms_per_call(monkeypatch):
    buf = []
    for c in range(3):
        root = 100 * c + 1
        buf += [_span(root + 1 + k, name, root, c, 1.0, 10.0 * (k + 1))
                for k, name in enumerate(BATCH_READERS.values())]
        buf.append(_span(root, "swap_batch", None, c, 1.0, 500.0))
    monkeypatch.setattr(spans, "recorded", lambda: buf)
    r = Reading(kind="test", slice_calls=3)
    assert [reader(name)(r) for name in BATCH_READERS] == [10.0, 20.0, 30.0, 40.0]


def test_readers_give_none_without_spans(monkeypatch):
    r = Reading(kind="test", slice_calls=16)
    monkeypatch.setattr(spans, "recorded", lambda: [])
    for name in [*SWAP_READERS, *BATCH_READERS, "dispatch_ms"]:
        assert reader(name)(r) is None
    # spans of the other cell only, or no traced slice
    monkeypatch.setattr(spans, "recorded", lambda: swap_buffer(2))
    assert reader("recolor_ms")(r) is None
    assert reader("parse_ms")(Reading(kind="test", slice_calls=0)) is None
    # spans without a device time (the CPU)
    cpu = [dict(s, device_ms=None) for s in swap_buffer(1)]
    monkeypatch.setattr(spans, "recorded", lambda: cpu)
    assert reader("synthesis_ms")(r) is None


def test_a_port_without_the_span_buffer_reads_as_no_spans(monkeypatch):
    from e4s2024_torch.utils import observability

    monkeypatch.delattr(observability, "recorded_spans")
    assert spans.recorded() == []
    assert reader("parse_ms")(Reading(kind="test", slice_calls=1)) is None


def test_nested_spans_of_one_name_count_once():
    """A `core_swap` that holds the swap's stages under a non-fused
    `swap_aligned`, and an `upload` nested in another: each time counted
    once, in the outermost span of its name."""
    buf = [_span(3, "upload", 2, 1, 1.0, 2.0), _span(2, "upload", 1, 1, 2.0, 3.0),
           _span(5, "parse", 4, 1, 1.0, 4.0), _span(4, "swap_aligned", 1, 1, 9.0, 9.0),
           _span(1, "core_swap", None, 1, 20.0, 30.0),
           _span(7, "parse", 6, 2, 1.0, 6.0), _span(6, "core_swap", None, 2, 20.0, 40.0)]
    assert spans.total_ms(buf, "upload") == 3.0
    assert spans.total_ms(buf, "parse") == 10.0
    assert spans.total_ms(buf, "core_swap") == 70.0
    assert spans.total_ms(buf, "core_swap", "host_ms") == 40.0
    assert spans.total_ms(buf, "recolor") is None
