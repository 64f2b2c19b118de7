"""The port's program spans (e4s2024_torch.utils.observability.span) on the
CPU, the port alone: off, a span records nothing and opens no
record_function; under torch.profiler one `swap_aligned` call records its
stage spans under the entry span, and the Chrome trace carries them as
user annotations; `profile_trace` writes the spans beside the trace; a
StageTimer keeps a stage that raised."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from e4s2024_torch.models.bisenet import BiSeNet
from e4s2024_torch.models.rgi import RGINet
from e4s2024_torch.pipelines.swap import FaceSwapper, SwapConfig
from e4s2024_torch.utils import observability
from e4s2024_torch.utils.observability import span

SIZE, REMAINING, UNITS = 64, 7, (1, 1, 1, 1)
SWAP_STAGES = ["upload", "upload", "parse", "invert", "merge", "synthesis", "composite"]


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two torch threads: the suite runs several workers on the host's
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def swapper():
    """The smallest swapper the port builds: 64^2, one IR-SE unit a stage,
    fast mode, weights from torch's seeded default initialisation."""
    torch.manual_seed(15)
    cfg = SwapConfig(out_size=SIZE, remaining_layer_idx=REMAINING, num_blend_levels=3,
                     regional_mode="fast")
    rgi = RGINet(out_size=SIZE, remaining_layer_idx=REMAINING, encoder_num_units=UNITS)
    return FaceSwapper(rgi.state_dict(), BiSeNet().state_dict(), cfg, device="cpu",
                       encoder_num_units=UNITS)


def _pair():
    rng = np.random.default_rng(15)
    img = (rng.random((2, 1, SIZE, SIZE, 3)) * 255).astype(np.uint8)
    return img[0], img[1]


def test_span_off_records_nothing_and_opens_no_record_function(swapper, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function opened with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    observability.clear_spans()
    with span("outer"), span("inner", "cpu", stage=True):
        pass
    swapper._as_u8(_pair()[0])          # the upload span of a real helper
    assert observability.recorded_spans() == []


def test_a_profiled_swap_records_its_stages_under_the_entry_span(swapper, tmp_path):
    """One `swap_aligned` call under torch.profiler: the two uploads, then
    parse, invert, merge, synthesis and composite, each a child of the
    entry span, all of one call id, with host times and no device time
    on the CPU; the exported Chrome trace names each as a user
    annotation."""
    observability.clear_spans()
    driven, target = _pair()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        swapper.swap_aligned(driven, target)
    recs = observability.recorded_spans()
    entry = recs[-1]
    assert entry["name"] == "swap_aligned" and entry["parent"] is None
    stages = recs[:-1]
    assert [r["name"] for r in stages] == SWAP_STAGES
    assert {r["parent"] for r in stages} == {entry["id"]}
    assert {r["call"] for r in recs} == {entry["call"]}
    for r in recs:
        assert r["host_ms"] >= 0 and r["device_ms"] is None
        assert entry["start_s"] <= r["start_s"] <= r["end_s"] <= entry["end_s"]
    starts = [r["start_s"] for r in stages]
    assert starts == sorted(starts)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    annotated = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert set(SWAP_STAGES) | {"swap_aligned"} <= annotated


def test_profile_trace_writes_the_spans_beside_the_trace(tmp_path):
    """The buffer is cleared on entry; spans.jsonl holds the block's spans
    with their call ids and parents; a second root span starts a call."""
    with profile(activities=[ProfilerActivity.CPU]):
        with span("before"):
            pass
    with observability.profile_trace(str(tmp_path)):
        with span("call"):
            with span("stage"):
                torch.ones(8, 8) @ torch.ones(8, 8)
        with span("next"):
            pass
    assert (tmp_path / "trace.json").is_file()
    recs = [json.loads(line) for line in (tmp_path / "spans.jsonl").read_text().splitlines()]
    by_name = {r["name"]: r for r in recs}
    assert [r["name"] for r in recs] == ["stage", "call", "next"]
    assert by_name["stage"]["parent"] == by_name["call"]["id"]
    assert by_name["stage"]["call"] == by_name["call"]["call"] != by_name["next"]["call"]
    assert by_name["call"]["parent"] is None and by_name["next"]["parent"] is None


def test_stage_timer_keeps_a_stage_that_raised():
    """A stage that raises still counts; an attached timer counts the
    `stage` spans opened inside, and no other span."""
    timer = observability.StageTimer()
    with pytest.raises(ValueError):
        with timer.stage("fails", sync=torch.ones(1)):
            raise ValueError
    with timer.attach():
        with span("entry"), span("gate", "cpu", stage=True):
            with span("helper"):
                pass
    assert set(timer.times) == {"fails", "gate"}
    assert all(v >= 0 for v in timer.times.values())
    with span("after", stage=True):
        pass
    assert set(timer.times) == {"fails", "gate"}
