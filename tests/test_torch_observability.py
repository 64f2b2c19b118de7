"""The port's observability and MFU helpers (e4s2024_torch.utils.observability,
e4s2024_torch.utils.mfu) against the JAX package's, on the CPU: the JSONL
records, stage timing, a profiler trace, the FLOP count of a matrix
product and a convolution, and the peak table."""

import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from e4s2024_tpu.utils import mfu as jmfu
from e4s2024_tpu.utils import observability as jobs

from e4s2024_torch.pipelines import video
from e4s2024_torch.utils import mfu, observability
from tests.test_torch_criterion import two_threads  # noqa: F401


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_metrics_logger_writes_jax_records(tmp_path):
    """The same JSONL records as JAX's logger (the time stamp aside), with
    the prefix, appended across loggers on one directory."""
    steps = [(0, {"loss": 1.5, "l2": np.float32(0.25)}), (3, {"loss": torch.tensor(0.75)})]
    for pkg, d in ((observability, tmp_path / "port"), (jobs, tmp_path / "jax")):
        for _ in range(2):
            logger = pkg.MetricsLogger(str(d), use_tensorboard=False)
            for step, m in steps:
                logger.log_scalars(step, {k: float(v) for k, v in m.items()}, prefix="train/")
            logger.log_image(0, "img", np.zeros((4, 4, 3), np.uint8))
            logger.close()
    got, want = (_records(tmp_path / p / "metrics.jsonl") for p in ("port", "jax"))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.pop("time") > 0 and w.pop("time") > 0
        assert g == w


def test_stage_timer_accumulates_in_ms():
    """Stages accumulate over calls, in ms; a stage records its time when
    its block raises; `pipelines.video` re-exports the class."""
    timer = observability.StageTimer()
    for _ in range(2):
        with timer.stage("a", sync=torch.ones(2)):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with pytest.raises(ValueError):
        with timer.stage("b"):
            raise ValueError
    assert set(timer.times) == {"a", "b"} and all(v >= 0 for v in timer.times.values())
    lines = timer.summary().splitlines()
    assert len(lines) == 2 and lines[0].split(":")[0] == max(timer.times, key=timer.times.get)
    assert video.StageTimer is observability.StageTimer


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with observability.profile_trace(str(tmp_path)) as prof:
        torch.ones(32, 32) @ torch.ones(32, 32)
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("aten::mm" == e.key for e in prof.key_averages())


def test_program_cost_matches_jax():
    """A matrix product and an unpadded convolution: FLOPs = 2 x
    multiply-adds, equal to XLA's count in JAX's program_cost; bytes are
    not counted. (With padding the counts part: the flop counter counts
    every tap, XLA's only those inside the image.)"""
    a, b = torch.ones(8, 32), torch.ones(32, 16)
    cost = mfu.program_cost(torch.matmul, a, b)
    assert cost == {"flops": 2.0 * 8 * 32 * 16, "bytes_accessed": 0.0}
    jcost = jmfu.program_cost(jnp.matmul, jnp.ones((8, 32)), jnp.ones((32, 16)))
    assert cost["flops"] == jcost["flops"]

    x, w = torch.ones(2, 3, 16, 16), torch.ones(8, 3, 3, 3)
    cost = mfu.program_cost(F.conv2d, x, w)
    assert cost["flops"] == 2.0 * 2 * 8 * 14 * 14 * 3 * 3 * 3

    def jconv(x, w):
        return jax.lax.conv_general_dilated(x, w, (1, 1), "VALID",
                                            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    jcost = jmfu.program_cost(jconv, jnp.ones((2, 16, 16, 3)), jnp.ones((3, 3, 3, 8)))
    assert cost["flops"] == jcost["flops"]


def test_peaks_and_mfu_report():
    """The H100 SXM's dense bfloat16 peak; an unknown card raises and names
    itself; the report's numbers as JAX's formula gives them."""
    h100 = "NVIDIA H100 80GB HBM3"
    assert mfu.chip_peak_flops(kind=h100) == 989.4e12
    with pytest.raises(ValueError, match="NVIDIA A100-SXM4-80GB"):
        mfu.chip_peak_flops(kind="NVIDIA A100-SXM4-80GB")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mfu.chip_peak_flops()
    rep = mfu.mfu_report(989.4e12 * 0.02, 0.04, kind=h100)
    assert rep == {"flops_per_call": 989.4e12 * 0.02, "achieved_tflops": 494.7,
                   "peak_tflops": 989.4, "mfu": 0.5}
    rep = mfu.program_mfu(torch.matmul, 1e-6, torch.ones(4, 4), torch.ones(4, 4), kind=h100)
    assert rep["flops_per_call"] == 128.0 and rep["bytes_accessed"] == 0.0
