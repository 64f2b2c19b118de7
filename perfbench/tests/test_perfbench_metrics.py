"""The benchmark's metric arithmetic on the CPU: the kernels' least bytes
against the bound column of the port's kernel table, the idle share and
launch count of a synthetic trace, and the readers' refusals."""

import importlib.util
from pathlib import Path

import pytest
import torch

from perfbench import peaks, trace
from perfbench.harness import Reading, quantile
from perfbench.reference import plain_kernels as pk

H100 = "NVIDIA H100 80GB HBM3"
METRICS = Path(__file__).resolve().parents[1] / "metrics"


def reader(name):
    spec = importlib.util.spec_from_file_location(f"reader_{name}", METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def bound_ms(fn, *shapes):
    """The least time of one launch of `fn` over meta tensors of `shapes`."""
    args = [torch.empty(s, device="meta") for s in shapes]
    with pk.tally() as t:
        fn(*args)
    assert sum(t.calls.values()) == 1
    return 1e3 * peaks.bound_seconds(sum(t.bytes.values()), H100)


def test_k1_bound_matches_the_kernel_table():
    assert round(bound_ms(pk.fused_leaky_relu, (1, 32, 1024, 1024), (32,)), 4) == 0.0801


def test_k2_bound_matches_the_kernel_table():
    k = pk.make_kernel([1, 3, 3, 1])

    def up_blur(x):
        out = pk.blur(x, k, (1, 1), upsample_factor=2)
        assert out.shape[-2:] == (1024, 1024)

    assert round(bound_ms(up_blur, (1, 32, 1025, 1025)), 4) == 0.0802


def test_k3_bound_matches_the_kernel_table():
    got = bound_ms(pk.regional_scale, (1, 128, 256, 256), (1, 12, 256, 256), (1, 12, 128))
    assert round(got, 4) == 0.0210


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def synthetic_trace():
    """Three kernels (one overlapping another) and a memcpy over 100 us,
    launched by host ops; the device idles 0-2 and 20-30 us (under `aten::mm`)
    and 70-100 us."""
    return [
        _ev("cpu_op", "aten::conv", 0, 12), _ev("cuda_runtime", "cudaLaunchKernel", 1, 2),
        _ev("kernel", "k_conv", 2, 10), _ev("kernel", "k_act", 8, 12),
        _ev("cpu_op", "aten::mm", 18, 14), _ev("cuda_runtime", "cudaLaunchKernelExC", 29, 1),
        _ev("cuda_driver", "cuLaunchKernel", 30, 1),
        _ev("kernel", "upfirdn2d_kernel_rank1<float>", 30, 20),
        _ev("gpu_memcpy", "Memcpy DtoH", 50, 20), _ev("cpu_op", "python", 65, 40),
    ]


def test_trace_summary_of_a_synthetic_timeline():
    s = trace.summarize(synthetic_trace())
    assert s.busy_s == pytest.approx(58e-6)      # [2, 20] + [30, 70]
    assert s.launches == 3 and s.kernels == 3
    assert s.kernel_s["k_conv"] == pytest.approx(10e-6)
    gaps = dict(s.idle_gaps)
    assert gaps["aten::mm"] == pytest.approx(10e-6)
    assert list(gaps) == ["aten::mm"]           # the 70-100 gap ends the trace


def test_idle_share_and_launches_per_call():
    r = Reading(kind=H100, trace=trace.summarize(synthetic_trace()),
                slice_calls=3, slice_s=100e-6)
    assert reader("device_idle_share")(r) == pytest.approx(42.0)
    assert reader("launches_per_call")(r) == pytest.approx(1.0)


def _roofline_reading(k2_launches):
    with pk.tally() as t:
        pk.upsample_2x(torch.empty(1, 32, 512, 512, device="meta"), pk.make_kernel([1, 3, 3, 1]))
    s = trace.summarize(synthetic_trace())
    return Reading(kind=H100, trace=s, slice_calls=2, ref_tally=t,
                   port_launches={"fused_leaky_relu": 0, "upfirdn2d": k2_launches,
                                  "regional_scale": 0})


def test_roofline_is_the_bound_over_the_kernels_device_time():
    r = _roofline_reading(2)
    bytes_per_call = r.ref_tally.bytes["upfirdn2d"]
    want = 100 * peaks.bound_seconds(2 * bytes_per_call, H100) / 20e-6
    assert reader("kernels_roofline")(r) == pytest.approx(want)


def test_roofline_is_null_when_launch_counts_differ():
    r = _roofline_reading(3)
    assert reader("kernels_roofline")(r) is None
    assert "upfirdn2d launched 3 times" in r.notes[0]


def test_mfu_is_reference_flops_over_window_and_peak():
    r = Reading(kind=H100, calls=10, window_s=2.0, ref_flops=1e12)
    assert reader("mfu")(r) == pytest.approx(100 * 1e12 * 10 / 2.0 / 989.4e12)
    assert reader("mfu")(Reading(kind=H100)) is None


def test_an_unknown_card_has_no_peak():
    with pytest.raises(ValueError):
        peaks.peak("NVIDIA A100-SXM4-80GB", "flops_bf16")


def test_quantile_and_median_readers():
    lat = [i / 1000 for i in range(1, 101)]
    assert quantile(lat, 0.95) == pytest.approx(0.09595)
    r = Reading(kind=H100, latencies_s=lat)
    assert reader("swap_ms_p50")(r) == pytest.approx(50.5)
    assert reader("peak_mem_gib")(Reading(kind=H100,
                                          peak_mem_bytes=3 * 2 ** 30)) == 3.0
