"""MFU and FLOP accounting for measured programs.

Counterpart of `e4s2024_tpu/utils/mfu.py`: the FLOPs of one call, the
achieved FLOP/s over a measured time, and MFU, the achieved rate over the
card's peak. The FLOPs come from `torch.utils.flop_counter.FlopCounterMode`,
which counts a multiply-add as 2 FLOPs, as XLA's counter does and as the
peaks are quoted. It counts matrix products, convolutions and attention,
not elementwise work (the hand-written kernels K1-K3 included), and a
padded convolution's every tap (XLA's only those inside the image). It has no
byte counter, so `bytes_accessed` is 0.0, the JAX package's value where
its backend exposes none.

Peaks: dense bfloat16 tensor-core FLOP/s by `torch.cuda.get_device_name`,
from NVIDIA's H100 specifications. An unknown card raises: a default
would make every MFU on another card wrong.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.flop_counter import FlopCounterMode

# device name -> dense bfloat16 FLOP/s
_PEAK_BF16: dict[str, float] = {
    "NVIDIA H100 80GB HBM3": 989.4e12,  # H100 SXM5
}


def chip_peak_flops(device: Any | None = None, kind: str | None = None) -> float:
    """Dense bfloat16 peak FLOP/s of the card (`device`, the current one by
    default), or of the card named `kind`. Raises for a card not in the
    table."""
    if kind is None:
        if not torch.cuda.is_available():
            raise RuntimeError("chip_peak_flops: no CUDA device is available; pass kind=")
        kind = torch.cuda.get_device_name(device)
    if kind not in _PEAK_BF16:
        raise ValueError(f"chip_peak_flops: no peak known for {kind!r} "
                         f"(known: {sorted(_PEAK_BF16)})")
    return _PEAK_BF16[kind]


def program_cost(fn, *args, **kwargs) -> dict:
    """Run `fn(*args, **kwargs)` once under FlopCounterMode:
    {"flops": float, "bytes_accessed": 0.0}."""
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    return {"flops": float(counter.get_total_flops()), "bytes_accessed": 0.0}


def mfu_report(flops_per_call: float, seconds_per_call: float, device: Any | None = None,
               kind: str | None = None) -> dict:
    """Achieved FLOP/s and MFU of a program measured at `seconds_per_call`."""
    peak = chip_peak_flops(device, kind)
    achieved = flops_per_call / max(seconds_per_call, 1e-12)
    return {
        "flops_per_call": flops_per_call,
        "achieved_tflops": round(achieved / 1e12, 3),
        "peak_tflops": round(peak / 1e12, 1),
        "mfu": round(achieved / peak, 4),
    }


def program_mfu(fn, seconds_per_call: float, *args, device: Any | None = None,
                kind: str | None = None, **kwargs) -> dict:
    """`program_cost` and `mfu_report` in one call: {"flops_per_call",
    "bytes_accessed", "achieved_tflops", "peak_tflops", "mfu"}."""
    cost = program_cost(fn, *args, **kwargs)
    rep = mfu_report(cost["flops"], seconds_per_call, device, kind)
    rep["bytes_accessed"] = cost["bytes_accessed"]
    return rep
