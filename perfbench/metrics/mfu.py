"""The whole step's share of the card's dense bfloat16 peak (layer: whole
step): FLOPs of one call, counted by FlopCounterMode over the benchmark's
plain reference at the cell's shapes, times the calls completed in the
window, over the window's seconds and the peak (`perfbench/peaks.py`). A
float32 program cannot reach that peak; the share is a bound on every
kernel's work together."""

from perfbench import peaks


def read(r):
    if not r.ref_flops or not r.calls or r.window_s <= 0:
        return None
    return 100.0 * r.ref_flops * r.calls / r.window_s / peaks.peak(r.kind, "flops_bf16")
