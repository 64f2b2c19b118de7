"""Reading a torch.profiler trace of a traced slice into the numbers the
per-layer readers take.

The slice is traced with CPU and CUDA activities and exported as a Chrome
trace (JSON, microseconds). From it:

- `busy_s`: the union of the device's kernel, memcpy and memset intervals;
- `launches`: the host's kernel-launch calls (`cudaLaunchKernel` and its
  kin, runtime or driver API);
- `kernels`: the device's kernel executions;
- `kernel_s`: device seconds per kernel name;
- `device_ops`: the ten kernels that took the most device time;
- `idle_gaps`: the device's idle gaps, summed by the innermost host
  operation or span that was running at each gap's middle, the ten
  largest.
"""

from __future__ import annotations

import bisect
import json
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@dataclass
class TraceSummary:
    busy_s: float = 0.0
    launches: int = 0
    kernels: int = 0
    kernel_s: dict = field(default_factory=dict)
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


def union_seconds(intervals) -> float:
    """Seconds covered by the union of (start, end) intervals in us."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total * 1e-6


def gaps(intervals) -> list:
    """The idle (start, end) gaps in us between the union's pieces."""
    out, cur_e = [], None
    for s, e in sorted(intervals):
        if cur_e is not None and s > cur_e:
            out.append((cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    return out


def _innermost(host: list, starts: list, t: float, depth: int = 400) -> str:
    """The name of the latest-starting host event that covers time t."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - depth, -1), -1):
        s, e, name = host[j]
        if e >= t:
            return name
    return "host (no operation recorded)"


def _top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def summarize(events: list) -> TraceSummary:
    """A TraceSummary of a Chrome trace's `traceEvents`."""
    dev, host, kernel_s, launches, kernels = [], [], {}, 0, 0
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur))
            if cat == "kernel":
                kernels += 1
                kernel_s[name] = kernel_s.get(name, 0.0) + dur * 1e-6
        elif cat in HOST_CATS:
            if "LaunchKernel" in name:
                launches += 1
            host.append((ts, ts + dur, name))
    host.sort()
    starts = [h[0] for h in host]
    gap_s: dict = {}
    for s, e in gaps(dev):
        name = _innermost(host, starts, 0.5 * (s + e))
        gap_s[name] = gap_s.get(name, 0.0) + (e - s) * 1e-6
    return TraceSummary(busy_s=union_seconds(dev), launches=launches, kernels=kernels,
                        kernel_s=kernel_s,
                        device_ops=_top(kernel_s), idle_gaps=_top(gap_s))


def summarize_file(path) -> TraceSummary:
    with open(path) as f:
        return summarize(json.load(f)["traceEvents"])
