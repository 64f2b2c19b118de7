"""Observability: metrics logging, profiler traces, stage timers.

Counterpart of `e4s2024_tpu/utils/observability.py` (the reference has
tqdm, prints and a rank-0 tensorboardX writer, training/coach.py:221-225):

- `MetricsLogger`: a JSONL stream of scalar records, with tensorboardX
  scalars and images beside it where tensorboardX is installed,
- `profile_trace`: `torch.profiler` around a block, its Chrome trace
  written into a directory (open it in Perfetto or chrome://tracing),
- `StageTimer`: wall time per stage, each stage ended by a device
  synchronisation.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any

import numpy as np
import torch


class MetricsLogger:
    """Appends one JSON record per `log_scalars` call to
    `log_dir/metrics.jsonl`; mirrors scalars and images to tensorboardX
    when it can be imported (`use_tensorboard`)."""

    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self._tb = None
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except Exception:
                self._tb = None

    def log_scalars(self, step: int, metrics: dict[str, Any], prefix: str = ""):
        rec = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            rec[f"{prefix}{k}"] = float(v)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(f"{prefix}{k}", float(v), step)

    def log_image(self, step: int, tag: str, img: np.ndarray):
        """img: (H, W, 3) uint8; tensorboardX only."""
        if self._tb is not None:
            self._tb.add_image(tag, np.asarray(img), step, dataformats="HWC")

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Profile the block with `torch.profiler` (host ops, and the card's
    kernels where there is a card) and write its Chrome trace to
    `log_dir/trace.json`. Yields the profiler."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StageTimer:
    """Wall time of each stage in ms (`times`), accumulated over calls. A
    stage ends in a device synchronisation: on the device of `sync` when it
    is a CUDA tensor, else on every card there is (profiling only: the
    synchronisations cost throughput)."""

    def __init__(self):
        self.times: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync: Any = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if isinstance(sync, torch.Tensor):
                if sync.device.type == "cuda":
                    torch.cuda.synchronize(sync.device)
            elif torch.cuda.is_available():
                torch.cuda.synchronize()
            self.times[name] = self.times.get(name, 0.0) + (time.perf_counter() - t0) * 1e3

    def summary(self) -> str:
        total = sum(self.times.values())
        return "\n".join(f"{k}: {v:.3f} ms ({100 * v / max(total, 1e-9):.1f}%)"
                         for k, v in sorted(self.times.items(), key=lambda kv: -kv[1]))
