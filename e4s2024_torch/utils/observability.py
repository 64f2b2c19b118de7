"""Observability: metrics logging, program spans, profiler traces, stage
timers.

Counterpart of `e4s2024_tpu/utils/observability.py` (the reference has
tqdm, prints and a rank-0 tensorboardX writer, training/coach.py:221-225):

- `MetricsLogger`: a JSONL stream of scalar records, with tensorboardX
  scalars and images beside it where tensorboardX is installed,
- `span`: a named stage of the program. Off (no `torch.profiler` active
  and no `StageTimer` attached) it costs one check; on, it records its
  host interval, its enclosing span, the id of the entry call it belongs
  to and, on a CUDA device, its interval on the current stream (two
  timing events), and under the profiler it is also a
  `record_function`, so that it lands in the Kineto trace on the device's
  clock. Closed spans stay in a bounded buffer (`recorded_spans`),
- `profile_trace`: `torch.profiler` around a block, its Chrome trace
  written into a directory (open it in Perfetto or chrome://tracing) with
  the block's spans beside it,
- `StageTimer`: ms per stage, read from the stage spans: the device's
  interval where there is one, else the host's. No stage synchronises
  the device; the events are read when `times` is.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Any

import numpy as np
import torch
from torch.autograd import _profiler_enabled

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


# closed spans, oldest first; the oldest are dropped past the bound
_SPANS: collections.deque = collections.deque(maxlen=1 << 16)
# StageTimers attached (`StageTimer.attach`): while any is, spans record
_ATTACHED: list = []
_ATTACH_LOCK = threading.Lock()
_OPEN = threading.local()          # .stack: this thread's open spans
_IDS = itertools.count(1)
_CALLS = itertools.count(1)
_OFF = contextlib.nullcontext()


class _Span:
    """One recorded span; `record()` resolves it once into a dict."""

    __slots__ = ("name", "stage", "id", "parent", "call", "t0", "t1", "events", "_rf",
                 "_device", "_record")

    def __init__(self, name: str, device, stage: bool):
        self.name, self.stage, self._device = name, stage, device
        self.events, self._rf, self._record = None, None, None

    def __enter__(self):
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        parent = stack[-1] if stack else None
        self.id = next(_IDS)
        self.parent = None if parent is None else parent.id
        self.call = next(_CALLS) if parent is None else parent.call
        if _profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        dev = _cuda_device(self._device)
        if dev is not None:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record(torch.cuda.current_stream(dev))
            self.events = (start, end, dev)
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.events[2]))
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        _OPEN.stack.pop()
        _SPANS.append(self)
        if self.stage:
            for timer in list(_ATTACHED):
                timer._stages.append(self)
        return False

    def record(self) -> dict:
        """The span as a dict: id, name, parent (the enclosing span's id or
        None), call (the id every span of one entry call shares), host
        start and end (`time.perf_counter` s), host_ms, and device_ms (None
        without a CUDA device). Waits for the span's end event, once."""
        if self._record is None:
            device_ms = None
            if self.events is not None:
                start, end, _ = self.events
                end.synchronize()
                device_ms = start.elapsed_time(end)
                self.events = None
            self._record = {"id": self.id, "name": self.name, "parent": self.parent,
                            "call": self.call, "start_s": self.t0, "end_s": self.t1,
                            "host_ms": (self.t1 - self.t0) * 1e3, "device_ms": device_ms}
        return self._record


def _cuda_device(device) -> torch.device | None:
    """The CUDA device a span times, or None: `device` (a device, its name
    or a tensor on it); None: the current device once CUDA is in use."""
    if isinstance(device, torch.Tensor):
        device = device.device
    if device is None:
        if not torch.cuda.is_initialized():
            return None
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    return device if device.type == "cuda" else None


def span(name: str, device: Any = None, stage: bool = False):
    """A context manager that records the block as the span `name` when a
    `torch.profiler` is active or a `StageTimer` is attached, and does
    nothing otherwise.

    `device` (a device, its name or a tensor on it) is the CUDA device
    whose current stream the span times; None: the current CUDA device
    once CUDA is in use; a CPU device: the host alone. A span opened
    inside another is its child and shares its call id; one opened
    outside every span starts a call. A `stage` span is also counted by
    every attached StageTimer."""
    if not _ATTACHED and not _profiler_enabled():
        return _OFF
    return _Span(name, device, stage)


def recorded_spans() -> list[dict]:
    """The buffer's spans as dicts (`_Span.record`), in the order they
    closed; waits for the device to finish them."""
    return [s.record() for s in list(_SPANS)]


def clear_spans() -> None:
    _SPANS.clear()


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Profile the block with `torch.profiler` (host ops, and the card's
    kernels where there is a card) and write its Chrome trace to
    `log_dir/trace.json` and the block's spans (`recorded_spans`), one
    JSON object a line, to `log_dir/spans.jsonl`. Yields the profiler."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    clear_spans()
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.jsonl"), "w") as f:
        for rec in recorded_spans():
            f.write(json.dumps(rec) + "\n")


class StageTimer:
    """ms of each stage (`times`), accumulated over calls: each stage's
    device interval on its CUDA stream, or its host interval where it
    timed no device. A stage is a `stage` span opened while the timer is
    attached (`attach`), or a block of `stage`. Nothing synchronises the
    device until `times` is read."""

    def __init__(self):
        self._stages: list[_Span] = []
        self._times: dict[str, float] = {}
        self._depth = 0

    @contextlib.contextmanager
    def attach(self):
        """Within the block every span records, and each `stage` span is
        one of this timer's stages."""
        with _ATTACH_LOCK:
            self._depth += 1
            if self._depth == 1:
                _ATTACHED.append(self)
        try:
            yield self
        finally:
            with _ATTACH_LOCK:
                self._depth -= 1
                if self._depth == 0:
                    _ATTACHED.remove(self)

    @contextlib.contextmanager
    def stage(self, name: str, sync: Any = None):
        """The block as the stage `name`, timed on the device of `sync` (a
        tensor, a device or its name; None: the current CUDA device once
        CUDA is in use)."""
        with self.attach(), span(name, sync, stage=True):
            yield

    @property
    def times(self) -> dict[str, float]:
        for s in self._stages:
            rec = s.record()
            ms = rec["host_ms"] if rec["device_ms"] is None else rec["device_ms"]
            self._times[s.name] = self._times.get(s.name, 0.0) + ms
        self._stages.clear()
        return dict(self._times)

    def summary(self) -> str:
        times = self.times
        total = sum(times.values())
        return "\n".join(f"{k}: {v:.3f} ms ({100 * v / max(total, 1e-9):.1f}%)"
                         for k, v in sorted(times.items(), key=lambda kv: -kv[1]))
