"""The benchmark's harness: finds a cell's files by name, runs its driver
over a timed window, reads its metrics, and prints the result.

Everything that belongs to one cell, configuration, traffic mix or metric
is a file of its own, found by the name that BENCHMARK.json gives:

- `perfbench/workloads/<cell>.json`: the driver, the traced slice's length
  and the limits of the comparison with the reference;
- `perfbench/configs/<config>.json` (the configuration's `file`): sizes,
  precision and the deployment it stands for;
- `perfbench/traffic/<traffic>.json`: the traffic generator's parameters;
- `perfbench/drivers/<driver>.py`: one per entry point of the port;
- `perfbench/metrics/<metric>.py`, or `<name before the first dot>.py`: a
  per-layer metric's reader, `read(reading) -> float | None`.

A run: set-up (weights drawn on the card, the program built, every shape
of the cell warmed), then the window: calls in a closed loop with one
client until `--seconds` have passed, the last call begun before that
finishing it. With `--trace 1` a slice of `trace_calls` further calls runs
under torch.profiler, for the per-layer readers. Then the program is
freed, and the plain reference recomputes what the window's calls
produced; `correct` is whether every compared number is within its limit.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import statistics
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

BANNED_MODULES = ("jax", "jaxlib", "flax", "optax", "orbax", "e4s2024_tpu")
HERE = Path(__file__).resolve().parent


class Refused(Exception):
    """A run that may print no result (no card, a bad cell)."""


@dataclass
class Context:
    """What a driver is given."""

    config: dict
    traffic: dict
    workload: dict
    seed: int
    device: object
    t_start: float = 0.0
    # set-up's parts in s, in order: "torch" (torch imported and the card
    # found; set by `main`), then each `lap`: "imports" (the benchmark's
    # and the program's modules), "traffic", "weights", "program", "warm"
    setup_split: dict = field(default_factory=dict)

    def lap(self, name: str) -> None:
        """Ends the set-up part `name` once the device has finished it."""
        sync(self.device)
        now = time.perf_counter()
        self.setup_split[name] = now - self.t_start - sum(self.setup_split.values())


@dataclass
class Reading:
    """What the per-layer readers read."""

    kind: str                      # the card's name
    calls: int = 0                 # calls completed in the window
    items: int = 0                 # pairs, steps or images in those calls
    window_s: float = 0.0
    latencies_s: list = field(default_factory=list)
    peak_mem_bytes: int = 0
    slice_calls: int = 0
    slice_s: float = 0.0
    trace: object = None           # trace.TraceSummary of the slice
    port_launches: dict = field(default_factory=dict)   # kernel counters over the slice
    ref_tally: object = None       # plain_kernels.Tally of one reference call
    ref_flops: float = 0.0         # FLOPs of one reference call
    notes: list = field(default_factory=list)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise Refused(f"no file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def reader_path(name: str) -> Path:
    full = HERE / "metrics" / f"{name}.py"
    return full if full.exists() else HERE / "metrics" / f"{name.split('.')[0]}.py"


def banned_loaded() -> list:
    """Top-level names of loaded modules that the port's runs may not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED_MODULES))


def cell_files(root: Path, bench: dict, cell_name: str):
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise Refused(f"no cell {cell_name!r} in BENCHMARK.json (cells: {sorted(cells)})")
    cell = cells[cell_name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[cell["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    workload = load_json(HERE / "workloads" / f"{cell_name}.json")
    return cell, config, traffic, workload


def set_precision(precision: dict) -> None:
    import torch

    torch.backends.cudnn.allow_tf32 = bool(precision["cudnn_allow_tf32"])
    torch.backends.cuda.matmul.allow_tf32 = bool(precision["matmul_allow_tf32"])


def quantile(values: list, q: float) -> float:
    """The q-quantile of `values` (q in (0, 1)), `statistics`' exclusive
    method."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=1000, method="exclusive")[round(q * 1000) - 1]


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(driver, seconds: float, device):
    """The timed window: calls until `seconds` have passed. Returns
    (latencies in s, items, window s)."""
    lat, items, i = [], 0, 0
    sync(device)
    t0 = time.perf_counter()
    while True:
        s = time.perf_counter()
        if s - t0 >= seconds:
            break
        items += driver.call(i)
        lat.append(time.perf_counter() - s)
        i += 1
    return lat, items, time.perf_counter() - t0


def traced_slice(driver, calls: int, first: int, reading: Reading) -> None:
    """`calls` more calls under torch.profiler; fills the reading's slice."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from e4s2024_torch import kernels
    from perfbench import trace

    kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for j in range(calls):
            driver.call(first + j)
        torch.cuda.synchronize()
        reading.slice_s = time.perf_counter() - t0
    reading.slice_calls = calls
    reading.port_launches = kernels.launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        del prof
        reading.trace = trace.summarize_file(path)


def reference_cost(driver, reading: Reading) -> None:
    """FLOPs and plain kernel calls of one reference call."""
    from torch.utils.flop_counter import FlopCounterMode

    from perfbench.reference import plain_kernels

    counter = FlopCounterMode(display=False)
    with plain_kernels.tally() as t, counter:
        driver.reference_call()
    reading.ref_flops = float(counter.get_total_flops())
    reading.ref_tally = t


def run_cell(ctx: Context, driver_cls, seconds: float, trace_on: bool):
    """Set-up, window, traced slice and check of one run. Returns
    (driver, reading, setup_s, checks)."""
    import torch

    on_card = ctx.device.type == "cuda"
    for name in driver_cls.PROGRAM_MODULES:
        importlib.import_module(name)
    ctx.lap("imports")
    driver = driver_cls(ctx)
    driver.build()
    driver.warm()
    ctx.lap("warm")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - ctx.t_start
    lat, items, window_s = window(driver, seconds, ctx.device)
    sync(ctx.device)
    reading = Reading(kind=torch.cuda.get_device_name(ctx.device) if on_card else "cpu",
                      calls=len(lat), items=items, window_s=window_s, latencies_s=lat)
    if on_card:
        reading.peak_mem_bytes = max(torch.cuda.max_memory_allocated(d)
                                     for d in range(torch.cuda.device_count()))
    if trace_on:
        traced_slice(driver, int(ctx.workload["trace_calls"]), len(lat), reading)
    driver.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = driver.check()
    if trace_on:
        reference_cost(driver, reading)
    return driver, reading, setup_s, checks


def format_checks(checks: list) -> dict:
    return {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}


def is_correct(checks: list) -> bool:
    return bool(checks) and all(c["value"] <= c["limit"] for c in checks)


def result_line(bench: dict, cell: str, chips: int, driver, reading: Reading,
                setup_s: float, setup_split: dict, checks: list, trace_on: bool) -> dict:
    """The run's result: the cell's end-to-end metrics (per-layer with
    `trace_on`), the device, set-up's parts, and every compared number
    with its limit, last."""
    metrics = {}
    if trace_on:
        for m in bench["per_layer"]:
            if not applies(m, cell):
                continue
            mod = load_module(reader_path(m["name"]), f"perfbench_metric_{m['name']}")
            value = mod.read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        for note in reading.notes:
            print(f"perfbench: {note}", file=sys.stderr)
    else:
        e2e = dict(driver.end_to_end(reading), setup_s=setup_s)
        for m in bench["end_to_end"]:
            if applies(m, cell):
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    device = {"platform": "gpu", "kind": reading.kind, "count": chips,
              "memory_peak_bytes": reading.peak_mem_bytes}
    result = {"correct": is_correct(checks), "attempted": reading.calls, "failed": 0,
              "metrics": metrics, "device": device, "setup_split_s": setup_split}
    if trace_on and reading.trace is not None:
        device.update(busy_s=reading.trace.busy_s, window_s=reading.slice_s)
        result["breakdown"] = {"device_ops": reading.trace.device_ops,
                               "idle_gaps": reading.trace.idle_gaps}
    result["checks"] = format_checks(checks)
    return result


def main(argv, root: Path, t_start: float) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        bench = load_json(root / "BENCHMARK.json")
        cell, config, traffic, workload = cell_files(root, bench, args.workload)
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            raise Refused(f"the cell needs {cell['chips']} CUDA device(s), this machine "
                          f"has {have}")
        torch_s = time.perf_counter() - t_start
        set_precision(config["precision"])
        driver_mod = load_module(HERE / "drivers" / f"{workload['driver']}.py",
                                 f"perfbench_driver_{workload['driver']}")
    except (Refused, OSError, KeyError, ImportError) as e:
        print(f"perfbench: {type(e).__name__}: {e}", file=sys.stderr)
        return 3
    ctx = Context(config=config, traffic=traffic, workload=workload,
                  seed=args.seed, device=torch.device("cuda", 0), t_start=t_start,
                  setup_split={"torch": torch_s})
    driver, reading, setup_s, checks = run_cell(ctx, driver_mod.Driver, args.seconds,
                                                bool(args.trace))
    found = banned_loaded()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4

    result = result_line(bench, args.workload, cell["chips"], driver, reading, setup_s,
                         ctx.setup_split, checks, bool(args.trace))
    sys.stdout.flush()
    lat_ms = sorted(1e3 * v for v in reading.latencies_s)
    print(f"perfbench: window {reading.window_s:.3f} s, {reading.calls} calls, "
          f"{reading.items} items; call ms p50 {quantile(lat_ms, 0.5):.3f}, "
          f"p95 {quantile(lat_ms, 0.95):.3f}, max {lat_ms[-1]:.3f}; set-up s "
          + ", ".join(f"{k} {v:.3f}" for k, v in ctx.setup_split.items()), file=sys.stderr)
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0
