"""Readings that set a cell's limits: the program's sound runs, the
control's, and the program's with a fault planted, on the card, at the
cell's own size and load.

    python3 perfbench/control.py --workload <cell> --seconds <s>
        --program-seeds 1,2,... --control-seeds 101,102,...
        --faults one_pair_swapped,... --fault-seeds 201,202,...

The control is the plain reference put in the program's place and computed
in the precision below the configuration's (TF32 in cuDNN and matmul for a
float32 configuration). A fault is one of `faults.FAULTS` for the cell's
driver, planted in the port. Each run is a window of `--seconds` at the
cell's traffic and the same comparison as a benchmark run; one JSON line
each, with every compared number. The limits in
`perfbench/workloads/<cell>.json` lie between the program's largest
reading and the control's smallest (PERF.md gives both). The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

ROOT = Path(__file__).resolve().parent.parent


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """A float32 tensor rounded to TF32's 10 mantissa bits (to nearest)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32Products(TorchFunctionMode):
    """Rounds the float32 inputs of convolutions and matrix products to
    TF32, as the card's TF32 tensor cores read them; for a CPU run."""

    FUNCS = {F.conv1d, F.conv2d, F.conv_transpose2d, F.linear, torch.matmul, torch.mm,
             torch.bmm, torch.einsum, torch.Tensor.matmul, torch.Tensor.__matmul__}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.FUNCS:
            def rnd(x):
                if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
                    return round_tf32(x)
                return x
            args = tuple(rnd(a) for a in args)
            kwargs = {k: rnd(v) for k, v in kwargs.items()}
        return func(*args, **kwargs)


@contextlib.contextmanager
def tf32(device):
    """TF32 in cuDNN and matmul, the precision below float32's: the
    control's. On the CPU, which has no TF32, the products' inputs are
    rounded to it."""
    if device.type != "cuda":
        with _TF32Products():
            yield
        return
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def control_driver(driver_cls):
    """`driver_cls` with the plain reference, computed in TF32, as its
    program: the window, the traced slice and the check are the cell's."""

    class Control(driver_cls):
        PROGRAM_MODULES = ()

        def build_program(self, state):
            ref = self.REFERENCE(self.reference_cfg(), device="meta")
            ref.load(state, self.ctx.device)
            return ref

        def program_call(self, driven, target):
            dev = self.ctx.device
            with tf32(dev):
                return self.reference_swap(self.program, torch.from_numpy(driven).to(dev),
                                           torch.from_numpy(target).to(dev))

    return Control


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    from perfbench import faults, harness

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell, config, traffic, workload = harness.cell_files(ROOT, bench, args.workload)
    harness.set_precision(config["precision"])
    driver = harness.load_module(harness.HERE / "drivers" / f"{workload['driver']}.py",
                                 "control_driver").Driver
    sound = contextlib.nullcontext
    runs = [("program", s, driver, sound) for s in _seeds(args.program_seeds)]
    runs += [("control", s, control_driver(driver), sound) for s in _seeds(args.control_seeds)]
    for name in (f for f in args.faults.split(",") if f):
        plant = faults.FAULTS[workload["driver"]][name]
        runs += [(name, s, driver, plant) for s in _seeds(args.fault_seeds)]
    for mode, seed, driver_cls, plant in runs:
        t0 = time.perf_counter()
        ctx = harness.Context(config=config, traffic=traffic, workload=workload, seed=seed,
                              device=torch.device("cuda", 0), t_start=t0)
        with plant():
            drv, reading, setup_s, checks = harness.run_cell(ctx, driver_cls, args.seconds,
                                                             False)
        print(json.dumps({"mode": mode, "seed": seed, "calls": reading.calls,
                          "setup_s": setup_s, "setup_split_s": ctx.setup_split,
                          "run_s": time.perf_counter() - t0,
                          "checks": {c["name"]: c["value"] for c in checks}}), flush=True)
        del drv, reading
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
