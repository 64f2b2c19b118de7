"""Planted-fault control for `chip_smoke.py` phase 9 ("train").

Phase 9 holds the trainer's per-step metrics through the kernels against
the same steps through their plain versions, within fixed limits. This
script reads how far a fault in a kernel of the training path moves those
metrics, beside the fault-free run, so that the limits can be set between
the two: each fault is patched into one autograd Function of the kernel
path (the plain versions never reach it) for one fit at phase 9's
configuration, against one fit of the plain versions, and for phase 2's
R1 check (a 256^2 Discriminator's R1 gradient against the plain versions
and float64). Needs one CUDA card:

    python3 train_fault_control.py

prints the card's name and power limit, then one JSON line per run: the
fault, each step's relative differences from the plain versions' metrics,
the phase-9 limits that they broke, and whether phase 2's R1 check failed.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def _scale_grad(cls, factor):
    """`cls.backward` with its first gradient scaled by `factor`."""
    orig = cls.backward

    def backward(ctx, *grads):
        out = orig(ctx, *grads)
        return (None if out[0] is None else out[0] * factor, *out[1:])
    return backward


def _slope(cls, slope):
    """`cls.backward` run with another negative slope (K1's backward kernel
    launched with the wrong slope)."""
    orig = cls.backward

    def backward(ctx, *grads):
        ctx.slope = slope
        return orig(ctx, *grads)
    return backward


def _faults():
    from e4s2024_torch.ops import fused_act, upfirdn

    k1, k1_bwd, k2_bwd = (fused_act._FusedLeakyReLU, fused_act._FusedLeakyReLUBackward,
                          upfirdn._UpFirDn2dBackward)
    return {
        "none": None,
        "K1 double backward x0.9": (k1_bwd, _scale_grad(k1_bwd, 0.9)),
        "K1 double backward x0": (k1_bwd, _scale_grad(k1_bwd, 0.0)),
        "K2 double backward x0.9": (k2_bwd, _scale_grad(k2_bwd, 0.9)),
        "K1 backward slope 0.25": (k1, _slope(k1, 0.25)),
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("train_fault_control: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smoke.phase_build(torch)
    rgi_sd, _ = smoke._random_state_dicts(torch)
    setup = smoke._train_setup(torch)
    plain = smoke._train_fit(torch, setup, rgi_sd, plain=True)[2]
    for name, fault in _faults().items():
        if fault is not None:
            cls, backward = fault
            orig = cls.backward
            cls.backward = staticmethod(backward)
        try:
            logs = smoke._train_fit(torch, setup, rgi_sd, plain=False)[2]
            try:
                smoke._r1_check(torch)
                r1_caught = False
            except AssertionError:
                r1_caught = True
        finally:
            if fault is not None:
                cls.backward = staticmethod(orig)
        rel, problems = smoke._train_compare(logs, plain)
        print(json.dumps({"fault": name, "caught": bool(problems), "vs_plain_rel": rel,
                          "problems": problems, "phase2_r1_caught": r1_caught}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
