"""Planted-fault control for `chip_smoke.py` phase 9 ("train") and the
bfloat16 tuning of phase 10 ("edit").

Phase 9 holds the trainer's per-step metrics through the kernels against
the same steps through their plain versions, within fixed limits; phase 10
holds the per-step losses of bfloat16 PTI and stitching on phase 6's clip
the same way. This script reads how far a fault in a kernel of the path
moves those numbers, beside the fault-free run, so that the limits can be
set between the two: each fault is patched into one autograd Function of
the kernel path (the plain versions never reach it) for one run at the
phase's configuration, against one run of the plain versions. For phase
9 it also reads phase 2's R1 check (a 256^2 Discriminator's R1 gradient
against the plain versions and float64). Needs one CUDA card:

    python3 train_fault_control.py            # phase 9
    python3 train_fault_control.py --tune     # phase 10's bfloat16 tuning

prints the card's name and power limit, then one JSON line per run: the
fault, each step's relative differences from the plain versions', the
limits that they broke, and (phase 9) whether phase 2's R1 check failed.
"""

from __future__ import annotations

import contextlib
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


def _tune_faults():
    from e4s2024_torch.ops import fused_act, modulate, upfirdn

    k1, k2, k3 = fused_act._FusedLeakyReLU, upfirdn._UpFirDn2d, modulate._RegionalScale
    return {
        "none": None,
        "K1 backward slope 0.25": (k1, _slope(k1, 0.25)),
        "K2 backward x0.9": (k2, _scale_grad(k2, 0.9)),
        "K3 backward x0.9": (k3, _scale_grad(k3, 0.9)),
    }


@contextlib.contextmanager
def _planted(fault):
    if fault is None:
        yield
        return
    cls, backward = fault
    orig = cls.backward
    cls.backward = staticmethod(backward)
    try:
        yield
    finally:
        cls.backward = staticmethod(orig)


def tune_control(torch, smoke) -> None:
    """Phase 10's bfloat16 tuning under each fault of `_tune_faults`: the
    clip's PTI steps against one clip of the plain versions, and the
    stitching run with a border ring against its own plain-version run."""
    from e4s2024_torch import kernels

    rgi_sd, bise_sd = smoke._random_state_dicts(torch)
    swapper, nets, source, frames = smoke._tune_setup(torch, rgi_sd, bise_sd)
    pipe = smoke._tune_pipeline(swapper, nets, smoke.TUNE_BF16_PTI_STEPS,
                                smoke.TUNE_BF16_STITCHING_STEPS)
    with kernels.plain_versions_on_card():
        plain = smoke._video_run(torch, kernels, pipe, rgi_sd, source, frames)[2]
    for name, fault in _tune_faults().items():
        with _planted(fault):
            hist = smoke._video_run(torch, kernels, pipe, rgi_sd, source, frames)[2]
            swapper.rgi.load_state_dict(rgi_sd)  # as phase 10 starts its ring run
            u8, labels, sv = smoke._clip_inputs(torch, pipe, frames)
            ring, ring_problems = smoke._stitching_with_ring(
                torch, kernels, pipe, nets, u8, labels, sv, "bfloat16", smoke.TUNE_BF16_RING_LIMITS)
        rel, problems = smoke._tune_compare(hist, plain)
        print(json.dumps({"fault": name, "caught": bool(problems + ring_problems),
                          "vs_plain_rel": rel, "ring_vs_plain_rel": ring["vs_plain_loss_rel"],
                          "limits": [smoke.TUNE_BF16_PTI_LIMITS, smoke.TUNE_BF16_RING_LIMITS],
                          "problems": problems + ring_problems}),
              flush=True)
        del u8, labels, sv
        torch.cuda.empty_cache()


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
    if "--tune" in sys.argv[1:]:
        tune_control(torch, smoke)
        return 0
    rgi_sd, _ = smoke._random_state_dicts(torch)
    setup = smoke._train_setup(torch)
    plain = smoke._train_fit(torch, setup, rgi_sd, plain=True)[2]
    for name, fault in _faults().items():
        with _planted(fault):
            logs = smoke._train_fit(torch, setup, rgi_sd, plain=False)[2]
            try:
                smoke._r1_check(torch)
                r1_caught = False
            except AssertionError:
                r1_caught = True
        rel, problems = smoke._train_compare(logs, plain)
        print(json.dumps({"fault": name, "caught": bool(problems), "vs_plain_rel": rel,
                          "problems": problems, "phase2_r1_caught": r1_caught}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
