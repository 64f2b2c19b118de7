"""The port's hand-written Hopper kernels: build, launch bookkeeping, checks.

The kernels' wrappers live beside their plain PyTorch versions in `ops/`
(`fused_act.fused_leaky_relu`, `upfirdn.upfirdn2d`,
`modulate.regional_scale`, `window_attention.swin_attention_nhwc`,
`window_attention.fused_window_attention`, `swin_block.fused_swin_block`).
A wrapper takes the plain version for a tensor on
the CPU and launches its kernel for a tensor on a CUDA device; it never falls
back from one to the other. Each wrapper carries an integer `launches`
counter that grows by one per kernel launch, so a run can show that it went
through the kernels.

K1-K3 are differentiable: each wrapper is a `torch.autograd.Function`
whose backward launches kernels too, counted under names of their own
(`fused_leaky_relu_backward`, `upfirdn2d_backward`,
`regional_scale_backward`). K1's and K2's backwards are differentiable
once more, through the same kernels (`fused_leaky_relu_double_backward`,
`upfirdn2d_double_backward`): R1's penalty runs through them. K3's
backward is once-differentiable, and its second derivative raises. K4-K6
are forward-only and refuse inputs that require grad.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

WRAPPERS: dict[str, Callable] = {}
_plain_on_card = False


def counted(name: str):
    """Register a kernel wrapper under `name` and give it a launch counter."""

    def register(fn):
        fn.launches = 0
        WRAPPERS[name] = fn
        return fn

    return register


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


@contextlib.contextmanager
def plain_versions_on_card():
    """Run the plain PyTorch versions on CUDA tensors too.

    For holding a whole run through the kernels against the same run through
    their plain versions on the same card; nothing on the main path enters it.
    """
    global _plain_on_card
    previous, _plain_on_card = _plain_on_card, True
    try:
        yield
    finally:
        _plain_on_card = previous


def use_plain(t: torch.Tensor) -> bool:
    """True for a CPU tensor (or inside `plain_versions_on_card`), False for
    a CUDA tensor; other devices have no kernel and raise."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return _plain_on_card
    raise RuntimeError(f"no kernel for device {t.device}")


def check_input(kernel: str, arg: str, t: torch.Tensor,
                dtype: torch.dtype | None = None, differentiable: bool = False) -> None:
    """Raise unless `t` is a contiguous CUDA tensor the kernel takes; an
    input that requires grad only where the kernel has a backward for it
    (`differentiable`)."""
    if t.device.type != "cuda":
        raise ValueError(f"{kernel}: {arg} must be on a CUDA device, got {t.device}")
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{kernel}: {arg} must be float32 or bfloat16, got {t.dtype}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{kernel}: {arg} is {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {arg} must be contiguous")
    if not differentiable and t.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(f"{kernel}: the kernel is forward-only; {arg} "
                           "requires grad")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_status(kernel: str, status: int) -> None:
    if status != 0:
        raise RuntimeError(f"{kernel}: launch failed with cudaError_t {status}")
