"""The plain forms of the port's kernels K1-K3, and their byte counters.

Frozen copies of the plain versions in `e4s2024_torch/ops/fused_act.py`
(K1, bias + LeakyReLU 0.2 + gain sqrt 2), `ops/upfirdn.py` (K2, upfirdn2d)
and `ops/modulate.py` (K3, the per-pixel regional scale), with the
resampling helpers built on K2. Nothing here launches a kernel.

Inside `tally()` every call adds one to its kernel's count and the bytes
the kernel must move at the least: each input read once and each output
written once (the rule of the port's kernel table). The benchmark's
roofline readers take their bound from these counts.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

SQRT2 = math.sqrt(2.0)

# device kernel names of K1-K3 in the port (`kernels/csrc/*.cu`), for the
# readers that match a trace's kernels to these counts
KERNEL_NAMES = {
    "fused_leaky_relu": ("fused_leaky_relu_kernel",),
    "upfirdn2d": ("upfirdn2d_kernel",),
    "regional_scale": ("regional_scale_kernel",),
}


@dataclass
class Tally:
    """Calls and least bytes moved, per kernel name."""

    calls: dict = field(default_factory=dict)
    bytes: dict = field(default_factory=dict)

    def add(self, name: str, *tensors: torch.Tensor, extra: int = 0) -> None:
        self.calls[name] = self.calls.get(name, 0) + 1
        moved = extra + sum(t.numel() * t.element_size() for t in tensors)
        self.bytes[name] = self.bytes.get(name, 0) + moved


_TALLY: contextvars.ContextVar[Tally | None] = contextvars.ContextVar("tally", default=None)


@contextlib.contextmanager
def tally():
    """Count the plain kernel calls of the enclosed code into a new Tally."""
    t = Tally()
    token = _TALLY.set(t)
    try:
        yield t
    finally:
        _TALLY.reset(token)


def _count(name: str, *tensors, extra: int = 0) -> None:
    t = _TALLY.get()
    if t is not None:
        t.add(name, *tensors, extra=extra)


# ---------------------------------------------------------------- K1


def fused_leaky_relu(x: torch.Tensor, bias: torch.Tensor | None = None,
                     negative_slope: float = 0.2, scale: float = SQRT2) -> torch.Tensor:
    """`leaky_relu(x + bias) * scale`, bias broadcast over axis 1."""
    if bias is not None:
        x = x + bias.to(x.dtype).view(1, -1, *([1] * (x.ndim - 2)))
    out = torch.where(x >= 0, x, x * negative_slope) * scale
    # the kernel reads the bias as float32
    _count("fused_leaky_relu", x, out, extra=0 if bias is None else 4 * bias.numel())
    return out


def scaled_leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """LeakyReLU followed by sqrt(2) gain, no bias (reference model.py:172)."""
    return fused_leaky_relu(x, None, negative_slope)


# ---------------------------------------------------------------- K2


def make_kernel(k) -> torch.Tensor:
    """Normalised 2-D FIR kernel from a 1-D or 2-D tap list (reference
    model.py:23): the outer product of a 1-D list with itself, summing to 1."""
    k = np.asarray(k, dtype=np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    return torch.from_numpy(k / k.sum())


def upfirdn2d(x: torch.Tensor, kernel: torch.Tensor, up: int = 1, down: int = 1,
              pad: tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Zero-stuff by `up`, pad (negative pads crop), convolve with the
    flipped FIR kernel, keep every `down`-th sample. x: (N, C, H, W)."""
    n, c, h, w = x.shape
    xs = x
    if up > 1:
        xs = x.new_zeros(n, c, h * up, w * up)
        xs[:, :, ::up, ::up] = x
    xs = F.pad(xs, [pad[0], pad[1], pad[0], pad[1]])
    k = torch.flip(kernel, (0, 1)).to(device=x.device, dtype=x.dtype)
    k = k[None, None].expand(c, 1, *k.shape)
    out = F.conv2d(xs, k, stride=down, groups=c)
    _count("upfirdn2d", x, out)
    return out


def _resample_pads(kernel_size: int, factor: int, up: bool) -> tuple[int, int]:
    p = kernel_size - factor
    if up:
        return (p + 1) // 2 + factor - 1, p // 2
    return (p + 1) // 2, p // 2


def upsample_2x(x: torch.Tensor, kernel: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """FIR-interpolated upsample (reference model.py:34 `Upsample`)."""
    pad = _resample_pads(kernel.shape[0], factor, up=True)
    return upfirdn2d(x, kernel * (factor ** 2), factor, 1, pad)


def downsample_2x(x: torch.Tensor, kernel: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Anti-aliased downsample (reference model.py:56 `Downsample`)."""
    pad = _resample_pads(kernel.shape[0], factor, up=False)
    return upfirdn2d(x, kernel, 1, factor, pad)


def blur(x: torch.Tensor, kernel: torch.Tensor, pad: tuple[int, int],
         upsample_factor: int = 1) -> torch.Tensor:
    """Plain FIR blur with explicit pads (reference model.py:78 `Blur`)."""
    if upsample_factor > 1:
        kernel = kernel * (upsample_factor ** 2)
    return upfirdn2d(x, kernel, 1, 1, pad)


# ---------------------------------------------------------------- K3


def regional_scale(x: torch.Tensor, seg: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """out[b, c, h, w] = x[b, c, h, w] * sum_k seg[b, k, h, w] * scales[b, k, c].

    x: (B, C, H, W); seg: (B, K, H, W); scales: (B, K, C)."""
    out = x * torch.einsum("bkhw,bkc->bchw", seg, scales)
    _count("regional_scale", x, seg, scales, out)
    return out
