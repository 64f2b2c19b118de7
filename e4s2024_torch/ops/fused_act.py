"""Fused bias-add + LeakyReLU + sqrt(2) gain, over kernel K1.

Counterpart of `e4s2024_tpu/ops/fused_act.py`; the kernel replaces
`e4s2024_tpu/ops/pallas/kernels.py::fused_leaky_relu_tpu` and lives in
`kernels/csrc/fused_act.cu`. Layout: channels on axis 1 (NCHW or (N, C)).
"""

from __future__ import annotations

import math

import torch

from e4s2024_torch import kernels
from e4s2024_torch.kernels.build import library

SQRT2 = math.sqrt(2.0)


def fused_leaky_relu_plain(x: torch.Tensor, bias: torch.Tensor | None = None,
                           negative_slope: float = 0.2,
                           scale: float = SQRT2) -> torch.Tensor:
    """`leaky_relu(x + bias) * scale`, bias broadcast over axis 1."""
    if bias is not None:
        x = x + bias.to(x.dtype).view(1, -1, *([1] * (x.ndim - 2)))
    return torch.where(x >= 0, x, x * negative_slope) * scale


@kernels.counted("fused_leaky_relu")
def fused_leaky_relu(x: torch.Tensor, bias: torch.Tensor | None = None,
                     negative_slope: float = 0.2,
                     scale: float = SQRT2) -> torch.Tensor:
    """`leaky_relu(x + bias) * scale`: the plain version on the CPU, kernel K1
    on a CUDA device (float32 or bfloat16 in, float32 arithmetic)."""
    if kernels.use_plain(x):
        return fused_leaky_relu_plain(x, bias, negative_slope, scale)
    name = "fused_leaky_relu"
    if x.ndim < 2:
        raise ValueError(f"{name}: x must have a channel axis, got {tuple(x.shape)}")
    kernels.check_input(name, "x", x)
    channels = x.shape[1]
    if bias is not None:
        if bias.shape != (channels,):
            raise ValueError(f"{name}: bias must be ({channels},), got {tuple(bias.shape)}")
        bias = bias.detach().to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty_like(x)
    status = library().e4s_fused_leaky_relu(
        x.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(),
        kernels.DTYPE_CODES[x.dtype], x.shape[0] * channels, channels,
        math.prod(x.shape[2:]), negative_slope, scale, x.device.index,
        kernels.stream_of(x))
    kernels.check_status(name, status)
    fused_leaky_relu.launches += 1
    return out


def scaled_leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """LeakyReLU followed by sqrt(2) gain, no bias (reference model.py:172)."""
    return fused_leaky_relu(x, None, negative_slope)
