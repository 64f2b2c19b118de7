"""Pooling with torch semantics (`e4s2024_tpu/ops/pool.py`): max, average,
adaptive average and global average."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool2d(x: torch.Tensor, window: int = 2, stride: int | None = None,
               padding: int = 0) -> torch.Tensor:
    """MaxPool2d(window, stride, padding) on NCHW, floor mode; padded
    samples never win (they count as -inf)."""
    return F.max_pool2d(x, window, stride or window, padding)


def avg_pool2d(x: torch.Tensor, window: int = 2, stride: int | None = None) -> torch.Tensor:
    """torch F.avg_pool2d(window, stride) on NCHW, no padding (the JAX
    package's `avg_pool2d`)."""
    return F.avg_pool2d(x, window, stride or window)


def adaptive_avg_pool2d(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """torch AdaptiveAvgPool2d on NCHW: output bin i averages input rows
    [floor(i * H / out), ceil((i + 1) * H / out)), the bins the JAX
    package's `adaptive_avg_pool2d` builds as matrices."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    return F.adaptive_avg_pool2d(x, out_hw)


def global_avg_pool(x: torch.Tensor, keepdims: bool = True) -> torch.Tensor:
    """Mean over the spatial axes of an NCHW tensor."""
    return x.mean(dim=(2, 3), keepdim=keepdims)
