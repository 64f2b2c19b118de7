"""Pooling with torch semantics (`e4s2024_tpu/ops/pool.py`): max and average."""

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
