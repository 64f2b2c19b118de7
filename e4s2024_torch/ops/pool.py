"""Max pooling with torch MaxPool2d semantics (`e4s2024_tpu/ops/pool.py`)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool2d(x: torch.Tensor, window: int = 2, stride: int | None = None,
               padding: int = 0) -> torch.Tensor:
    """MaxPool2d(window, stride, padding) on NCHW, floor mode; padded
    samples never win (they count as -inf)."""
    return F.max_pool2d(x, window, stride or window, padding)
