"""Grayscale dilation with a flat structuring element on (B, C, H, W)
masks. Out-of-image samples are ignored, as kornia's 'geodesic' border
does.

A frozen copy of `e4s2024_torch/ops/morphology.py` for the benchmark's plain
reference: no kernel, no split, no process group; it imports nothing of
the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dilation_planar(t: torch.Tensor, size: int) -> torch.Tensor:
    """Max over a size x size window, padded (size // 2, size - 1 - size // 2)."""
    p = size // 2
    q = size - 1 - p
    padded = F.pad(t, [p, q, p, q], value=float("-inf"))
    return F.max_pool2d(padded, size, stride=1)
