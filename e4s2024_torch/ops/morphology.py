"""Grayscale dilation and erosion with a flat structuring element on
(B, C, H, W) masks (`e4s2024_tpu/ops/morphology.py`, whose `dilation`,
`erosion`, `opening` and `closing` take NHWC). Out-of-image samples are ignored, as kornia's
'geodesic' border does; erosion is the negated dilation of the negated
mask."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dilation_planar(t: torch.Tensor, size: int) -> torch.Tensor:
    """Max over a size x size window, padded (size // 2, size - 1 - size // 2)."""
    p = size // 2
    q = size - 1 - p
    padded = F.pad(t, [p, q, p, q], value=float("-inf"))
    return F.max_pool2d(padded, size, stride=1)


def dilation(x: torch.Tensor, size: int) -> torch.Tensor:
    """Max over a size x size flat structuring element. x: (B, C, H, W)."""
    return dilation_planar(x, size)


def erosion(x: torch.Tensor, size: int) -> torch.Tensor:
    """Min over a size x size flat structuring element. x: (B, C, H, W)."""
    return -dilation_planar(-x, size)


def opening(x: torch.Tensor, size: int) -> torch.Tensor:
    """Erosion, then dilation. x: (B, C, H, W)."""
    return dilation(erosion(x, size), size)


def closing(x: torch.Tensor, size: int) -> torch.Tensor:
    """Dilation, then erosion. x: (B, C, H, W)."""
    return erosion(dilation(x, size), size)
