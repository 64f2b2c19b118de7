"""Compositing on (B, C, H, W) tensors: Laplacian-pyramid blending, soft
erosion, the Sobel edge and the masked blend.

The pyramid filters are OpenCV's pyrDown / pyrUp with the REFLECT_101
border, written as shifted multiply-adds; the soft-erosion cone filter runs
as the separable terms of its SVD.

A frozen copy of `e4s2024_torch/ops/blend.py` for the benchmark's plain
reference: no kernel, no split, no process group; it imports nothing of
the port.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

# cv2 pyramid kernel: outer([1, 4, 6, 4, 1] / 16)
_PYR_TAPS = np.array([1.0, 4.0, 6.0, 4.0, 1.0], dtype=np.float32) / 16.0


def _pad_axis(x: torch.Tensor, axis: int, lo: int, hi: int, mode: str) -> torch.Tensor:
    """Pad axis -2 or -1 of a 4-D tensor."""
    pads = [lo, hi, 0, 0] if axis == -1 else [0, 0, lo, hi]
    return F.pad(x, pads, mode=mode)


def _slice(x: torch.Tensor, axis: int, start: int, stop: int, step: int = 1) -> torch.Tensor:
    if axis == -1:
        return x[..., start:stop:step]
    return x[..., start:stop:step, :]


def _down2_axis(x: torch.Tensor, taps: np.ndarray, axis: int) -> torch.Tensor:
    """One axis of cv2.pyrDown, computing only the kept (even) samples."""
    k = len(taps)
    p = k // 2
    n = x.shape[axis]
    xp = _pad_axis(x, axis, p, p, "reflect")
    return sum(float(taps[i]) * _slice(xp, axis, i, i + n - 1, 2) for i in range(k))


def pyr_down_planar(t: torch.Tensor) -> torch.Tensor:
    """cv2.pyrDown on (B, C, H, W)."""
    return _down2_axis(_down2_axis(t, _PYR_TAPS, -2), _PYR_TAPS, -1)


def _up2_axis(x: torch.Tensor, taps: np.ndarray, axis: int) -> torch.Tensor:
    """One axis of cv2.pyrUp as a polyphase filter on x (z[2k] = x[k]):
      out[2y]   = t0 * x[y-1] + t2 * x[y] + t4 * x[y+1]
      out[2y+1] = t1 * x[y]   + t3 * x[y+1]
    REFLECT_101 on z maps x[-1] to x[1] and x[n] to x[n-1]."""
    n = x.shape[axis]
    xp = torch.cat([_slice(x, axis, 1, 2), x, _slice(x, axis, n - 1, n)], dim=axis)

    def sl(lo):
        return _slice(xp, axis, lo, lo + n)

    t0, t1, t2, t3, t4 = (float(v) for v in taps)
    even = t0 * sl(0) + t2 * sl(1) + t4 * sl(2)
    odd = t1 * sl(1) + t3 * sl(2)
    ax = x.ndim + axis
    out = torch.stack([even, odd], dim=ax + 1)
    return out.reshape(*x.shape[:ax], 2 * n, *x.shape[ax + 1:])


def pyr_up_planar(t: torch.Tensor) -> torch.Tensor:
    """cv2.pyrUp on (B, C, H, W)."""
    taps = _PYR_TAPS * 2.0
    return _up2_axis(_up2_axis(t, taps, -2), taps, -1)


def laplacian_pyramid_blend_planar(a: torch.Tensor, b: torch.Tensor,
                                   mask: torch.Tensor,
                                   num_levels: int = 10) -> torch.Tensor:
    """Blend a (where mask = 1) over b band by band (reference
    multi_band_blending.py:6-47). a, b: (B, C, H, W); mask: (B, 1, H, W).
    num_levels is clamped so the coarsest level is at least 2 pixels."""
    num_levels = min(num_levels, int(math.log2(min(a.shape[-2], a.shape[-1]))))
    c = a.shape[1]
    g = [torch.cat([a, b, mask], dim=1)]
    for _ in range(num_levels - 1):
        g.append(pyr_down_planar(g[-1]))

    def split(t):
        return t[:, :c], t[:, c:2 * c], t[:, 2 * c:]

    ga, gb, gm = split(g[num_levels - 1])
    out = ga * gm + gb * (1.0 - gm)
    for i in range(num_levels - 1, 0, -1):
        ua, ub, _ = split(pyr_up_planar(g[i]))
        pa, pb, pm = split(g[i - 1])
        ls = (pa - ua) * pm + (pb - ub) * (1.0 - pm)
        out = pyr_up_planar(out) + ls
    return out


def _soft_erosion_kernel(kernel_size: int) -> np.ndarray:
    r = kernel_size // 2
    yy, xx = np.meshgrid(np.arange(kernel_size, dtype=np.float32),
                         np.arange(kernel_size, dtype=np.float32), indexing="ij")
    dist = np.sqrt((xx - r) ** 2 + (yy - r) ** 2)
    kern = dist.max() - dist
    return kern / kern.sum()


@functools.lru_cache(maxsize=None)
def _cone_svd_terms(kernel_size: int) -> tuple:
    """The radial cone kernel as the rank-1 (column, row) tap pairs of its
    SVD, truncated where the singular values reach float precision."""
    k2 = _soft_erosion_kernel(kernel_size).astype(np.float64)
    u, s, vt = np.linalg.svd(k2)
    keep = s > s[0] * 1e-7
    return tuple(
        (tuple(np.sqrt(s[i]) * u[:, i]), tuple(np.sqrt(s[i]) * vt[i]))
        for i in np.where(keep)[0])


def _fir_axis_zero(x: torch.Tensor, taps, axis: int) -> torch.Tensor:
    """1-D FIR with zero padding along axis -2 or -1 ('same' size)."""
    k = len(taps)
    p = k // 2
    n = x.shape[axis]
    xp = _pad_axis(x, axis, p, p, "constant")
    return sum(float(taps[i]) * _slice(xp, axis, i, i + n) for i in range(k))


def soft_erosion_planar(t: torch.Tensor, kernel_size: int = 15,
                        threshold: float = 0.6,
                        iterations: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """MegaFS-style soft erosion of (B, C, H, W) masks, channels independent
    (reference paste_back_tricks.py:17-44). Returns (soft mask, hard mask)."""

    def conv(v):
        out = None
        for col, row in _cone_svd_terms(kernel_size):
            part = _fir_axis_zero(_fir_axis_zero(v, col, -2), row, -1)
            out = part if out is None else out + part
        return out

    x = t
    for _ in range(iterations - 1):
        x = torch.minimum(x, conv(x))
    x = conv(x)
    hard = x >= threshold
    below_max = torch.where(hard, 0.0, x).amax(dim=(2, 3), keepdim=True)
    out = torch.where(hard, 1.0, x / torch.clamp(below_max, min=1e-8))
    return out, hard


_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))


def sobel_edge(img: torch.Tensor) -> torch.Tensor:
    """|Sobel_x| + |Sobel_y| edge magnitude of an RGB image in [0, 255],
    each clipped to 255, then weighted to grey (reference
    paste_back_tricks.py:157-171, before its blur and gain). img:
    (B, 3, H, W) -> (B, 1, H, W); reflect padding, cross-correlation."""
    c = img.shape[1]
    kx = torch.tensor(_SOBEL_X, device=img.device, dtype=img.dtype)
    k = torch.stack([kx, kx.t()])[:, None].repeat(c, 1, 1, 1)  # (2c, 1, 3, 3)
    edges = F.conv2d(F.pad(img, [1, 1, 1, 1], mode="reflect"), k, groups=c)
    edges = torch.clamp(edges.abs(), 0, 255).unflatten(1, (c, 2)).sum(2)
    gray = torch.tensor((0.299, 0.587, 0.114), device=img.device, dtype=img.dtype)
    return (edges * gray.view(1, -1, 1, 1)).sum(1, keepdim=True)


def blend_with_mask(bottom: torch.Tensor, up: torch.Tensor, up_mask: torch.Tensor,
                    up_ratio: float = 1.0) -> torch.Tensor:
    """bottom * (1 - m) + up * m with m = up_mask * up_ratio, NaNs in the
    mask zeroed (reference paste_back_tricks.py:131-148)."""
    m = torch.nan_to_num(up_mask, nan=0.0) * up_ratio
    return bottom * (1.0 - m) + up * m
