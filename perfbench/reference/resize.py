"""Image resizing with PyTorch `F.interpolate` semantics, as the JAX package
computes it (`e4s2024_tpu/ops/resize.py`).

Layout: any (..., H, W) tensor, so the JAX package's NHWC and planar forms
both map onto these functions.

A frozen copy of `e4s2024_torch/ops/resize.py` for the benchmark's plain
reference: no kernel, no split, no process group; it imports nothing of
the port.
"""

from __future__ import annotations

import functools

import numpy as np
import torch



def resize_nearest(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Nearest neighbour with torch's floor rule: src = floor(dst * in / out),
    in integer arithmetic. Integer ratios become strided views or repeats."""
    h, w = x.shape[-2:]
    th, tw = size
    if (h, w) == (th, tw):
        return x
    if h % th == 0 and w % tw == 0:
        return x[..., :: h // th, :: w // tw]
    if th % h == 0 and tw % w == 0:
        return x.repeat_interleave(th // h, dim=-2).repeat_interleave(tw // w, dim=-1)
    ih = torch.arange(th, device=x.device) * h // th
    iw = torch.arange(tw, device=x.device) * w // tw
    return x[..., ih, :][..., iw]


@functools.lru_cache(maxsize=None)
def _interp_matrix_np(out_size: int, in_size: int, align_corners: bool) -> np.ndarray:
    """(out, in) bilinear interpolation matrix, two non-zeros per row."""
    if align_corners:
        if out_size == 1:
            src = np.zeros((1,))
        else:
            src = np.arange(out_size) * ((in_size - 1) / (out_size - 1))
    else:
        src = (np.arange(out_size) + 0.5) * (in_size / out_size) - 0.5
        src = np.clip(src, 0.0, in_size - 1)
    i0 = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    t = (src - i0).astype(np.float32)
    m = np.zeros((out_size, in_size), np.float32)
    np.add.at(m, (np.arange(out_size), i0), 1.0 - t)
    np.add.at(m, (np.arange(out_size), i1), t)
    return m


@functools.lru_cache(maxsize=64)
def _interp_matrix(out_size: int, in_size: int, align_corners: bool,
                   device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_interp_matrix_np(out_size, in_size, align_corners)).to(device)


def resize_bilinear(x: torch.Tensor, size: tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """torch `F.interpolate(mode="bilinear")` on (..., H, W), computed in
    float32 as two products with the interpolation matrices (the JAX
    package's `resize_bilinear`, `resize_bilinear_align_corners` and
    `resize_bilinear_planar`)."""
    h, w = x.shape[-2:]
    th, tw = size
    if (h, w) == (th, tw):
        return x
    mh = _interp_matrix(th, h, align_corners, x.device)
    mw = _interp_matrix(tw, w, align_corners, x.device)
    out = torch.matmul(mh, x.float())
    out = torch.matmul(out, mw.t())
    return out.to(x.dtype)
