"""Image resizing with PyTorch `F.interpolate` semantics, as the JAX package
computes it (`e4s2024_tpu/ops/resize.py`).

Layout: any (..., H, W) tensor, so the JAX package's NHWC and planar forms
both map onto these functions.

Under a height split (`parallel.spatial`) x is a slab of rows and `size`
the output slab's size: each rank takes its own rows of the row
interpolation (the source rows of its output rows, or its rows of the
interpolation matrix) and fetches the input rows they read from the
ranks that hold them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from e4s2024_torch.parallel import spatial


def resize_nearest(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Nearest neighbour with torch's floor rule: src = floor(dst * in / out),
    in integer arithmetic. Integer ratios become strided views or repeats."""
    h, w = x.shape[-2:]
    th, tw = size
    if (h, w) == (th, tw):
        return x
    if spatial.active() is not None:
        rows = _split_rows(x, th, lambda H, TH, r0, r1: (np.arange(r0, r1) * H // TH)[:, None])
        with spatial.suspended():
            return resize_nearest(rows, (th, tw))
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
    if spatial.active() is not None:
        out = _split_rows(x, th, lambda H, TH, r0, r1:
                          _interp_matrix_np(TH, H, align_corners)[r0:r1])
        if tw != w:
            out = torch.matmul(out, _interp_matrix(tw, w, align_corners, x.device).t())
        return out.to(x.dtype)
    mh = _interp_matrix(th, h, align_corners, x.device)
    mw = _interp_matrix(tw, w, align_corners, x.device)
    out = torch.matmul(mh, x.float())
    out = torch.matmul(out, mw.t())
    return out.to(x.dtype)


def _split_rows(x: torch.Tensor, th: int, rows_of) -> torch.Tensor:
    """A slab's rows resized to `th` (a slab of the split output), its
    columns as they were. `rows_of(H, TH, r0, r1)` gives output rows
    [r0, r1) of the global row resize as a matrix over the input rows (the
    product in float32), or as one column of source-row indices."""
    n = spatial.parts()
    height, out_rows = x.shape[-2] * n, th * n
    spans = []
    for s in range(n):
        rows = rows_of(height, out_rows, s * th, (s + 1) * th)
        if rows.shape[1] == 1:
            lo, hi = int(rows.min()), int(rows.max()) + 1
        else:
            used = np.nonzero(rows.any(axis=0))[0]
            lo, hi = int(used.min()), int(used.max()) + 1
        spans.append((lo, hi, rows))
    lo, hi, rows = spans[spatial.active().index]
    xw = spatial.fetch(x, [(a, b) for a, b, _ in spans], spatial.even_extents(x.shape[-2], n))
    if rows.shape[1] == 1:
        return xw[..., torch.from_numpy(rows[:, 0] - lo).to(x.device), :]
    m = torch.from_numpy(np.ascontiguousarray(rows[:, lo:hi])).to(x.device)
    return torch.matmul(m, xw.float())
