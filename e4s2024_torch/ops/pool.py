"""Pooling with torch semantics (`e4s2024_tpu/ops/pool.py`): max, average,
adaptive average and global average.

Under a height split (`parallel.spatial`) `max_pool2d` without padding
fetches its windows' rows, and `adaptive_avg_pool2d` takes whole bins of
its own rows where the output's rows divide the input's (an integer
ratio); other ratios raise there (their bins straddle the slabs)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from e4s2024_torch.parallel import spatial


def max_pool2d(x: torch.Tensor, window: int = 2, stride: int | None = None,
               padding: int = 0) -> torch.Tensor:
    """MaxPool2d(window, stride, padding) on NCHW, floor mode; padded
    samples never win (they count as -inf)."""
    if spatial.active() is not None:
        if padding:
            raise NotImplementedError("a split max pool takes no padding")
        return spatial.max_pool2d(x, window, stride or window)
    return F.max_pool2d(x, window, stride or window, padding)


def avg_pool2d(x: torch.Tensor, window: int = 2, stride: int | None = None) -> torch.Tensor:
    """torch F.avg_pool2d(window, stride) on NCHW, no padding (the JAX
    package's `avg_pool2d`)."""
    return F.avg_pool2d(x, window, stride or window)


def adaptive_avg_pool2d(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """torch AdaptiveAvgPool2d on NCHW: output bin i averages input rows
    [floor(i * H / out), ceil((i + 1) * H / out)), the bins the JAX
    package's `adaptive_avg_pool2d` builds as matrices. Under a height
    split `out_hw` is the output slab's size."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    if spatial.active() is not None and x.shape[-2] % out_hw[0]:
        raise NotImplementedError(f"a split adaptive pool needs an integer ratio of rows, "
                                  f"{x.shape[-2]} to {out_hw[0]}")
    return F.adaptive_avg_pool2d(x, out_hw)


def global_avg_pool(x: torch.Tensor, keepdims: bool = True) -> torch.Tensor:
    """Mean over the spatial axes of an NCHW tensor."""
    return x.mean(dim=(2, 3), keepdim=keepdims)
