"""Per-pixel regional scale, `x * (seg @ scales)`, over kernel K3.

The kernel (`kernels/csrc/regional_scale.cu`) replaces
`e4s2024_tpu/ops/pallas/kernels.py::modulate_demodulate_tpu`. In the JAX
package the same function is the einsum-and-multiply at
`e4s2024_tpu/ops/modconv.py:177-190`: the input modulation and output
demodulation of the fast regional mode, and the modulation of every masked
ToRGB layer, which takes the fast form in both regional modes.
"""

from __future__ import annotations

import torch

from e4s2024_torch import kernels
from e4s2024_torch.kernels.build import library


def regional_scale_plain(x: torch.Tensor, seg: torch.Tensor,
                         scales: torch.Tensor) -> torch.Tensor:
    """out[b, c, h, w] = x[b, c, h, w] * sum_k seg[b, k, h, w] * scales[b, k, c].

    x: (B, C, H, W); seg: (B, K, H, W); scales: (B, K, C)."""
    return x * torch.einsum("bkhw,bkc->bchw", seg, scales)


@kernels.counted("regional_scale")
def regional_scale(x: torch.Tensor, seg: torch.Tensor,
                   scales: torch.Tensor) -> torch.Tensor:
    """`x * (seg @ scales)` per pixel: the plain version on the CPU, kernel K3
    on a CUDA device (all three float32, or all three bfloat16; K <= 16)."""
    if kernels.use_plain(x):
        return regional_scale_plain(x, seg, scales)
    name = "regional_scale"
    if x.ndim != 4 or seg.ndim != 4 or scales.ndim != 3:
        raise ValueError(f"{name}: expected x (B, C, H, W), seg (B, K, H, W), "
                         f"scales (B, K, C)")
    b, c, h, w = x.shape
    k = seg.shape[1]
    if seg.shape != (b, k, h, w) or scales.shape != (b, k, c):
        raise ValueError(f"{name}: shapes disagree: x {tuple(x.shape)}, "
                         f"seg {tuple(seg.shape)}, scales {tuple(scales.shape)}")
    if not 1 <= k <= 16:
        raise ValueError(f"{name}: at most 16 regions, got {k}")
    for arg, t in (("x", x), ("seg", seg), ("scales", scales)):
        kernels.check_input(name, arg, t, dtype=x.dtype)
    out = torch.empty_like(x)
    status = library().e4s_regional_scale(
        x.data_ptr(), seg.data_ptr(), scales.data_ptr(), out.data_ptr(),
        kernels.DTYPE_CODES[x.dtype], b, c, k, h * w, x.device.index,
        kernels.stream_of(x))
    kernels.check_status(name, status)
    regional_scale.launches += 1
    return out
