"""Per-pixel regional scale, `x * (seg @ scales)`, over kernel K3.

The kernel (`kernels/csrc/regional_scale.cu`) replaces
`e4s2024_tpu/ops/pallas/kernels.py::modulate_demodulate_tpu`. In the JAX
package the same function is the einsum-and-multiply at
`e4s2024_tpu/ops/modconv.py:177-190`: the input modulation and output
demodulation of the fast regional mode, and the modulation of every masked
ToRGB layer, which takes the fast form in both regional modes.

Its input gradient, grad * (seg @ scales), is K3 itself on (grad, seg,
scales), counted as `regional_scale_backward`; the scales' gradient is a
reduction over pixels (one batched matrix product, no TPU counterpart).
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from e4s2024_torch import kernels
from e4s2024_torch.kernels.build import library


def regional_scale_plain(x: torch.Tensor, seg: torch.Tensor,
                         scales: torch.Tensor) -> torch.Tensor:
    """out[b, c, h, w] = x[b, c, h, w] * sum_k seg[b, k, h, w] * scales[b, k, c].

    x: (B, C, H, W); seg: (B, K, H, W); scales: (B, K, C)."""
    return x * torch.einsum("bkhw,bkc->bchw", seg, scales)


def _launch(counter, x: torch.Tensor, seg: torch.Tensor,
            scales: torch.Tensor) -> torch.Tensor:
    """One launch of kernel K3 (inputs checked by the caller), counted on
    `counter`."""
    b, c, h, w = x.shape
    out = torch.empty_like(x)
    status = library().e4s_regional_scale(
        x.data_ptr(), seg.data_ptr(), scales.data_ptr(), out.data_ptr(),
        kernels.DTYPE_CODES[x.dtype], b, c, seg.shape[1], h * w, x.device.index,
        kernels.stream_of(x))
    kernels.check_status(counter.__name__, status)
    counter.launches += 1
    return out


def _check(name: str, x, seg, scales, grad: bool) -> None:
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
    # seg is a one-hot map: no gradient flows into it
    for arg, t in (("x", x), ("seg", seg), ("scales", scales)):
        kernels.check_input(name, arg, t, dtype=x.dtype, differentiable=grad and arg != "seg")


def regional_scale_grad_scales(grad: torch.Tensor, x: torch.Tensor,
                               seg: torch.Tensor) -> torch.Tensor:
    """grad_scales[b, k, c] = sum over pixels of seg[b, k] * grad[b, c] * x[b, c]:
    one batched matrix product, accumulated in float32."""
    b, c = x.shape[:2]
    gx = (grad.float() * x.float()).reshape(b, c, -1)
    return torch.bmm(seg.float().reshape(b, seg.shape[1], -1), gx.transpose(1, 2))


@kernels.counted("regional_scale_backward")
def regional_scale_backward(grad: torch.Tensor, seg: torch.Tensor,
                            scales: torch.Tensor) -> torch.Tensor:
    """The input gradient of `regional_scale`, grad * (seg @ scales) per
    pixel: the plain version on the CPU, kernel K3 itself on a CUDA device."""
    if kernels.use_plain(grad):
        return regional_scale_plain(grad, seg, scales)
    _check("regional_scale_backward", grad, seg, scales, grad=False)
    return _launch(regional_scale_backward, grad, seg, scales)


class _RegionalScale(torch.autograd.Function):
    """K3 forward; grad_x through K3 again (`regional_scale_backward`),
    grad_scales by `regional_scale_grad_scales`."""

    @staticmethod
    def forward(ctx, x, seg, scales):
        ctx.save_for_backward(x, seg, scales)
        return _launch(regional_scale, x, seg, scales)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        x, seg, scales = ctx.saved_tensors
        grad = grad.contiguous()
        grad_x = grad_scales = None
        if ctx.needs_input_grad[0]:
            grad_x = regional_scale_backward(grad, seg, scales)
        if ctx.needs_input_grad[2]:
            grad_scales = regional_scale_grad_scales(grad, x, seg).to(scales.dtype)
        return grad_x, None, grad_scales


@kernels.counted("regional_scale")
def regional_scale(x: torch.Tensor, seg: torch.Tensor,
                   scales: torch.Tensor) -> torch.Tensor:
    """`x * (seg @ scales)` per pixel: the plain version on the CPU, kernel K3
    on a CUDA device (all three float32, or all three bfloat16; K <= 16).
    Differentiable in x and scales (seg, a one-hot map, may not require
    grad): on the card grad_x is K3 again and grad_scales one batched
    matrix product."""
    if kernels.use_plain(x):
        return regional_scale_plain(x, seg, scales)
    _check("regional_scale", x, seg, scales, grad=True)
    return _RegionalScale.apply(x, seg, scales)
