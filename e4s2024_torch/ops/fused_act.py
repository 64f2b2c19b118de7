"""Fused bias-add + LeakyReLU + sqrt(2) gain, over kernel K1.

Counterpart of `e4s2024_tpu/ops/fused_act.py`; the kernel replaces
`e4s2024_tpu/ops/pallas/kernels.py::fused_leaky_relu_tpu` and lives in
`kernels/csrc/fused_act.cu`. Layout: channels on axis 1 (NCHW or (N, C)).
"""

from __future__ import annotations

import math

import torch

from e4s2024_torch import kernels
from e4s2024_torch.kernels.build import library

SQRT2 = math.sqrt(2.0)


def fused_leaky_relu_plain(x: torch.Tensor, bias: torch.Tensor | None = None,
                           negative_slope: float = 0.2,
                           scale: float = SQRT2) -> torch.Tensor:
    """`leaky_relu(x + bias) * scale`, bias broadcast over axis 1."""
    if bias is not None:
        x = x + bias.to(x.dtype).view(1, -1, *([1] * (x.ndim - 2)))
    return torch.where(x >= 0, x, x * negative_slope) * scale


def fused_leaky_relu_backward_plain(grad: torch.Tensor, out: torch.Tensor,
                                    negative_slope: float = 0.2,
                                    scale: float = SQRT2) -> torch.Tensor:
    """The input gradient of `fused_leaky_relu` from its output:
    `grad * scale` where out >= 0 (the sign of x + bias), else
    `grad * negative_slope * scale`."""
    return torch.where(out >= 0, grad * scale, grad * (negative_slope * scale))


def _launch_forward(x: torch.Tensor, bias: torch.Tensor | None,
                    negative_slope: float, scale: float) -> torch.Tensor:
    """One launch of kernel K1 (inputs checked by the caller)."""
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    status = library().e4s_fused_leaky_relu(
        x.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(),
        kernels.DTYPE_CODES[x.dtype], x.shape[0] * x.shape[1], x.shape[1],
        math.prod(x.shape[2:]), negative_slope, scale, x.device.index,
        kernels.stream_of(x))
    kernels.check_status("fused_leaky_relu", status)
    fused_leaky_relu.launches += 1
    return out


def _launch_backward(counter, grad: torch.Tensor, out: torch.Tensor,
                     negative_slope: float, scale: float) -> torch.Tensor:
    """One launch of K1's backward kernel (`kernels/csrc/fused_act.cu`):
    `grad` scaled by the slope that the sign of `out` selects. Counted on
    `counter`. Both may require grad: under `create_graph` the incoming
    gradient does, and so does the saved output."""
    name = counter.__name__
    if grad.shape != out.shape:
        raise ValueError(f"{name}: grad {tuple(grad.shape)} and out {tuple(out.shape)} differ")
    kernels.check_input(name, "out", out, differentiable=True)
    kernels.check_input(name, "grad", grad, dtype=out.dtype, differentiable=True)
    grad_x = torch.empty_like(out)
    status = library().e4s_fused_leaky_relu_backward(
        grad.data_ptr(), out.data_ptr(), grad_x.data_ptr(), kernels.DTYPE_CODES[out.dtype],
        out.numel(), negative_slope, scale, out.device.index, kernels.stream_of(out))
    kernels.check_status(name, status)
    counter.launches += 1
    return grad_x


class _FusedLeakyReLUBackward(torch.autograd.Function):
    """K1's backward as a function of the incoming gradient: linear in
    `grad`, so its own gradient is the same kernel on the gradient of the
    gradient with the saved output's sign mask (counted as
    `fused_leaky_relu_double_backward`). Its derivative in `out` is zero
    almost everywhere (the slope is piecewise constant) and is returned as
    None. This is what makes R1's double backward run through K1."""

    @staticmethod
    def forward(ctx, grad, out, negative_slope, scale):
        ctx.save_for_backward(out)
        ctx.slope, ctx.scale = negative_slope, scale
        return _launch_backward(fused_leaky_relu_backward, grad, out, negative_slope, scale)

    @staticmethod
    def backward(ctx, grad_grad):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        (out,) = ctx.saved_tensors
        return (fused_leaky_relu_double_backward(grad_grad.contiguous(), out, ctx.slope,
                                                 ctx.scale), None, None, None)


@kernels.counted("fused_leaky_relu_backward")
def fused_leaky_relu_backward(grad: torch.Tensor, out: torch.Tensor,
                              negative_slope: float = 0.2,
                              scale: float = SQRT2) -> torch.Tensor:
    """K1's input gradient from its output: the plain version on the CPU,
    the backward kernel of `kernels/csrc/fused_act.cu` on a CUDA device
    (grad and out of one shape and dtype). Differentiable in `grad` on the
    card too: its gradient launches the same kernel again
    (`fused_leaky_relu_double_backward`)."""
    if kernels.use_plain(out):
        return fused_leaky_relu_backward_plain(grad, out, negative_slope, scale)
    return _FusedLeakyReLUBackward.apply(grad, out, negative_slope, scale)


@kernels.counted("fused_leaky_relu_double_backward")
def fused_leaky_relu_double_backward(grad_grad: torch.Tensor, out: torch.Tensor,
                                     negative_slope: float = 0.2,
                                     scale: float = SQRT2) -> torch.Tensor:
    """The gradient of `fused_leaky_relu_backward` in its `grad`: the
    backward kernel on `grad_grad` with `out`'s sign mask (the plain version
    on the CPU). Not differentiable itself on the card: a third derivative
    raises."""
    if kernels.use_plain(out):
        return fused_leaky_relu_backward_plain(grad_grad, out, negative_slope, scale)
    name = "fused_leaky_relu_double_backward"
    kernels.check_input(name, "grad_grad", grad_grad)
    return _launch_backward(fused_leaky_relu_double_backward, grad_grad, out.detach(),
                            negative_slope, scale)


class _FusedLeakyReLU(torch.autograd.Function):
    """K1 forward; backward through its backward kernel from the saved
    output (`fused_leaky_relu_backward`, itself differentiable), the bias
    gradient as that gradient summed over every axis but 1."""

    @staticmethod
    def forward(ctx, x, bias, negative_slope, scale):
        out = _launch_forward(x, bias, negative_slope, scale)
        ctx.save_for_backward(out)
        ctx.slope, ctx.scale = negative_slope, scale
        ctx.bias_dtype = None if bias is None else bias.dtype
        return out

    @staticmethod
    def backward(ctx, grad):
        (out,) = ctx.saved_tensors
        grad_x = fused_leaky_relu_backward(grad.contiguous(), out, ctx.slope, ctx.scale)
        grad_bias = None
        if ctx.needs_input_grad[1]:
            dims = [0, *range(2, grad_x.ndim)]
            grad_bias = grad_x.sum(dims, dtype=torch.float32).to(ctx.bias_dtype)
        return (grad_x if ctx.needs_input_grad[0] else None), grad_bias, None, None


@kernels.counted("fused_leaky_relu")
def fused_leaky_relu(x: torch.Tensor, bias: torch.Tensor | None = None,
                     negative_slope: float = 0.2,
                     scale: float = SQRT2) -> torch.Tensor:
    """`leaky_relu(x + bias) * scale`: the plain version on the CPU, kernel K1
    on a CUDA device (float32 or bfloat16 in, float32 arithmetic).
    Differentiable in x and bias at the first and second order: on the
    card the backward is K1's backward kernel, and so is the backward's own
    gradient (R1's double backward)."""
    if kernels.use_plain(x):
        return fused_leaky_relu_plain(x, bias, negative_slope, scale)
    name = "fused_leaky_relu"
    if x.ndim < 2:
        raise ValueError(f"{name}: x must have a channel axis, got {tuple(x.shape)}")
    kernels.check_input(name, "x", x, differentiable=True)
    if bias is not None:
        if bias.shape != (x.shape[1],):
            raise ValueError(f"{name}: bias must be ({x.shape[1]},), got {tuple(bias.shape)}")
        kernels.check_input(name, "bias", bias, differentiable=True)
    return _FusedLeakyReLU.apply(x, bias, negative_slope, scale)


def scaled_leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """LeakyReLU followed by sqrt(2) gain, no bias (reference model.py:172)."""
    return fused_leaky_relu(x, None, negative_slope)
