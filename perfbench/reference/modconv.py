"""Modulated convolution (StyleGAN2) and its regional, mask-conditioned form.

Counterpart of `e4s2024_tpu/ops/modconv.py`, in NCHW with OIHW weights.
Modulation scales input channels and demodulation scales output channels,
both constant over space, so

    conv(x, scale * W * s_b) * d_b == conv(x * s_b, scale * W) * d_b

and one shared-weight convolution serves the whole batch; the demodulation
coefficients are d[b, o] = rsqrt(sum_i s[b, i]^2 * Wsq[o, i] + eps).

Regional modes:
- "exact": the B * K component convolutions as one batched convolution,
  contracted with the one-hot map. Identical to the reference's loop.
- "fast": per-pixel modulation of the input and demodulation of the output
  (kernel K3, `ops/modulate.py`), 1/K of the work; identical to "exact" for
  1x1 kernels, different at region boundaries for 3x3.

The shared-weight convolutions are `F.conv2d` / `F.conv_transpose2d`; the
blur after the transposed convolution is upfirdn2d (kernel K2).

A frozen copy of `e4s2024_torch/ops/modconv.py` for the benchmark's plain
reference: no kernel, no split, no process group; it imports nothing of
the port.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .plain_kernels import blur as fir_blur
from .plain_kernels import regional_scale
from .resize import resize_nearest

_EPS = 1e-8


def _he_scale(weight: torch.Tensor) -> float:
    _, cin, kh, kw = weight.shape
    return 1.0 / math.sqrt(cin * kh * kw)


def _demod_coeff(weight: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
    """d[..., o] = rsqrt(sum_{i,k} (scale * W[o, i, k] * s[..., i])^2 + eps).

    weight: (Cout, Cin, kh, kw); style: (..., Cin) -> (..., Cout)."""
    wsq = ((_he_scale(weight) * weight) ** 2).sum(dim=(2, 3))  # (Cout, Cin)
    return torch.rsqrt(torch.matmul(style * style, wsq.t()) + _EPS)


def _up_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-2 transposed convolution, padding 0 (reference model.py:287)."""
    return F.conv_transpose2d(x, w.transpose(0, 1), stride=2)


def _up_blur(out: torch.Tensor, weight: torch.Tensor,
             blur_kernel: torch.Tensor) -> torch.Tensor:
    p = blur_kernel.shape[0] - 2 - (weight.shape[-1] - 1)
    return fir_blur(out.contiguous(), blur_kernel, pad=((p + 1) // 2 + 1, p // 2 + 1),
                    upsample_factor=2)


def _up_path(x: torch.Tensor, w: torch.Tensor, weight: torch.Tensor,
             blur_kernel: torch.Tensor, mid=None) -> torch.Tensor:
    """The transposed convolution, `mid` (the demodulation: per channel),
    then the blur."""
    t = _up_conv(x, w)
    return _up_blur(t if mid is None else mid(t), weight, blur_kernel)


def _mod_conv_core(x, weight, style, demodulate, up, down, blur_kernel):
    """Shared-weight modulated conv. x: (B, Cin, H, W); style: (B, Cin) or
    None (no modulation). Returns (B, Cout, H', W')."""
    k = weight.shape[-1]
    w = _he_scale(weight) * weight
    xm = x if style is None else x * style[:, :, None, None]

    def demod(out):
        if not demodulate:
            return out
        return out * _demod_coeff(weight, style)[:, :, None, None]

    if up:
        return _up_path(xm, w, weight, blur_kernel, demod)
    if down:
        p = blur_kernel.shape[0] - 2 + (k - 1)
        xm = fir_blur(xm.contiguous(), blur_kernel, pad=((p + 1) // 2, p // 2))
        return demod(F.conv2d(xm, w, stride=2))
    return demod(F.conv2d(xm, w, padding=k // 2))


def modulated_conv2d(x: torch.Tensor, weight: torch.Tensor, style: torch.Tensor,
                     *, demodulate: bool = True, up: bool = False,
                     down: bool = False,
                     blur_kernel: torch.Tensor | None = None) -> torch.Tensor:
    """StyleGAN2 modulated conv with one style per sample.

    x: (B, Cin, H, W); weight: (Cout, Cin, kh, kw) raw parameter; style:
    (B, Cin). up / down: 2x transposed-conv upsample / strided downsample with
    the FIR blur, as reference model.py:287-310."""
    return _mod_conv_core(x, weight, style, demodulate, up, down, blur_kernel)


def regional_modulated_conv2d(x: torch.Tensor, weight: torch.Tensor,
                              styles: torch.Tensor, segmap: torch.Tensor, *,
                              demodulate: bool = True, up: bool = False,
                              blur_kernel: torch.Tensor | None = None,
                              mode: str = "exact") -> torch.Tensor:
    """Mask-conditioned modulated conv, the reference's per-component loop
    (model.py:394-398): out = sum_k segmap_k * modulated_conv(x, styles[:, k]).

    x: (B, Cin, H, W); weight: (Cout, Cin, kh, kw); styles: (B, K, Cin);
    segmap: (B, K, Hm, Wm) one-hot, resized (nearest) to the conv's input and
    output sizes inside. Returns (B, Cout, H', W')."""
    if mode not in ("exact", "fast"):
        raise ValueError(f"regional mode must be 'exact' or 'fast', got {mode!r}")
    b, cin, h, w_ = x.shape
    cout, k_sz = weight.shape[0], weight.shape[-1]
    num_comp = styles.shape[1]
    h_out, w_out = (2 * h, 2 * w_) if up else (h, w_)
    seg_out = resize_nearest(segmap, (h_out, w_out)).to(x.dtype).contiguous()

    if mode == "fast":
        seg_in = resize_nearest(segmap, (h, w_)).to(x.dtype).contiguous()
        xs = regional_scale(x.contiguous(), seg_in, styles.contiguous())
        w = _he_scale(weight) * weight
        if up:
            out = _up_path(xs, w, weight, blur_kernel)
        else:
            out = F.conv2d(xs, w, padding=k_sz // 2)
        if demodulate:
            demod = _demod_coeff(weight, styles).contiguous()  # (B, K, Cout)
            out = regional_scale(out.contiguous(), seg_out, demod)
        return out

    xk = (x[:, None] * styles[:, :, :, None, None]).reshape(b * num_comp, cin, h, w_)
    out = _mod_conv_core(xk, weight, None, False, up, False, blur_kernel)
    if demodulate:
        demod = _demod_coeff(weight, styles).reshape(b * num_comp, cout)
        out = out * demod[:, :, None, None]
    out = out.reshape(b, num_comp, cout, h_out, w_out)
    return torch.einsum("bkchw,bkhw->bchw", out, seg_out)
