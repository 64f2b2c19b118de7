"""Modulated deformable convolution (DCNv2) in plain PyTorch.

Counterpart of `e4s2024_tpu/ops/deform_conv.py` (the reference's
swap_face_fine/archs/arch_util.py:209 `DCNv2Pack` over basicsr's
`modulated_deform_conv` CUDA op, ops/dcn/deform_conv.py:149). The reference
defines DCNv2Pack but never instantiates it in its pipelines; it is here for
completeness and for EDVR / BasicVSR-style alignment heads. The JAX package
runs no Pallas kernel here, and neither does the port: a deformable conv is
a bilinear gather of every kernel tap (zero padding outside the frame),
modulated by its mask, then one im2col product with the weight.

Offset layout: the JAX package's structured `offset[..., g, k, (dy, dx)]`
and `mask[..., g, k]`, built from the offset conv's chunks o1 (dy) and o2
(dx). basicsr's op reads the same conv's output interleaved (channel
2 (g K + k) + {0, 1}), so a basicsr checkpoint's `conv_offset` needs its
output channels permuted first (ROADMAP.md).
"""

from __future__ import annotations

import torch
from torch import nn


def _bilinear_gather(x: torch.Tensor, pos_y: torch.Tensor, pos_x: torch.Tensor) -> torch.Tensor:
    """x (N, C, H, W) sampled at float positions (N, P): (N, C, P), zero
    outside the frame (basicsr's `dmcn_im2col_bilinear` border)."""
    n, c, h, w = x.shape
    y0, x0 = torch.floor(pos_y), torch.floor(pos_x)
    wy1, wx1 = pos_y - y0, pos_x - x0
    xf = x.reshape(n, c, h * w)
    out = 0.0
    for dy, wy in ((0, 1.0 - wy1), (1, wy1)):
        for dx, wx in ((0, 1.0 - wx1), (1, wx1)):
            yi, xi = y0 + dy, x0 + dx
            valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
            taps = torch.gather(xf, 2, idx[:, None].expand(n, c, idx.shape[1]))
            out = out + taps * (wy * wx * valid)[:, None]
    return out


def modulated_deform_conv2d(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                            weight: torch.Tensor, bias: torch.Tensor | None = None,
                            stride: int = 1, padding: int = 0,
                            dilation: int = 1) -> torch.Tensor:
    """DCNv2 on NCHW input.

    x: (B, Cin, H, W); offset: (B, Ho, Wo, G, K, 2) per-tap (dy, dx) in
    pixels, G deformable groups, K = kh * kw taps in row-major order; mask:
    (B, Ho, Wo, G, K), already sigmoided; weight: (Cout, Cin, kh, kw);
    bias: (Cout,) or None. Returns (B, Cout, Ho, Wo)."""
    b, cin, h, w = x.shape
    cout, wc, kh, kw = weight.shape
    if wc != cin:
        raise ValueError(f"weight Cin {wc} != input Cin {cin}")
    _, ho, wo, g, k, _ = offset.shape
    if k != kh * kw:
        raise ValueError(f"offset taps {k} != kh*kw {kh * kw}")
    if cin % g:
        raise ValueError(f"Cin {cin} not divisible by deformable_groups {g}")
    cg = cin // g
    dev = x.device
    ky, kx = torch.meshgrid(torch.arange(kh, device=dev) * dilation,
                            torch.arange(kw, device=dev) * dilation, indexing="ij")
    base_y = (torch.arange(ho, device=dev) * stride - padding)[:, None, None] + ky.reshape(-1)
    base_x = (torch.arange(wo, device=dev) * stride - padding)[None, :, None] + kx.reshape(-1)
    pos_y = base_y[None, :, :, None, :] + offset[..., 0]      # (B, Ho, Wo, G, K)
    pos_x = base_x[None, :, :, None, :] + offset[..., 1]
    # groups folded into the batch: each samples its own channel slice
    py = pos_y.permute(0, 3, 1, 2, 4).reshape(b * g, ho * wo * k)
    px = pos_x.permute(0, 3, 1, 2, 4).reshape(b * g, ho * wo * k)
    sampled = _bilinear_gather(x.reshape(b * g, cg, h, w), py, px)
    sampled = sampled.view(b, g, cg, ho, wo, k) * mask.permute(0, 3, 1, 2, 4)[:, :, None]
    out = torch.einsum("bgchwk,ogck->bohw", sampled, weight.reshape(cout, g, cg, k))
    if bias is not None:
        out = out + bias.view(1, -1, 1, 1)
    return out


class DCNv2Pack(nn.Module):
    """Deformable-alignment conv (reference arch_util.py:209-236): a plain conv
    over `feat` predicts 3 G K channels, chunked into (dy, dx, mask logits);
    mask = sigmoid. `conv_offset` starts at zero (basicsr's `init_offset`),
    so at initialisation the layer is half a plain conv."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, dilation: int = 1,
                 deformable_groups: int = 1):
        super().__init__()
        k = kernel_size * kernel_size
        self.conv_offset = nn.Conv2d(in_channels, 3 * deformable_groups * k, kernel_size,
                                     stride, padding)
        nn.init.zeros_(self.conv_offset.weight)
        nn.init.zeros_(self.conv_offset.bias)
        bound = 1 / (in_channels * k) ** 0.5
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size, kernel_size).uniform_(-bound,
                                                                                        bound))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.groups, self.taps = deformable_groups, k

    def forward(self, x, feat):
        raw = self.conv_offset(feat)
        b, _, ho, wo = raw.shape
        o1, o2, m = torch.chunk(raw, 3, dim=1)

        def split(t):  # (B, G K, Ho, Wo) -> (B, Ho, Wo, G, K)
            return t.permute(0, 2, 3, 1).reshape(b, ho, wo, self.groups, self.taps)

        offset = torch.stack([split(o1), split(o2)], dim=-1)
        return modulated_deform_conv2d(x, offset, torch.sigmoid(split(m)), self.weight,
                                       self.bias, self.stride, self.padding, self.dilation)
