"""Mask-guided encoders of the RGI net: the pSp-style IR-SE encoder
(reference models/encoders/psp_encoders.py:319 `FSEncoder_PSP`,
helpers.py:56-144), the default, and the SEAN-style encoder
(psp_encoders.py:238 `FSEncoder_SEAN`), the reference's other
`fsencoder_type`.

Counterpart of `e4s2024_tpu/models/encoders.py` in NCHW, with the
reference's state-dict names (`input_layer.{0,2}`,
`body.{i}.res_layer.{1,2,3,5}`, `body.{i}.shortcut_layer.0`; SEAN's
`model.{1,4,7,10}`, `style_module.1`, `structure_module.{0,3,6}`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from e4s2024_torch.ops.resize import resize_nearest


class _InstanceNorm(torch.autograd.Function):
    """`F.instance_norm`'s forward with the backward of its formula,
    dx = (g - mean(g) - y mean(g y)) / sqrt(var + eps) over H, W: torch
    2.13's own backward on the CPU is wrong for a batch of one (it leaves
    the formula by the gradient's own size), which a trainer rank with one
    row hits."""

    @staticmethod
    def forward(ctx, x, eps):
        y = F.instance_norm(x, eps=eps)
        ctx.save_for_backward(y, torch.rsqrt(x.var(dim=(2, 3), unbiased=False, keepdim=True)
                                             + eps))
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        y, inv_std = ctx.saved_tensors
        g_mean = g.mean(dim=(2, 3), keepdim=True)
        gy_mean = (g * y).mean(dim=(2, 3), keepdim=True)
        return inv_std * (g - g_mean - y * gy_mean), None


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d(affine=False): each (sample, channel) over H, W."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _InstanceNorm.apply(x, eps)
    return F.instance_norm(x, eps=eps)


class InstanceNorm(nn.Module):
    def forward(self, x):
        return instance_norm(x)


class SEModule(nn.Module):
    """Squeeze-and-excitation (reference helpers.py:56)."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, channels // reduction, 1, bias=False)
        self.fc2 = nn.Conv2d(channels // reduction, channels, 1, bias=False)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.fc2(torch.relu(self.fc1(s)))
        return x * torch.sigmoid(s)


class BottleneckIRSE(nn.Module):
    """IR-SE residual unit with InstanceNorm (reference helpers.py:122
    `bottleneck_IR_SE_Ours`)."""

    def __init__(self, in_channel: int, depth: int, stride: int):
        super().__init__()
        if in_channel == depth:
            self.shortcut_layer = nn.MaxPool2d(1, stride)
        else:
            self.shortcut_layer = nn.Sequential(
                nn.Conv2d(in_channel, depth, 1, stride, bias=False), InstanceNorm())
        self.res_layer = nn.Sequential(
            InstanceNorm(),
            nn.Conv2d(in_channel, depth, 3, 1, 1, bias=False),
            nn.PReLU(depth),
            nn.Conv2d(depth, depth, 3, stride, 1, bias=False),
            InstanceNorm(),
            SEModule(depth, 16),
        )

    def forward(self, x):
        return self.res_layer(x) + self.shortcut_layer(x)


def rgi_body_plan(num_units: tuple = (3, 4, 14, 3)) -> list[tuple[int, int]]:
    """(depth, stride) per unit: 3x128 + 4x256 + 14x512 + 3x512 at full
    depth, stride 2 at each group's start (reference psp_encoders.py:323)."""
    plan: list[tuple[int, int]] = []
    for depth, num in zip((128, 256, 512, 512), num_units):
        plan.append((depth, 2))
        plan.extend((depth, 1) for _ in range(num - 1))
    return plan


def masked_average_pool(feats: torch.Tensor, segmap: torch.Tensor) -> torch.Tensor:
    """Per-region mean of feature vectors. feats: (B, C, H, W); segmap:
    (B, K, Hm, Wm) one-hot, resized nearest to (H, W). Returns (B, K, C);
    an empty region gives zeros (reference psp_encoders.py:368-373)."""
    seg = resize_nearest(segmap, feats.shape[-2:])
    seg = (seg > 0).to(feats.dtype)
    summed = torch.einsum("bchw,bkhw->bkc", feats, seg)
    area = seg.sum(dim=(2, 3))[..., None]
    return torch.where(area > 0, summed / torch.clamp(area, min=1.0),
                       torch.zeros((), dtype=feats.dtype, device=feats.device))


class FSEncoderPSP(nn.Module):
    """Per-region 1280-d style vectors from a 256x256 image and a one-hot map.

    Returns (style_vectors (B, K, 1280), structure_feats): the structure
    branch is disabled in the reference (psp_encoders.py:392), so the second
    output is zeros shaped like the last body features. `num_units` shrinks
    the body for small test configurations; the taps are the last unit of
    groups 2, 3 and 4 (units 6, 20 and 23 at full depth)."""

    def __init__(self, num_units: tuple = (3, 4, 14, 3)):
        super().__init__()
        n = tuple(num_units)
        self.taps = (n[0] + n[1] - 1, n[0] + n[1] + n[2] - 1, sum(n) - 1)
        self.input_layer = nn.Sequential(
            nn.Conv2d(3, 64, 3, 1, 1, bias=False), InstanceNorm(), nn.PReLU(64))
        units, in_ch = [], 64
        for depth, stride in rgi_body_plan(n):
            units.append(BottleneckIRSE(in_ch, depth, stride))
            in_ch = depth
        self.body = nn.Sequential(*units)

    def forward(self, x, segmap):
        x = self.input_layer(x)
        codes = []
        for i, unit in enumerate(self.body):
            x = unit(x)
            if i in self.taps:
                codes.append(masked_average_pool(x, segmap))
        return torch.cat(codes, dim=-1), torch.zeros_like(x)


def _in_lrelu() -> list[nn.Module]:
    return [InstanceNorm(), nn.LeakyReLU(0.2)]


class FSEncoderSEAN(nn.Module):
    """SEAN-style per-region encoder (reference psp_encoders.py:238-316, the
    in_size 256 flavour of networks.py:62): a reflect-padded conv to `ngf`
    channels, two stride-2 convs, one transposed-conv upsample (128^2
    features from a 256^2 input), each followed by InstanceNorm and
    LeakyReLU(0.2); a tanh style head masked-average-pooled per region,
    (B, K, 512); and a 3-conv structure branch to (B, 512, 16, 16)."""

    def __init__(self, ngf: int = 32, output_nc: int = 512):
        super().__init__()
        self.model = nn.Sequential(
            nn.ReflectionPad2d(1), nn.Conv2d(3, ngf, 3), *_in_lrelu(),
            nn.Conv2d(ngf, ngf * 2, 3, 2, 1), *_in_lrelu(),
            nn.Conv2d(ngf * 2, ngf * 4, 3, 2, 1), *_in_lrelu(),
            nn.ConvTranspose2d(ngf * 4, ngf * 8, 3, 2, 1, output_padding=1), *_in_lrelu())
        self.style_module = nn.Sequential(
            nn.ReflectionPad2d(1), nn.Conv2d(ngf * 8, output_nc, 3), nn.Tanh())
        self.structure_module = nn.Sequential(
            nn.Conv2d(ngf * 8, 512, 3, 2, 1), *_in_lrelu(),
            nn.Conv2d(512, 512, 3, 2, 1), *_in_lrelu(),
            nn.Conv2d(512, 512, 3, 2, 1), *_in_lrelu())

    def forward(self, x, segmap):
        h = self.model(x)
        return masked_average_pool(self.style_module(h), segmap), self.structure_module(h)
