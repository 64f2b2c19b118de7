"""GCFSR-256 face inpainting, plain: a frozen copy of the net of
`e4s2024_torch/models/gcfsr.py` (basicsr FaceInpaintingArch) and its
inpaint glue (reference face_inpainting.py:20-50); K1 and K2 in their plain
forms."""

from __future__ import annotations

import math

import torch
from torch import nn

from .plain_kernels import make_kernel, upsample_2x
from .resize import resize_bilinear
from .stylegan2 import BLUR_TAPS, ConvLayer, EqualLinear, FusedLeakyReLU, ModulatedConv2d


def gcfsr_channels(channel_multiplier: int = 2, narrow: float = 1.0) -> dict[int, int]:
    return {
        4: int(512 * narrow), 8: int(512 * narrow), 16: int(512 * narrow),
        32: int(512 * narrow),
        64: int(256 * channel_multiplier * narrow),
        128: int(128 * channel_multiplier * narrow),
        256: int(64 * channel_multiplier * narrow),
        512: int(32 * channel_multiplier * narrow),
        1024: int(16 * channel_multiplier * narrow),
    }


class GCFSRStyleConv(nn.Module):
    """StyleConv (gcfsr_arch.py:289): modulated conv, noise if given,
    bias + LeakyReLU (K1)."""

    def __init__(self, in_channel: int, out_channel: int, style_dim: int = 512,
                 upsample: bool = False):
        super().__init__()
        self.modulated_conv = ModulatedConv2d(in_channel, out_channel, 3, style_dim,
                                              upsample=upsample)
        self.weight = nn.Parameter(torch.zeros(1))
        self.activate = FusedLeakyReLU(out_channel)

    def init_rules(self):
        return {"weight": ("const", 0.0)}

    def _conv(self, x, style, noise):
        out = self.modulated_conv(x, style)
        return out if noise is None else out + self.weight * noise

    def forward(self, x, style, noise=None):
        return self.activate(self._conv(x, style, noise))


class GCFSRStyleConvNSS(GCFSRStyleConv):
    """StyleConv_norm_scale_shift (gcfsr_arch.py:708): conv and noise, then
    out * scale1_n + shift * scale2_n with the scale pair L2-normalised, then
    bias + LeakyReLU."""

    def forward(self, x, style, scale1, scale2, shift, noise=None):
        out = self._conv(x, style, noise)
        norm = torch.rsqrt(scale1 * scale1 + scale2 * scale2 + 1e-8)
        out = out * (scale1 * norm)[:, :, None, None] + shift * (scale2 * norm)[:, :, None, None]
        return self.activate(out)


class GCFSRToRGB(nn.Module):
    """ToRGB (gcfsr_arch.py; basicsr names `modulated_conv`, `bias`): a 1x1
    modulated conv plus the skip, FIR-upsampled (K2) unless `upsample` is
    off."""

    def __init__(self, in_channel: int, style_dim: int = 512, upsample: bool = True):
        super().__init__()
        self.modulated_conv = ModulatedConv2d(in_channel, 3, 1, style_dim, demodulate=False)
        self.bias = nn.Parameter(torch.zeros(1, 3, 1, 1))
        self.upsample = upsample
        self.upsample_kernel = make_kernel(BLUR_TAPS)

    def init_rules(self):
        return {"bias": ("const", 0.0)}

    def forward(self, x, style, skip=None):
        out = self.modulated_conv(x, style) + self.bias
        if skip is not None:
            out = out + (upsample_2x(skip.contiguous(), self.upsample_kernel)
                         if self.upsample else skip)
        return out


class FaceInpainting(nn.Module):
    """FaceInpaintingArch: (B, 4, S, S) masked image and mask channel in
    [0, 1], `in_size` (B, 1) the hole's area fraction -> (image
    (B, 3, S, S), latent (B, n, 512))."""

    def __init__(self, out_size: int = 256, num_style_feat: int = 512,
                 channel_multiplier: int = 2, narrow: float = 1.0):
        super().__init__()
        ch = gcfsr_channels(channel_multiplier, narrow)
        self.log_size = log_size = int(math.log2(out_size))
        self.num_latent = (log_size - 2) * 2 - 2
        self.num_layers = (log_size - 4) * 2 + 1
        self.num_style_feat = num_style_feat
        n_cond = log_size - 2
        self.conv_body_first = ConvLayer(4, ch[out_size], 3)
        cond_ch = [ch[out_size]]
        downs, in_ch = [], ch[out_size]
        for i in range(log_size - 1, 3, -1):  # down to 16^2
            downs.append(ConvLayer(in_ch, ch[2 ** i], 3, downsample=True))
            in_ch = ch[2 ** i]
            if len(cond_ch) < n_cond:
                cond_ch.append(in_ch)
        self.conv_body_down = nn.ModuleList(downs)
        self.condition_scale1 = nn.ModuleList(
            [EqualLinear(1, c, bias_init=1.0) for c in cond_ch])
        self.condition_scale2 = nn.ModuleList(
            [EqualLinear(1, c, bias_init=1.0) for c in cond_ch])
        self.condition_shift = nn.ModuleList(
            [ConvLayer(c, c, 3, activate=False) for c in cond_ch])
        self.final_down1 = ConvLayer(in_ch, ch[8], 3, downsample=True)
        self.final_down2 = ConvLayer(ch[8], ch[4] // 2, 3, downsample=True)
        self.final_linear = EqualLinear(ch[4] // 2 * 16, num_style_feat * self.num_latent,
                                        activation="fused_lrelu")
        self.final_conv = ConvLayer(in_ch, ch[16], 3)
        self.style_conv1 = GCFSRStyleConvNSS(ch[16], ch[16], num_style_feat)
        self.to_rgb1 = GCFSRToRGB(ch[16], num_style_feat, upsample=False)
        convs, rgbs, in_ch = [], [], ch[16]
        for p in range(log_size - 4):
            out_ch = ch[2 ** (p + 5)]
            convs.append(GCFSRStyleConv(in_ch, out_ch, num_style_feat, upsample=True))
            convs.append(GCFSRStyleConvNSS(out_ch, out_ch, num_style_feat))
            rgbs.append(GCFSRToRGB(out_ch, num_style_feat))
            in_ch = out_ch
        self.style_convs = nn.ModuleList(convs)
        self.to_rgbs = nn.ModuleList(rgbs)

    def forward(self, x, in_size, noise=None):
        if noise is None:
            noise = [None] * self.num_layers
        feat = self.conv_body_first(x)
        conds = []

        def cond(j, f):
            conds.append((self.condition_scale1[j](in_size), self.condition_scale2[j](in_size),
                          self.condition_shift[j](f)))

        cond(0, feat)
        for down in self.conv_body_down:
            feat = down(feat)
            if len(conds) < len(self.condition_shift):
                cond(len(conds), feat)
        conds = conds[::-1]

        b = feat.shape[0]
        tmp = self.final_down2(self.final_down1(feat))
        latent = self.final_linear(tmp.flatten(1)).reshape(b, self.num_latent,
                                                           self.num_style_feat)
        out = self.final_conv(feat)
        out = self.style_conv1(out, latent[:, 0], *conds[0], noise[0])
        skip = self.to_rgb1(out, latent[:, 1])
        i = 1
        for p, to_rgb in enumerate(self.to_rgbs):
            out = self.style_convs[2 * p](out, latent[:, i], noise[2 * p + 1])
            out = self.style_convs[2 * p + 1](out, latent[:, i + 1], *conds[p + 1],
                                              noise[2 * p + 2])
            skip = to_rgb(out, latent[:, i + 2], skip=skip)
            i += 2
        return skip, latent


def inpaint(net: FaceInpainting, img255, hole_mask, size: int = 256) -> torch.Tensor:
    """img255: (B, H, W, 3) in [0, 255]; hole_mask: (B, Hm, Wm) bool or
    float. Returns (B, H, W, 3) float32 in [0, 255]."""
    with torch.no_grad():
        img = img255.float().permute(0, 3, 1, 2)
        img = img / 255.0
        h, s = img.shape[2], size
        hole = hole_mask.float()[:, None]
        mask = (resize_bilinear(hole, (s, s)) > 0).float()
        x = torch.cat([resize_bilinear(img, (s, s)) * (1.0 - mask), mask], 1)
        cond = mask.mean(dim=(1, 2, 3))[:, None]
        out = torch.clamp(net(x, cond)[0], 0.0, 1.0)
        if h != s:
            out = resize_bilinear(out, (h, h))
        if hole.shape[2] != h:
            hole = (resize_bilinear(hole, (h, h)) > 0).float()
        return ((img * (1.0 - hole) + out * hole) * 255.0).permute(0, 2, 3, 1)
