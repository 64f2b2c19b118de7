"""GPEN-512 face restoration, plain: a frozen copy of the nets and the
aligned-crop glue of `e4s2024_torch/models/gpen.py` (reference
gpen_model.py:380 `Generator`, :637 `FullGenerator`). A StyleGAN2 decoder
whose "noise" inputs are the encoder's features, concatenated onto each
styled conv's output; K1 and K2 in their plain forms."""

from __future__ import annotations

import math

import torch
from torch import nn

from .resize import resize_bilinear
from .stylegan2 import (ConstantInput, ConvLayer, EqualLinear, FusedLeakyReLU,
                        ModulatedConv2d, NoiseInjection, PixelNorm, ToRGB)


def gpen_channels(channel_multiplier: int = 2, narrow: float = 1.0) -> dict[int, int]:
    return {
        4: int(512 * narrow), 8: int(512 * narrow), 16: int(512 * narrow),
        32: int(512 * narrow),
        64: int(256 * channel_multiplier * narrow),
        128: int(128 * channel_multiplier * narrow),
        256: int(64 * channel_multiplier * narrow),
        512: int(32 * channel_multiplier * narrow),
        1024: int(16 * channel_multiplier * narrow),
        2048: int(8 * channel_multiplier * narrow),
    }


class GPENStyledConv(nn.Module):
    """Modulated conv, the noise input concatenated onto its output, then
    bias + LeakyReLU over both halves (gpen_model.py:318-356)."""

    def __init__(self, in_channel: int, out_channel: int, style_dim: int = 512,
                 upsample: bool = False):
        super().__init__()
        self.conv = ModulatedConv2d(in_channel, out_channel, 3, style_dim, upsample=upsample)
        self.noise = NoiseInjection()
        self.activate = FusedLeakyReLU(2 * out_channel)

    def forward(self, x, style, noise):
        out = self.conv(x, style)
        return self.activate(torch.cat([out, self.noise.weight * noise], dim=1))


class GPENGenerator(nn.Module):
    """The concat-noise StyleGAN2 decoder (gpen_model.py:380-556)."""

    def __init__(self, size: int = 512, style_dim: int = 512, n_mlp: int = 8,
                 channel_multiplier: int = 2, narrow: float = 1.0, lr_mlp: float = 0.01):
        super().__init__()
        self.log_size = int(math.log2(size))
        self.n_latent = self.log_size * 2 - 2
        ch = gpen_channels(channel_multiplier, narrow)
        self.style = nn.Sequential(PixelNorm(), *[
            EqualLinear(style_dim, style_dim, lr_mul=lr_mlp, activation="fused_lrelu")
            for _ in range(n_mlp)])
        self.input = ConstantInput(ch[4])
        self.conv1 = GPENStyledConv(ch[4], ch[4], style_dim)
        self.to_rgb1 = ToRGB(2 * ch[4], style_dim, upsample=False)
        self.convs = nn.ModuleList()
        self.to_rgbs = nn.ModuleList()
        in_ch = 2 * ch[4]
        for i in range(3, self.log_size + 1):
            out_ch = ch[2 ** i]
            self.convs.append(GPENStyledConv(in_ch, out_ch, style_dim, upsample=True))
            self.convs.append(GPENStyledConv(2 * out_ch, out_ch, style_dim))
            self.to_rgbs.append(ToRGB(2 * out_ch, style_dim))
            in_ch = 2 * out_ch

    def forward(self, w, noise, input_is_latent: bool = False):
        """w: (B, 512) code; noise: per-layer (B, C, res, res) encoder
        features. Unless `input_is_latent`, w goes through the style MLP first
        (the reference FullGenerator calls it so, gpen_model.py:689). Returns
        (image (B, 3, S, S), latent (B, n_latent, 512))."""
        if not input_is_latent:
            w = self.style(w)
        out = self.conv1(self.input(w.shape[0]), w, noise[0])
        skip = self.to_rgb1(out, w)
        for j, to_rgb in enumerate(self.to_rgbs):
            out = self.convs[2 * j](out, w, noise[2 * j + 1])
            out = self.convs[2 * j + 1](out, w, noise[2 * j + 2])
            skip = to_rgb(out, w, skip=skip)
        return skip, w[:, None].expand(-1, self.n_latent, -1)


class GPENFullGenerator(nn.Module):
    """Encoder (ConvLayers down to 4x4 and a style head) and the concat-noise
    decoder (gpen_model.py:637-692). (B, 3, S, S) in [-1, 1] in and out."""

    def __init__(self, size: int = 512, style_dim: int = 512, n_mlp: int = 8,
                 channel_multiplier: int = 2, narrow: float = 1.0):
        super().__init__()
        ch = gpen_channels(channel_multiplier, narrow)
        self.log_size = int(math.log2(size))
        self.ecd0 = nn.Sequential(ConvLayer(3, ch[size], 1))
        in_ch = ch[size]
        for i in range(self.log_size, 2, -1):
            out_ch = ch[2 ** (i - 1)]
            setattr(self, f"ecd{self.log_size - i + 1}",
                    nn.Sequential(ConvLayer(in_ch, out_ch, 3, downsample=True)))
            in_ch = out_ch
        self.final_linear = nn.Sequential(
            EqualLinear(ch[4] * 4 * 4, style_dim, activation="fused_lrelu"))
        self.generator = GPENGenerator(size, style_dim, n_mlp, channel_multiplier, narrow)

    def forward(self, x):
        feats = []
        out = x
        for i in range(self.log_size - 1):
            out = getattr(self, f"ecd{i}")(out)
            feats.append(out)
        w = self.final_linear(out.flatten(1))
        # each encoder feature feeds two layers, coarse to fine, the first
        # slot dropped (gpen_model.py:686-688)
        noise = [f for f in feats for _ in range(2)][::-1][1:]
        return self.generator(w, noise)


def restore_aligned(net, img255, size: int, device, *args) -> torch.Tensor:
    """The aligned-crop glue of the restoration nets (GPEN, CodeFormer,
    GFPGAN): (B, H, W, 3) in [0, 255] to [-1, 1], resized to the net's
    `size` and back with `ops/resize.py` where H differs, the net's image
    output (`net(x, *args)[0]`) clipped to [0, 255]; float32 NHWC out."""
    with torch.no_grad():
        x = torch.as_tensor(img255).to(device, torch.float32)
        h = x.shape[1]
        x = x.permute(0, 3, 1, 2) / 127.5 - 1.0
        if h != size:
            x = resize_bilinear(x, (size, size))
        out = torch.clamp((net(x.contiguous(), *args)[0] + 1.0) * 127.5, 0, 255)
        if h != size:
            out = resize_bilinear(out, (h, h))
        return out.permute(0, 2, 3, 1)
