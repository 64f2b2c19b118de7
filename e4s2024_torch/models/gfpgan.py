"""GFPGAN v1.3/v1.4 ("clean" architecture) face restoration (reference
swap_face_fine/GFPGAN/gfpgan/archs/gfpganv1_clean_arch.py:153 and
stylegan2_clean_arch.py; the enhancer behind `face_restoration`,
Face_swap_with_two_imgs.py:610).

Counterpart of `e4s2024_tpu/models/gfpgan.py` in NCHW, with the
reference's state-dict names (`conv_body_first`, `conv_body_down.{i}`,
`final_conv`, `final_linear`, `conv_body_up.{i}`,
`condition_{scale,shift}.{i}.{0,2}`, `stylegan_decoder.*`). A U-Net encoder
gives per-resolution SFT (scale, shift) conditions, on half the channels
(sft_half), to a "clean" StyleGAN2 decoder with a W code per layer
(different_w). The clean decoder has no FIR ops and no fused activation:
its up- and down-sampling is bilinear, through `ops/resize.py::resize_bilinear`
(JAX's interpolation matrices), its weights are stored pre-scaled and its
activations are a plain LeakyReLU. So it runs no kernel of the port; the
JAX package runs no Pallas kernel here either.
"""

from __future__ import annotations

import math
import re
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from e4s2024_torch import resolve_device
from e4s2024_torch.convert import as_tensors, strip_module_prefix, unwrap_envelope
from e4s2024_torch.models.gpen import restore_aligned
from e4s2024_torch.ops.resize import resize_bilinear

# what a reference GFPGAN file holds that the restoration never reads: the
# decoder's style MLP (its inputs are W codes already), the auxiliary
# multi-scale RGB heads (training only) and the registered noise maps
_UNUSED = re.compile(r"^(stylegan_decoder\.style_mlp\.|toRGB\.|stylegan_decoder\.noises\.)")


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


def _resize2(x, factor: float):
    return resize_bilinear(x, (int(x.shape[2] * factor), int(x.shape[3] * factor)))


def gfpgan_channels(channel_multiplier: int = 2, narrow: float = 1.0) -> dict[int, int]:
    return {
        4: int(512 * narrow), 8: int(512 * narrow), 16: int(512 * narrow),
        32: int(512 * narrow),
        64: int(256 * channel_multiplier * narrow),
        128: int(128 * channel_multiplier * narrow),
        256: int(64 * channel_multiplier * narrow),
        512: int(32 * channel_multiplier * narrow),
        1024: int(16 * channel_multiplier * narrow),
    }


class CleanModulatedConv(nn.Module):
    """stylegan2_clean_arch.py:24: a pre-scaled (1, O, I, k, k) weight, a
    plain Linear modulation, bilinear resampling before the conv."""

    def __init__(self, cin: int, cout: int, k: int, style_dim: int = 512,
                 demodulate: bool = True, sample_mode: str | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(1, cout, cin, k, k) / math.sqrt(cin * k * k))
        self.modulation = nn.Linear(style_dim, cin)
        nn.init.ones_(self.modulation.bias)
        self.demodulate, self.sample_mode = demodulate, sample_mode

    def forward(self, x, style):
        s = self.modulation(style)
        if self.sample_mode == "upsample":
            x = _resize2(x, 2)
        elif self.sample_mode == "downsample":
            x = _resize2(x, 0.5)
        w = self.weight[0]
        out = F.conv2d(x * s[:, :, None, None], w, padding=w.shape[-1] // 2)
        if self.demodulate:
            wsq = (w * w).sum(dim=(2, 3))  # (Cout, Cin)
            out = out * torch.rsqrt(torch.matmul(s * s, wsq.t()) + 1e-8)[:, :, None, None]
        return out


class CleanStyleConv(nn.Module):
    def __init__(self, cin: int, cout: int, style_dim: int = 512,
                 sample_mode: str | None = None):
        super().__init__()
        self.modulated_conv = CleanModulatedConv(cin, cout, 3, style_dim,
                                                 sample_mode=sample_mode)
        self.weight = nn.Parameter(torch.zeros(1))  # noise weight
        self.bias = nn.Parameter(torch.zeros(1, cout, 1, 1))

    def forward(self, x, style, noise=None):
        out = self.modulated_conv(x, style) * math.sqrt(2.0)
        if noise is not None:
            out = out + self.weight * noise
        return _lrelu(out + self.bias)


class CleanToRGB(nn.Module):
    def __init__(self, cin: int, style_dim: int = 512, upsample: bool = True):
        super().__init__()
        self.modulated_conv = CleanModulatedConv(cin, 3, 1, style_dim, demodulate=False)
        self.bias = nn.Parameter(torch.zeros(1, 3, 1, 1))
        self.upsample = upsample

    def forward(self, x, style, skip=None):
        out = self.modulated_conv(x, style) + self.bias
        if skip is not None:
            out = out + (_resize2(skip, 2) if self.upsample else skip)
        return out


class GFPGANResBlock(nn.Module):
    """gfpganv1_clean_arch.py:120: bilinear down or up inside, a 1x1 skip."""

    def __init__(self, cin: int, cout: int, mode: str = "down"):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cin, 3, padding=1)
        self.conv2 = nn.Conv2d(cin, cout, 3, padding=1)
        self.skip = nn.Conv2d(cin, cout, 1, bias=False)
        self.factor = 0.5 if mode == "down" else 2

    def forward(self, x):
        out = _resize2(_lrelu(self.conv1(x)), self.factor)
        return _lrelu(self.conv2(out)) + self.skip(_resize2(x, self.factor))


class CSFTDecoder(nn.Module):
    """StyleGAN2GeneratorCSFT (gfpganv1_clean_arch.py:11): the clean decoder
    with SFT on half the channels (sft_half)."""

    def __init__(self, out_size: int = 512, style_dim: int = 512,
                 channel_multiplier: int = 2, narrow: float = 1.0, sft_half: bool = True):
        super().__init__()
        ch = gfpgan_channels(channel_multiplier, narrow)
        log_size = int(math.log2(out_size))
        self.num_layers = (log_size - 2) * 2 + 1
        self.sft_half = sft_half
        self.constant_input = nn.Module()
        self.constant_input.weight = nn.Parameter(torch.randn(1, ch[4], 4, 4))
        self.style_conv1 = CleanStyleConv(ch[4], ch[4], style_dim)
        self.to_rgb1 = CleanToRGB(ch[4], style_dim, upsample=False)
        convs, rgbs, cin = [], [], ch[4]
        for p in range(log_size - 2):
            f = ch[2 ** (p + 3)]
            convs.append(CleanStyleConv(cin, f, style_dim, sample_mode="upsample"))
            convs.append(CleanStyleConv(f, f, style_dim))
            rgbs.append(CleanToRGB(f, style_dim))
            cin = f
        self.style_convs = nn.ModuleList(convs)
        self.to_rgbs = nn.ModuleList(rgbs)

    def forward(self, latent, conditions, noise=None):
        if noise is None:
            noise = [None] * self.num_layers
        out = self.constant_input.weight.expand(latent.shape[0], -1, -1, -1)
        out = self.style_conv1(out, latent[:, 0], noise[0])
        skip = self.to_rgb1(out, latent[:, 1])
        i = 1
        for p, to_rgb in enumerate(self.to_rgbs):
            out = self.style_convs[2 * p](out, latent[:, i], noise[2 * p + 1])
            if i < len(conditions):
                if self.sft_half:
                    same, sft = out.chunk(2, dim=1)
                    out = torch.cat([same, sft * conditions[i - 1] + conditions[i]], 1)
                else:
                    out = out * conditions[i - 1] + conditions[i]
            out = self.style_convs[2 * p + 1](out, latent[:, i + 1], noise[2 * p + 2])
            skip = to_rgb(out, latent[:, i + 2], skip)
            i += 2
        return skip


class GFPGANv1Clean(nn.Module):
    """U-Net conditions and the CSFT decoder: (B, 3, S, S) in [-1, 1] ->
    (image, latent (B, n, 512))."""

    def __init__(self, out_size: int = 512, num_style_feat: int = 512,
                 channel_multiplier: int = 2, narrow: float = 1.0, different_w: bool = True,
                 sft_half: bool = True):
        super().__init__()
        unet = gfpgan_channels(channel_multiplier, narrow * 0.5)
        log_size = int(math.log2(out_size))
        self.num_latent = log_size * 2 - 2
        self.num_style_feat, self.different_w = num_style_feat, different_w
        self.conv_body_first = nn.Conv2d(3, unet[out_size], 1)
        downs, cin = [], unet[out_size]
        for i in range(log_size, 2, -1):
            downs.append(GFPGANResBlock(cin, unet[2 ** (i - 1)], "down"))
            cin = unet[2 ** (i - 1)]
        self.conv_body_down = nn.ModuleList(downs)
        self.final_conv = nn.Conv2d(cin, unet[4], 3, padding=1)
        self.final_linear = nn.Linear(unet[4] * 16, num_style_feat * (
            self.num_latent if different_w else 1))
        ups, scales, shifts, cin = [], [], [], unet[4]
        for i in range(log_size - 2):
            f = unet[2 ** (i + 3)]
            ups.append(GFPGANResBlock(cin, f, "up"))
            sft_out = f if sft_half else 2 * f
            for heads in (scales, shifts):
                heads.append(nn.Sequential(nn.Conv2d(f, f, 3, padding=1), nn.LeakyReLU(0.2),
                                           nn.Conv2d(f, sft_out, 3, padding=1)))
            cin = f
        self.conv_body_up = nn.ModuleList(ups)
        self.condition_scale = nn.ModuleList(scales)
        self.condition_shift = nn.ModuleList(shifts)
        self.stylegan_decoder = CSFTDecoder(out_size, num_style_feat, channel_multiplier,
                                            narrow, sft_half)

    def forward(self, x):
        feat = _lrelu(self.conv_body_first(x))
        skips = []
        for down in self.conv_body_down:
            feat = down(feat)
            skips.insert(0, feat)
        feat = _lrelu(self.final_conv(feat))
        b = feat.shape[0]
        code = self.final_linear(feat.flatten(1))
        latent = (code.reshape(b, self.num_latent, self.num_style_feat) if self.different_w
                  else code[:, None].expand(-1, self.num_latent, -1))
        conditions = []
        for i, up in enumerate(self.conv_body_up):
            feat = up(feat + skips[i])
            conditions += [self.condition_scale[i](feat), self.condition_shift[i](feat)]
        return self.stylegan_decoder(latent, conditions), latent


def gfpgan_state_dict(state_dict: Mapping) -> dict[str, torch.Tensor]:
    """A GFPGAN state dict (reference file, `params_ema` envelope or none,
    or `convert.gfpgan_state_dict_from_jax`) for a strict load: the keys the
    restoration never reads (`_UNUSED`) dropped, as the JAX converter drops
    them."""
    sd = strip_module_prefix(unwrap_envelope(state_dict, "params_ema"))
    return as_tensors({k: v for k, v in sd.items() if not _UNUSED.search(k)})


class GFPGANEnhancer:
    """Aligned-crop restoration at the net's size (the reference's
    `face_restoration`): (B, H, W, 3) in [0, 255] in, the same shape out,
    float32. No `fused_form`, for the reason `CodeFormerEnhancer` gives."""

    def __init__(self, state_dict: Mapping, *, device=None, **arch):
        self.device = resolve_device(device)
        self.model = GFPGANv1Clean(**arch)
        self.size = arch.get("out_size", 512)
        self.model.load_state_dict(gfpgan_state_dict(state_dict), strict=True)
        self.model.to(self.device).eval().requires_grad_(False)

    def enhance_aligned(self, img255) -> torch.Tensor:
        return restore_aligned(self.model, img255, self.size, self.device)
