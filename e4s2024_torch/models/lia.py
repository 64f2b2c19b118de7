"""LIA (Latent Image Animator) reenactment.

Counterpart of `e4s2024_tpu/models/lia.py` in NCHW, with the reference's
state-dict names (swap_face_fine/LIA/networks/: generator.py:6 `Generator`
= `enc`, the StyleGAN2-style appearance encoder (encoder.py:202 EncoderApp
`enc.net_app.convs.*`) and its 5-layer motion MLP (`enc.fc.*`), and `dec`,
the flow-warping synthesis decoder (styledecoder.py:455 Synthesis, with
ToFlow warps and the QR-orthogonalised motion dictionary `dec.direction`)),
driven as run_demo.py:99 `run_online`: h_start is the source's own motion
code, so the latent becomes wa + direction(driving motion).

The StyleGAN2 parts are `models/stylegan2.py`'s: every activation runs
kernel K1 and every blur and upsample kernel K2 on the card. As in the JAX
package, the synthesis adds no noise (the reference draws fresh noise per
call). The reference checkpoint is an internal cluster path
(run_demo.py:54), so weights are the caller's.
"""

from __future__ import annotations

import math
import re
from typing import Mapping

import numpy as np
import torch
from torch import nn

from e4s2024_torch import resolve_device
from e4s2024_torch.convert import as_tensors, drop_fir_buffers, strip_module_prefix, \
    unwrap_envelope
from e4s2024_torch.models.stylegan2 import (
    BLUR_TAPS, ConstantInput, ConvLayer, EqualConv2d, EqualLinear, ModulatedConv2d, ResBlock,
    StyledConv)
from e4s2024_torch.models.tpsmm import grid_sample_2d
from e4s2024_torch.ops.upfirdn import make_kernel, upsample_2x

# the encoder's channel plan is fixed (encoder.py:205); the synthesis plan
# scales the >= 64 px levels by channel_multiplier (styledecoder.py:469)
ENC_CHANNELS = {4: 512, 8: 512, 16: 512, 32: 512, 64: 256, 128: 128, 256: 64, 512: 32,
                1024: 16}

# the fixed buffers of a reference file: the encoder's downsample blurs
# (gain 1), the decoder's up-conv blurs and skip upsamples (gain 4)
LIA_FIR_GAINS = [(r"^enc\.net_app\.convs\.\d+\.(conv2|skip)\.0\.kernel$", 1.0),
                 (r"^dec\..*\.(blur|upsample)\.kernel$", 4.0)]
LIA_NOISE = r"(^|\.)noises\.noise_\d+$"
_STANDALONE_BIAS = re.compile(r"^dec\.(to_rgbs|to_flows)\.\d+\.bias$")


def syn_channels(cm: int) -> dict[int, int]:
    return {r: c * (cm if r >= 64 else 1) for r, c in ENC_CHANNELS.items()}


class LIAEncoderApp(nn.Module):
    """Appearance encoder (encoder.py:202): a 1x1 ConvLayer, ResBlocks down
    to 4x4, a 4x4 valid conv to w. forward -> (w (B, 512), the per-scale
    activations from 8 px up to full resolution)."""

    def __init__(self, size: int = 256, w_dim: int = 512):
        super().__init__()
        log_size = int(math.log2(size))
        convs = [ConvLayer(3, ENC_CHANNELS[size], 1)]
        for i in range(log_size, 2, -1):
            convs.append(ResBlock(ENC_CHANNELS[2 ** i], ENC_CHANNELS[2 ** (i - 1)]))
        convs.append(EqualConv2d(ENC_CHANNELS[4], w_dim, 4, padding=0, bias=False))
        self.convs = nn.ModuleList(convs)

    def forward(self, x):
        res = [x]
        for conv in self.convs:
            res.append(conv(res[-1]))
        return res[-1][:, :, 0, 0], res[-2:0:-1][1:]


class LIAEncoder(nn.Module):
    """Appearance and motion encoder (encoder.py:241): the motion code is a
    stack of 5 equalised linears without activations."""

    def __init__(self, size: int = 256, dim: int = 512, dim_motion: int = 20):
        super().__init__()
        self.net_app = LIAEncoderApp(size, dim)
        self.fc = nn.Sequential(*[EqualLinear(dim, dim) for _ in range(4)],
                                EqualLinear(dim, dim_motion))

    def enc_motion(self, x):
        return self.fc(self.net_app(x)[0])

    def forward(self, source, target, h_start=None):
        h_source, feats = self.net_app(source)
        h_motion = [self.fc(self.net_app(target)[0])]
        if h_start is not None:
            h_motion += [self.fc(h_source), h_start]
        return h_source, h_motion, feats


class Direction(nn.Module):
    """Orthogonal motion dictionary (styledecoder.py:423): Q of the QR of
    `weight + 1e-8` (512, M); direction(alpha) = alpha Q^T. The QR runs on
    the CPU (LAPACK's Householder signs, those of `jnp.linalg.qr` on the
    JAX package's CPU backend) whatever the weight's device."""

    def __init__(self, motion_dim: int = 20):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(512, motion_dim))

    def basis(self) -> torch.Tensor:
        q, _ = torch.linalg.qr(self.weight.detach().float().cpu() + 1e-8)
        return q.to(self.weight.device)

    def forward(self, alpha, q=None):
        q = self.basis() if q is None else q
        return alpha @ q.t()


class LIAToRGB(nn.Module):
    """LIA's ToRGB (styledecoder.py:374): not modulated, an activated
    equalised 1x1 ConvLayer (K1) plus a standalone bias, then the K2
    upsampled skip."""

    def __init__(self, in_channel: int, upsample: bool = True):
        super().__init__()
        self.conv = ConvLayer(in_channel, 3, 1)
        self.bias = nn.Parameter(torch.zeros(1, 3, 1, 1))
        self.upsample = upsample
        self.upsample_kernel = make_kernel(BLUR_TAPS)

    def forward(self, x, skip=None):
        out = self.conv(x) + self.bias
        if skip is not None:
            if self.upsample:
                skip = upsample_2x(skip.contiguous(), self.upsample_kernel)
            out = out + skip
        return out


class ToFlow(nn.Module):
    """Per-scale warp head (styledecoder.py:395): a 1x1 modulated conv gives
    (dx, dy, mask); the encoder feature is warped by tanh(d) + the identity
    grid and blended into the synthesis stream."""

    def __init__(self, in_channel: int, style_dim: int = 512):
        super().__init__()
        self.conv = ModulatedConv2d(in_channel, 3, 1, style_dim, demodulate=False)
        self.bias = nn.Parameter(torch.zeros(1, 3, 1, 1))
        self.upsample_kernel = make_kernel(BLUR_TAPS)

    def forward(self, x, style, feat, skip=None):
        out = self.conv(x, style) + self.bias
        if skip is not None:
            out = out + upsample_2x(skip.contiguous(), self.upsample_kernel)
        h = x.shape[-2]
        xs = np.linspace(-1, 1, h, dtype=np.float32)
        grid = torch.from_numpy(np.stack(np.meshgrid(xs, xs), 2)).to(x.device)
        flow = torch.tanh(out[:, 0:2]).permute(0, 2, 3, 1) + grid
        mask = torch.sigmoid(out[:, 2:3])
        feat_warp = grid_sample_2d(feat, flow, align_corners=False) * mask
        return feat_warp, feat_warp + x * (1.0 - mask), out


class LIASynthesis(nn.Module):
    """Flow-warping StyleGAN2 decoder (styledecoder.py:455). The reference
    repeats one latent across every layer, so each layer reads the same
    (B, 512) style."""

    def __init__(self, size: int = 256, style_dim: int = 512, motion_dim: int = 20,
                 channel_multiplier: int = 1):
        super().__init__()
        ch = syn_channels(channel_multiplier)
        log_size = int(math.log2(size))
        self.direction = Direction(motion_dim)
        self.input = ConstantInput(ch[4])
        self.conv1 = StyledConv(ch[4], ch[4], 3, style_dim)
        self.convs = nn.ModuleList()
        self.to_rgbs = nn.ModuleList()
        self.to_flows = nn.ModuleList()
        in_ch = ch[4]
        for j, r in enumerate(range(3, log_size + 1)):
            out_ch = ch[2 ** r]
            self.convs.append(StyledConv(in_ch, out_ch, 3, style_dim, upsample=True))
            self.convs.append(StyledConv(out_ch, out_ch, 3, style_dim))
            self.to_rgbs.append(LIAToRGB(out_ch, upsample=j > 0))
            self.to_flows.append(ToFlow(out_ch, style_dim))
            in_ch = out_ch

    def forward(self, wa, alpha, feats):
        if alpha is not None:
            q = self.direction.basis()
            if len(alpha) > 1:
                latent = wa + (self.direction(alpha[0], q) - self.direction(alpha[2], q)) \
                    + self.direction(alpha[1], q)
            else:
                latent = wa + self.direction(alpha[0], q)
        else:
            latent = wa
        out = self.conv1(self.input(wa.shape[0]), latent)
        skip = skip_flow = None
        for j, (to_rgb, to_flow) in enumerate(zip(self.to_rgbs, self.to_flows)):
            out = self.convs[2 * j + 1](self.convs[2 * j](out, latent), latent)
            out_warp, out, skip_flow = to_flow(out, latent, feats[j],
                                               None if j == 0 else skip_flow)
            skip = to_rgb(out_warp, None if j == 0 else skip)
        return skip


class LIAGenerator(nn.Module):
    """generator.py:6 Generator: the encoder and the synthesis."""

    def __init__(self, size: int = 256, style_dim: int = 512, motion_dim: int = 20,
                 channel_multiplier: int = 1):
        super().__init__()
        self.enc = LIAEncoder(size, style_dim, motion_dim)
        self.dec = LIASynthesis(size, style_dim, motion_dim, channel_multiplier)

    def forward(self, source_pm1, driving_pm1, h_start=None):
        wa, alpha, feats = self.enc(source_pm1, driving_pm1, h_start)
        return self.dec(wa, alpha, feats)


def lia_state_dict(state_dict: Mapping) -> dict[str, torch.Tensor]:
    """A LIA state dict (the reference checkpoint, its 'gen' envelope opened;
    or `convert.lia_state_dict_from_jax`) for a strict load: `module.`
    stripped, the FIR buffers checked against the port's constants and
    dropped (`LIA_FIR_GAINS`), the unused `dec.to_rgb1` dropped, and LIA's
    (1, C, 1, 1) activation biases flattened to the port's (C,)."""
    sd = strip_module_prefix(unwrap_envelope(state_dict, "gen"))
    sd = drop_fir_buffers(sd, LIA_FIR_GAINS, LIA_NOISE)
    out = {}
    for k, v in as_tensors(sd).items():
        if k.startswith("dec.to_rgb1."):
            continue
        if k.endswith(".bias") and v.ndim == 4 and not _STANDALONE_BIAS.match(k):
            v = v.reshape(-1)
        out[k] = v
    return out


class LIADriver:
    """run_online (reference run_demo.py:99): the source's own motion code
    as h_start, so latent = wa + direction(driving motion)."""

    def __init__(self, state_dict: Mapping, size: int = 256, motion_dim: int = 20, *,
                 device=None):
        self.device = resolve_device(device)
        self.gen = LIAGenerator(size=size, motion_dim=motion_dim)
        self.gen.load_state_dict(lia_state_dict(state_dict), strict=True)
        self.gen.eval().requires_grad_(False).to(self.device)

    @torch.inference_mode()
    def __call__(self, source_pm1, driving_pm1) -> torch.Tensor:
        """(B, 256, 256, 3) in [-1, 1] each -> the reenacted source, (B, 256,
        256, 3) in [-1, 1]."""
        src = torch.as_tensor(source_pm1, device=self.device).float().permute(0, 3, 1, 2)
        drv = torch.as_tensor(driving_pm1, device=self.device).float().permute(0, 3, 1, 2)
        h_start = self.gen.enc.enc_motion(src)
        return self.gen(src, drv, h_start).permute(0, 2, 3, 1)
