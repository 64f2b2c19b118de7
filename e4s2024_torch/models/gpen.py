"""GPEN face restoration, the pipeline's default enhancer (reference
swap_face_fine/gpen/face_model/gpen_model.py:380 `Generator`, :637
`FullGenerator`; run at 512^2 by GPENInfer, gpen_demo.py:18-121).

Counterpart of `e4s2024_tpu/models/gpen.py` in NCHW, with the reference's
state-dict names (`ecd{i}.0.*`, `final_linear.0`, `generator.style.*`,
`generator.input.input`, `generator.conv1`, `generator.convs.{i}`,
`generator.to_rgb1`, `generator.to_rgbs.{i}`). A StyleGAN2 decoder whose
"noise" inputs are the encoder's features, concatenated onto each styled
conv's output, so every styled conv's activation (kernel K1) sees twice the
conv's channels. The encoder is a chain of ConvLayers: a K2 blur, a
stride-2 conv, K1. The modulated convs and their FIR blurs are those of
`models/stylegan2.py`.

`GPENEnhancer` restores aligned crops; `GPENFullFrameEnhancer` restores
every face of a frame (RetinaFace, ArcFace-template alignment, one batched
GPEN forward, a feathered paste-back).
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch
from torch import nn

from e4s2024_torch import resolve_device
from e4s2024_torch.convert import as_tensors, drop_fir_buffers, strip_module_prefix
from e4s2024_torch.models.stylegan2 import (
    ConstantInput, ConvLayer, EqualLinear, FusedLeakyReLU, ModulatedConv2d, NoiseInjection,
    PixelNorm, ToRGB)
from e4s2024_torch.ops.resize import resize_bilinear

# the fixed buffers of a reference GPEN file: the encoder's downsample blurs
# (gain 1), the decoder's up-conv blurs and skip upsamples (gain 4), noise maps
GPEN_FIR_GAINS = [(r"^ecd\d+\.0\.0\.kernel$", 1.0),
                  (r"^generator\..*\.(blur|upsample)\.kernel$", 4.0)]
GPEN_NOISE = r"(^|\.)noises\.noise_\d+$"


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


def gpen_state_dict(state_dict: Mapping) -> dict[str, torch.Tensor]:
    """A GPEN state dict (reference file or `convert.gpen_state_dict_from_jax`)
    for a strict load: `module.` stripped, FIR and noise buffers dropped
    (`convert.drop_fir_buffers`: each FIR buffer must equal the port's
    constant)."""
    sd = drop_fir_buffers(strip_module_prefix(state_dict), GPEN_FIR_GAINS, GPEN_NOISE)
    return as_tensors(sd)


class GPENEnhancer:
    """Restoration of aligned crops at GPEN's size (the reference's
    GPENInfer.infer_image on aligned faces): (B, H, W, 3) in [0, 255] in,
    the same shape out, float32 on the enhancer's device; crops of another
    size are resized to `size` and back with `ops/resize.py` (JAX's
    interpolation matrices).

    `fused_form` marks a component that the JAX pipeline runs inside its
    one-program path, where the enhanced float crop enters the swap
    unquantised (`pipelines/full_swap.py`)."""

    fused_form = True

    def __init__(self, state_dict: Mapping, size: int = 512, *, channel_multiplier: int = 2,
                 narrow: float = 1.0, device=None):
        self.size = size
        self.device = resolve_device(device)
        self.model = GPENFullGenerator(size, channel_multiplier=channel_multiplier,
                                       narrow=narrow)
        self.model.load_state_dict(gpen_state_dict(state_dict), strict=True)
        self.model.to(self.device).eval().requires_grad_(False)

    def enhance_aligned(self, img255) -> torch.Tensor:
        return restore_aligned(self.model, img255, self.size, self.device)


def restore_aligned(net, img255, size: int, device, *args) -> torch.Tensor:
    """The aligned-crop glue of the restoration nets (GPEN, CodeFormer,
    GFPGAN): (B, H, W, 3) in [0, 255] to [-1, 1], resized to the net's
    `size` and back with `ops/resize.py` where H differs, the net's image
    output (`net(x, *args)[0]`) clipped to [0, 255]; float32 NHWC out."""
    with torch.inference_mode():
        x = torch.as_tensor(img255).to(device, torch.float32)
        h = x.shape[1]
        x = x.permute(0, 3, 1, 2) / 127.5 - 1.0
        if h != size:
            x = resize_bilinear(x, (size, size))
        out = torch.clamp((net(x.contiguous(), *args)[0] + 1.0) * 127.5, 0, 255)
        if h != size:
            out = resize_bilinear(out, (h, h))
        return out.permute(0, 2, 3, 1)


def landmarks68_to_5(lm68: np.ndarray) -> np.ndarray:
    """68-point landmarks -> the 5 points (eyes, nose tip, mouth corners)
    the ArcFace templates take."""
    lm68 = np.asarray(lm68, np.float64)
    return np.stack([lm68[36:42].mean(0), lm68[42:48].mean(0), lm68[30], lm68[48], lm68[54]])


class GPENFullFrameEnhancer:
    """Whole-frame restoration: detect, align, restore, paste back
    (reference gpen_demo.py:18-121). Faces come from the port's RetinaFace
    (5-point landmarks of every face) unless a 68-point `landmark_fn` hook
    is given (one face); each is warped to GPEN's size on the ArcFace
    template ("ffhq" at 512, "set1" otherwise), all run one GPEN forward, and
    each is pasted back through the inverse warp under an all-ones mask
    feathered over `border_frac` of the crop. With `sr_upscaler` (anything
    with `.upscale((B, H, W, 3) [0, 255])`, e.g. `RealESRGANUpscaler`) the
    whole frame is upscaled x4 first (truncated to uint8) and the faces are
    restored on it, as the reference's use_sr flow does
    (face_enhancement.py:63-67)."""

    def __init__(self, enhancer: GPENEnhancer, landmark_fn=None, border_frac: float = 0.05,
                 detector=None, sr_upscaler=None):
        self.enhancer = enhancer
        self.landmark_fn = landmark_fn
        self.border_frac = border_frac
        self._detector = detector
        self.sr_upscaler = sr_upscaler

    def _faces_lm5(self, frame: np.ndarray) -> np.ndarray:
        if self.landmark_fn is not None:
            lm = self.landmark_fn(frame)
            if lm is None:
                return np.zeros((0, 5, 2), np.float32)
            return landmarks68_to_5(lm)[None]
        if self._detector is None:
            from e4s2024_torch.pipelines.detect import default_landmarker

            self._detector = default_landmarker(device=self.enhancer.device).detector
        det = getattr(self._detector, "detector", self._detector)
        return det.detect(frame)[2]

    def enhance_frame(self, frame255) -> np.ndarray:
        """(H, W, 3) uint8 frame -> the frame with every detected face
        restored, (H, W, 3) uint8 numpy (at 4x the size with `sr_upscaler`);
        unchanged when no face is found."""
        from e4s2024_torch.pipelines.arcface_align import (
            estimate_norm, invert_affine, warp_affine, warp_affine_hw)

        frame_np = np.asarray(frame255)
        dev = self.enhancer.device
        if self.sr_upscaler is not None:
            up = self.sr_upscaler.upscale(
                torch.as_tensor(frame_np, dtype=torch.float32, device=dev)[None])[0]
            frame_np = up.cpu().numpy().astype(np.uint8)
        lm5s = self._faces_lm5(frame_np)
        if lm5s.shape[0] == 0:
            return frame_np
        s = self.enhancer.size
        mode = "set1" if s != 512 else "ffhq"
        frame = torch.as_tensor(frame_np, device=dev).float()
        ms = [estimate_norm(lm5, s, mode=mode) for lm5 in lm5s]
        crops = torch.stack([warp_affine(frame, m, s) for m in ms])
        restored = self.enhancer.enhance_aligned(crops)  # one batched forward
        b = max(1, int(s * self.border_frac))
        ramp = np.minimum(np.arange(s, dtype=np.float32), np.arange(s, dtype=np.float32)[::-1])
        ramp = np.clip(ramp / b, 0.0, 1.0)
        mask = torch.as_tensor((ramp[:, None] * ramp[None, :])[..., None], device=dev)
        hw = tuple(frame.shape[:2])
        out = frame
        for i, m in enumerate(ms):
            inv = invert_affine(m)
            pasted = warp_affine_hw(restored[i], inv, hw)
            alpha = warp_affine_hw(mask, inv, hw)
            out = pasted * alpha + out * (1.0 - alpha)
        return torch.clamp(out, 0, 255).cpu().numpy().astype(np.uint8)
