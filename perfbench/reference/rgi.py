"""RGI net, the E4S core model: encoder + per-region MLPs + regional
StyleGAN2 (reference models/networks.py:51 `Net3`).

Counterpart of `e4s2024_tpu/models/rgi.py`, with the reference's state-dict
names (`encoder.*`, `G.*`, `MLPs.{i}.mlp.{0,2}`, `latent_avg`).

A frozen copy of `e4s2024_torch/models/rgi.py` for the benchmark's plain
reference: no kernel, no split, no process group; it imports nothing of
the port.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .encoders import FSEncoderPSP
from .stylegan2 import EqualLinear, Generator
from .resize import resize_bilinear


class LocalMLP(nn.Module):
    """Per-component 1280-d style vector -> (num_w_layers, 512) W+ rows
    (reference networks.py:23)."""

    def __init__(self, dim_component: int = 1280, dim_style: int = 512,
                 num_w_layers: int = 13):
        super().__init__()
        self.dim_style, self.num_w_layers = dim_style, num_w_layers
        self.mlp = nn.Sequential(
            EqualLinear(dim_component, dim_style),
            nn.LeakyReLU(),
            EqualLinear(dim_style, dim_style * num_w_layers))

    def forward(self, x):
        return self.mlp(x).reshape(-1, self.num_w_layers, self.dim_style)


class RGINet(nn.Module):
    """FSEncoderPSP + 12 LocalMLPs + regional
    Generator, W+ codes centred on `latent_avg` (a buffer: loaded from
    checkpoints, never trained)."""

    def __init__(self, num_seg_cls: int = 12, out_size: int = 1024,
                 remaining_layer_idx: int = 13, split_layer_idx: int = 5,
                 channel_multiplier: int = 2, start_from_latent_avg: bool = True,
                 encoder_input_size: int = 256,
                 encoder_num_units: tuple = (3, 4, 14, 3)):
        super().__init__()
        n_latent = 2 * int(math.log2(out_size)) - 2
        if remaining_layer_idx != 17 and remaining_layer_idx > n_latent:
            raise ValueError(f"remaining_layer_idx={remaining_layer_idx} exceeds "
                             f"n_latent={n_latent} for out_size={out_size}")
        self.num_seg_cls = num_seg_cls
        self.remaining_layer_idx = remaining_layer_idx
        self.start_from_latent_avg = start_from_latent_avg
        self.encoder_input_size = encoder_input_size
        self.encoder, dim_component = FSEncoderPSP(encoder_num_units), 1280
        num_w = remaining_layer_idx if remaining_layer_idx != 17 else 18
        self.MLPs = nn.ModuleList(LocalMLP(dim_component, num_w_layers=num_w)
                                  for _ in range(num_seg_cls))
        self.G = Generator(out_size, channel_multiplier=channel_multiplier,
                           split_layer_idx=split_layer_idx,
                           remaining_layer_idx=remaining_layer_idx)
        self.register_buffer("latent_avg", torch.zeros(self.G.n_latent, 512))

    def init_rules(self):
        return {"latent_avg": ("const", 0.0)}

    def get_style_vectors(self, img, mask):
        """img: (B, 3, H, W) in [-1, 1], resized bilinear to the encoder's
        input size; mask: (B, K, Hm, Wm) one-hot. Returns ((B, K, 1280),
        structure_feats). Under a height split img, mask and the structure
        features are slabs of rows."""
        s = self.encoder_input_size
        return self.encoder(resize_bilinear(img, (s, s)), mask)

    def cal_style_codes(self, style_vectors):
        """(B, K, 1280) -> (B, K, n_latent, 512) W+ codes (networks.py:223)."""
        codes = torch.stack([mlp(style_vectors[:, i]) for i, mlp in enumerate(self.MLPs)],
                            dim=1)
        if self.start_from_latent_avg:
            avg = self.latent_avg.to(codes.dtype)
            if self.remaining_layer_idx != 17:
                r = self.remaining_layer_idx
                codes = codes + avg[None, None, :r]
                b, k = codes.shape[:2]
                tail = avg[None, None, r:].expand(b, k, -1, -1)
                codes = torch.cat([codes, tail], dim=2)
            else:
                codes = codes + avg[None, None]
        return codes

    def gen_img(self, struc_codes, style_codes, mask, *, noise=None,
                regional_mode="exact", return_latents=False):
        return self.G(style_codes, struc_codes, mask, noise=noise,
                      regional_mode=regional_mode, return_latents=return_latents)

    def forward(self, img, mask, *, noise=None, regional_mode="exact",
                return_latents=False):
        style_vectors, structure_feats = self.get_style_vectors(img, mask)
        images, latent, feats = self.gen_img(
            structure_feats, self.cal_style_codes(style_vectors), mask,
            noise=noise, regional_mode=regional_mode, return_latents=return_latents)
        if return_latents:
            return images, feats, latent
        return images, feats
