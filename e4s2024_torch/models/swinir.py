"""SwinIR x4 real-world super-resolution, and the face enhancer built on it.

Counterpart of `e4s2024_tpu/models/swinir.py`: the reference's SwinIR-M
real_sr configuration (window 8, embed 180, six residual Swin transformer
blocks (RSTBs) of six blocks with 6 heads, mlp_ratio 2, 'nearest+conv'
upsampler, scale 4). Images enter and leave as (B, H, W, 3), the JAX
package's layout; the transformer body runs channels-last (B, H, W, C), the
convolutions NCHW on a permuted view.

Module and parameter names are the reference's state-dict names
(`conv_first`, `patch_embed.norm`,
`layers.{i}.residual_group.blocks.{j}.{norm1, attn.qkv, attn.proj,
attn.relative_position_bias_table, norm2, mlp.fc1, mlp.fc2}`,
`layers.{i}.conv`, `norm`, `conv_after_body`, `conv_before_upsample.0`,
`conv_up1`, `conv_up2`, `conv_hr`, `conv_last`). The reference's
`relative_position_index` and `attn_mask` buffers are recomputed here, so a
reference checkpoint loads once those keys are dropped.

Three routes run the attention, each through a kernel on the card:

- `apply_fused` (the upscaler's default): every block is one call of K5,
  `ops/swin_block.fused_swin_block`;
- the module forward with `use_kernel=True`: qkv and proj as linear layers,
  the attention through K4, `ops/window_attention.swin_attention_nhwc`, on
  qkv in its (B, H, W, 3C) layout;
- the module forward with `use_kernel=False`: the windowed path, qkv
  partitioned into (BW, heads, n, hd) windows with the labels tiled over the
  batch, the attention through K6, `ops/window_attention.fused_window_attention`.

Parameters stay float32; `dtype` is the compute type, as in the JAX module.
Labels, each block's (heads, n, n) bias gather and the fused route's weight
dicts are made once and cached on the module's device (`clear_cache` after
changing weights in place; `load_state_dict` and `.to` clear it).
"""

from __future__ import annotations

import functools
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from e4s2024_torch import resolve_device
from e4s2024_torch.ops.resize import resize_bilinear, resize_nearest
from e4s2024_torch.ops.swin_block import block_weights, fused_swin_block
# window_partition and window_reverse are part of this module's interface too,
# as in the JAX module
from e4s2024_torch.ops.window_attention import (  # noqa: F401
    fused_window_attention, merge_windows, partition_qkv, swin_attention_nhwc, tile_labels,
    window_partition, window_reverse)

RGB_MEAN = (0.4488, 0.4371, 0.4040)
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def rel_pos_index(w: int) -> np.ndarray:
    """(w^2, w^2) index into the (2w - 1)^2 relative-position bias table."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + (w - 1)
    return (rel[..., 0] * (2 * w - 1) + rel[..., 1]).astype(np.int32)


@functools.lru_cache(maxsize=None)
def shift_labels(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """(nW, window^2) int8 window-region labels of the cyclically shifted
    image: two tokens of a window attend to each other iff their labels match
    (the compact form of the reference's attention mask)."""
    img = np.zeros((h, w))
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(h // window, window, w // window, window)
    return win.transpose(0, 2, 1, 3).reshape(-1, window * window).astype(np.int8)


def shift_mask(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """Dense (nW, n, n) additive mask (0 or -100), the reference's form."""
    win = shift_labels(h, w, window, shift)
    diff = win[:, None, :].astype(np.int32) - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def _linear(m: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, m.weight.to(x.dtype), m.bias.to(x.dtype))


def _conv(m: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x, m.weight.to(x.dtype), m.bias.to(x.dtype), padding=1)


def _layer_norm(m: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm with float32 statistics and parameters, output in x's dtype."""
    return F.layer_norm(x.float(), m.normalized_shape, m.weight, m.bias, m.eps).to(x.dtype)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window: int, heads: int):
        super().__init__()
        self.window, self.heads = window, heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            nn.init.trunc_normal_(torch.empty((2 * window - 1) ** 2, heads), std=0.02))
        self.register_buffer("relative_position_index",
                             torch.from_numpy(rel_pos_index(window)).long(), persistent=False)

    def bias_hnn(self) -> torch.Tensor:
        """(heads, n, n) float32 relative-position bias."""
        n = self.window * self.window
        bias = self.relative_position_bias_table.detach()[self.relative_position_index.view(-1)]
        return bias.view(n, n, self.heads).permute(2, 0, 1).float().contiguous()

    def forward(self, x: torch.Tensor, bias: torch.Tensor, labels: torch.Tensor | None,
                use_kernel: bool) -> torch.Tensor:
        """x (B, H, W, C), already rolled for a shifted block; labels
        (H/w, W/w, n) int32 or None. Attention through K4 (use_kernel) or,
        windowed, through K6."""
        b, h, w, c = x.shape
        qkv = _linear(self.qkv, x)
        if use_kernel:
            out = swin_attention_nhwc(qkv, bias, labels, window=self.window, heads=self.heads)
        else:
            q, k, v = partition_qkv(qkv, self.window, self.heads)
            lab = None if labels is None else tile_labels(labels, b)
            out = merge_windows(fused_window_attention(q, k, v, bias, lab), b, h, w, self.window)
        return _linear(self.proj, out)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _linear(self.fc2, F.gelu(_linear(self.fc1, x)))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int = 8, shift: int = 0,
                 mlp_ratio: float = 2.0):
        super().__init__()
        self.shift, self.window, self.heads = shift, window, heads
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, window, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, bias: torch.Tensor, labels: torch.Tensor | None,
                use_kernel: bool) -> torch.Tensor:
        """x (B, H, W, C); labels of the shifted image for a shifted block."""
        s = self.shift
        y = _layer_norm(self.norm1, x)
        if s:
            y = torch.roll(y, (-s, -s), dims=(1, 2))
        y = self.attn(y, bias, labels, use_kernel)
        if s:
            y = torch.roll(y, (s, s), dims=(1, 2))
        x = x + y
        return x + self.mlp(_layer_norm(self.norm2, x))


class BasicLayer(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, window: int):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, heads, window, shift=0 if i % 2 == 0 else window // 2)
            for i in range(depth))


class RSTB(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, window: int):
        super().__init__()
        self.residual_group = BasicLayer(dim, depth, heads, window)
        self.conv = nn.Conv2d(dim, dim, 3, padding=1)


class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)


class SwinIR(nn.Module):
    """real_sr M configuration; forward takes (B, H, W, 3) in [0, 1] with H
    and W multiples of the window and returns (B, 4H, 4W, 3) float32."""

    def __init__(self, embed_dim: int = 180, depths: tuple = (6, 6, 6, 6, 6, 6),
                 heads: tuple = (6, 6, 6, 6, 6, 6), window: int = 8, scale: int = 4,
                 num_feat: int = 64, mlp_ratio: float = 2.0,
                 dtype: torch.dtype = torch.float32, use_kernel: bool = False):
        super().__init__()
        if scale != 4:
            raise ValueError("only the x4 'nearest+conv' upsampler is ported")
        self.embed_dim, self.depths, self.heads = embed_dim, tuple(depths), tuple(heads)
        self.window, self.scale, self.dtype, self.use_kernel = window, scale, dtype, use_kernel
        self.conv_first = nn.Conv2d(3, embed_dim, 3, padding=1)
        self.patch_embed = PatchEmbed(embed_dim)
        self.layers = nn.ModuleList(RSTB(embed_dim, d, nh, window)
                                    for d, nh in zip(self.depths, self.heads))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)
        self.conv_after_body = nn.Conv2d(embed_dim, embed_dim, 3, padding=1)
        self.conv_before_upsample = nn.Sequential(
            nn.Conv2d(embed_dim, num_feat, 3, padding=1), nn.LeakyReLU(inplace=True))
        self.conv_up1 = nn.Conv2d(num_feat, num_feat, 3, padding=1)
        self.conv_up2 = nn.Conv2d(num_feat, num_feat, 3, padding=1)
        self.conv_hr = nn.Conv2d(num_feat, num_feat, 3, padding=1)
        self.conv_last = nn.Conv2d(num_feat, 3, 3, padding=1)
        self._cache: dict = {}

    # ---------------- caches ----------------

    def clear_cache(self) -> None:
        self._cache.clear()

    def _apply(self, *args, **kwargs):
        self.clear_cache()
        return super()._apply(*args, **kwargs)

    def load_state_dict(self, *args, **kwargs):
        self.clear_cache()
        return super().load_state_dict(*args, **kwargs)

    def _cached(self, key, make):
        if key not in self._cache:
            self._cache[key] = make()
        return self._cache[key]

    def _labels(self, h: int, w: int, device) -> torch.Tensor:
        """(H/w, W/w, n) int32 labels of the shifted image, on `device`."""
        ws = self.window

        def make():
            lab = shift_labels(h, w, ws, ws // 2).astype(np.int32)
            return torch.from_numpy(lab.reshape(h // ws, w // ws, ws * ws)).to(device)

        return self._cached(("labels", h, w, str(device)), make)

    def _biases(self) -> list[list[torch.Tensor]]:
        dev = self.conv_first.weight.device
        return self._cached(("bias", str(dev)), lambda: [
            [blk.attn.bias_hnn() for blk in layer.residual_group.blocks]
            for layer in self.layers])

    def fused_weights(self, dtype: torch.dtype) -> list[list[dict]]:
        """Per RSTB, per block: the weight dict K5 takes in `dtype`."""
        dev = self.conv_first.weight.device
        biases = self._biases()
        return self._cached(("fused", dtype, str(dev)), lambda: [
            [block_weights(blk.norm1, blk.attn.qkv, blk.attn.proj, bias, blk.norm2,
                           blk.mlp.fc1, blk.mlp.fc2, dtype)
             for blk, bias in zip(layer.residual_group.blocks, layer_bias)]
            for layer, layer_bias in zip(self.layers, biases)])

    # ---------------- forward ----------------

    def _head(self, x: torch.Tensor):
        mean = torch.tensor(RGB_MEAN, device=x.device)
        x = (x.float() - mean).to(self.dtype)
        feat = _conv(self.conv_first, _nchw(x))                       # (B, C, H, W)
        body = _layer_norm(self.patch_embed.norm, _nhwc(feat))        # (B, H, W, C)
        return feat, body

    def _tail(self, feat: torch.Tensor, body: torch.Tensor) -> torch.Tensor:
        body = _layer_norm(self.norm, body)
        feat = feat + _conv(self.conv_after_body, _nchw(body))
        # conv_before_upsample's LeakyReLU has torch's default slope 0.01,
        # the up convs' 0.2
        feat = F.leaky_relu(_conv(self.conv_before_upsample[0], feat), 0.01)
        h, w = feat.shape[-2:]
        feat = F.leaky_relu(_conv(self.conv_up1, resize_nearest(feat, (2 * h, 2 * w))), 0.2)
        feat = F.leaky_relu(_conv(self.conv_up2, resize_nearest(feat, (4 * h, 4 * w))), 0.2)
        feat = F.leaky_relu(_conv(self.conv_hr, feat), 0.2)
        out = _conv(self.conv_last, feat).float()
        out = out + torch.tensor(RGB_MEAN, device=out.device).view(1, 3, 1, 1)
        return _nhwc(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Module forward: the attention through K4 (`use_kernel`) or K6."""
        feat, body = self._head(x)
        h, w = body.shape[1:3]
        for layer, layer_bias in zip(self.layers, self._biases()):
            res = body
            for blk, bias in zip(layer.residual_group.blocks, layer_bias):
                labels = self._labels(h, w, body.device) if blk.shift else None
                body = blk(body, bias, labels, self.use_kernel)
            body = _nhwc(_conv(layer.conv, _nchw(body))) + res
        return self._tail(feat, body)


def apply_fused(model: SwinIR, x: torch.Tensor) -> torch.Tensor:
    """SwinIR forward with every Swin block as one call of kernel K5 (the
    counterpart of the JAX `apply_fused`). Shifted blocks roll x before and
    after the kernel."""
    feat, body = model._head(x)
    h, w = body.shape[1:3]
    shift = model.window // 2
    for layer, layer_wts in zip(model.layers, model.fused_weights(model.dtype)):
        res = body
        for blk, wts in zip(layer.residual_group.blocks, layer_wts):
            labels = None
            if blk.shift:
                body = torch.roll(body, (-shift, -shift), dims=(1, 2))
                labels = model._labels(h, w, body.device)
            body = fused_swin_block(body, wts, labels, window=model.window, heads=blk.heads)
            if blk.shift:
                body = torch.roll(body, (shift, shift), dims=(1, 2))
        body = _nhwc(_conv(layer.conv, _nchw(body))) + res
    return model._tail(feat, body)


def _tensor_dict(state: Mapping) -> dict[str, torch.Tensor]:
    return {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
            for k, v in state.items()}


class SwinIRUpscaler:
    """x4 upscale of [0, 255] images with padding to the window (reference
    image_infer.py:50-66).

    Args:
      state_dict: SwinIR weights in the reference's names.
      compute_dtype: "float32" or "bfloat16", the nets' compute type.
      fused: run every Swin block as kernel K5 (`apply_fused`, the default);
        otherwise the module forward, whose attention goes through K4 with
        `use_kernel=True` or K6 without.
      device: "cuda" (the default) or "cpu".
      **arch: SwinIR's architecture arguments (embed_dim, depths, heads,
        window, num_feat, mlp_ratio); the reference's SwinIR-M by default.

    On a card every route launches its kernels or raises; none falls back
    to another.
    """

    def __init__(self, state_dict: Mapping, *, compute_dtype: str = "float32",
                 fused: bool = True, use_kernel: bool = False, device=None, **arch):
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}")
        self.device = resolve_device(device)
        self.model = SwinIR(**arch, dtype=_DTYPES[compute_dtype], use_kernel=use_kernel)
        self.model.load_state_dict(_tensor_dict(state_dict), strict=True)
        self.model.to(self.device).eval().requires_grad_(False)
        self.fused = fused

    def forward(self, x01: torch.Tensor) -> torch.Tensor:
        """The net on (B, H, W, 3) in [0, 1], H and W multiples of the window:
        (B, 4H, 4W, 3) float32, before any clipping."""
        with torch.inference_mode():
            return apply_fused(self.model, x01) if self.fused else self.model(x01)

    def upscale(self, img255) -> torch.Tensor:
        """(B, H, W, 3) in [0, 255] -> (B, 4H, 4W, 3) float32 in [0, 255]. The
        input is padded to the window by mirroring its last rows and columns."""
        with torch.inference_mode():
            x = torch.as_tensor(img255).to(self.device, torch.float32) / 255.0
            _, h, w, _ = x.shape
            ws = self.model.window
            hp, wp = -h % ws, -w % ws
            if hp:
                x = torch.cat([x, torch.flip(x[:, -hp:], (1,))], 1)
            if wp:
                x = torch.cat([x, torch.flip(x[:, :, -wp:], (2,))], 2)
            out = self.forward(x)[:, : h * self.model.scale, : w * self.model.scale]
            return torch.clamp(out * 255.0, 0.0, 255.0)


class SwinIREnhancer:
    """Same-size face enhancement through the x4 SR, the reference's "SwinIR"
    face-enhancement mode (reference Face_swap_with_two_imgs.py:627-631):
    the crop is upscaled x4 and resized back bilinearly. (B, S, S, 3) in
    [0, 255] in, the same shape out, float32 on the upscaler's device."""

    def __init__(self, upscaler: SwinIRUpscaler, max_batch: int = 4):
        self.upscaler = upscaler
        # at most this many crops per call of the net; a trailing chunk is
        # padded with copies of the last crop, as the JAX enhancer does
        self.max_batch = max_batch

    def enhance_aligned(self, crops255) -> torch.Tensor:
        crops = torch.as_tensor(crops255).to(self.upscaler.device, torch.float32)
        b, h, w = crops.shape[:3]
        if b > self.max_batch:
            m = self.max_batch
            pad = -b % m
            if pad:
                crops = torch.cat([crops, crops[-1:].expand(pad, -1, -1, -1)])
            return torch.cat([self.enhance_aligned(crops[i:i + m])
                              for i in range(0, b + pad, m)])[:b]
        out = self.upscaler.upscale(crops)
        return resize_bilinear(_nchw(out), (h, w)).permute(0, 2, 3, 1)
