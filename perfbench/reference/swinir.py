"""SwinIR-M x4, plain: the shifted-window transformer super-resolution net of
Liang et al., "SwinIR: Image Restoration Using Swin Transformer" (ICCV
Workshops 2021, arXiv:2108.10257), as `models/network_swinir.py` of
github.com/JingyunLiang/SwinIR builds it for real-world SR ("SwinIR-M x4":
embed 180, six residual Swin transformer blocks (RSTBs) of six blocks with
6 heads, window 8, the shift 4 on every second block, MLP ratio 2,
`resi_connection="1conv"`, `upsampler="nearest+conv"`, img_range 1).

Plain `torch` in float32 (the caller keeps TF32 off), with no kernel of the
port: window partition, `torch.roll` by -shift and +shift, the published
attention mask (-100 added to the logits between the shifted image's
regions), the relative-position bias gathered from its (2w - 1)^2 x heads
table, LayerNorm, exact-erf GELU, the RSTB's closing conv and residual,
`conv_after_body` and the long skip, `conv_before_upsample` with
LeakyReLU 0.01 (nn.LeakyReLU's default), nearest x2 twice each followed by
a conv and LeakyReLU 0.2, `conv_hr`, `conv_last`, and the RGB mean added
back. State-dict names are the published ones.

Departures from the published code:

- Between blocks the tokens stay (B, H, W, C); the published code keeps
  (B, H * W, C) beside the image size. The same numbers.
- `relative_position_index` and `attn_mask` are made in the forward pass
  and cached by size and device, not stored as buffers, so the state dict
  holds the learned tensors only (the port's does the same: a published
  checkpoint loads once those two keys are dropped).
- The mask adds -100, as published. The port compares the window-region
  labels of two tokens and subtracts 100 where they differ: the same
  logits. Neither is an exact exclusion: a masked pair keeps a weight
  about exp(-100) of an unmasked one.
- No dropout, drop path or checkpointing: all are off at inference.
- The published net pads its input to the window itself (`check_image_size`,
  reflect); E4S pads before the net, mirroring the last rows and columns
  (`upscale` here, E4S's image_infer.py:50-66), so the net's pad never
  acts. A 1024^2 crop needs no pad.
- `init_rules` give what `perfbench/weights.py` does not know: LayerNorm's
  weight 1 and bias 0 (as published), and the bias table drawn normal with
  the published std 0.02 (published: truncated at two std). The benchmark
  draws the bias tables, convs and linear layers by `seeded_draws` instead.
- Each block adds itself to the active `plain_kernels.tally()` as one call
  of the port's kernel K5 (`fused_swin_block`), with its least bytes and
  its operations (`block_operations`), for the K5 roofline reader.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from . import plain_kernels

RGB_MEAN = (0.4488, 0.4371, 0.4040)
K5 = "fused_swin_block"


def block_operations(tokens: int, dim: int, hidden: int, window: int) -> int:
    """Operations of one Swin block over `tokens` tokens, two a
    multiply-add: per token qkv (3 C^2), proj (C^2), fc1 and fc2
    (2 C hidden), and the QK^T and PV products over the token's window
    (2 n C, n = window^2). LayerNorm, softmax and GELU are left out."""
    n = window * window
    return 2 * tokens * (4 * dim * dim + 2 * dim * hidden + 2 * n * dim)


def seeded_draws(embed_dim: int, num_feat: int, mlp_ratio: float = 2.0) -> dict:
    """`perfbench/weights.py` rules by key pattern that keep each layer's
    scale at these widths: He-normal convs (std sqrt(2 / fan_in)), conv_last
    a tenth of that so that the x4 output stays mostly inside [0, 1],
    unit-gain linear layers (std fan_in^-1/2), and the bias tables normal
    with std 0.5, of a trained net's order. With the published init the
    signal shrinks at every layer, the x4 output is the flat RGB mean and
    the bias is below rounding. e4s-swinir-1024's `init_overrides` are these
    at its widths."""
    def he(fan_in: int, gain: float = 1.0):
        return ("normal", gain * (2.0 / fan_in) ** 0.5)

    conv, feat, hidden = 9 * embed_dim, 9 * num_feat, int(embed_dim * mlp_ratio)
    return {"conv_first.weight": he(27), "layers.*.conv.weight": he(conv),
            "*.attn.relative_position_bias_table": ("normal", 0.5),
            "*.attn.qkv.weight": ("normal", embed_dim ** -0.5),
            "*.attn.proj.weight": ("normal", embed_dim ** -0.5),
            "*.mlp.fc1.weight": ("normal", embed_dim ** -0.5),
            "*.mlp.fc2.weight": ("normal", hidden ** -0.5),
            "conv_after_body.weight": he(conv), "conv_before_upsample.0.weight": he(conv),
            "conv_up1.weight": he(feat), "conv_up2.weight": he(feat),
            "conv_hr.weight": he(feat), "conv_last.weight": he(feat, 0.1)}


def _tally_block(block: "SwinBlock", x: torch.Tensor, out: torch.Tensor) -> None:
    """One K5 launch's worth in the active tally: a call, its least bytes (x
    read, out written, the block's weights read once) and, under the
    tally's `operations`, its operations."""
    t = plain_kernels._TALLY.get()
    if t is None:
        return
    t.add(K5, x, out, *block.parameters())
    ops = vars(t).setdefault("operations", {})
    b, h, w, c = x.shape
    ops[K5] = ops.get(K5, 0) + block_operations(b * h * w, c, block.mlp.fc1.out_features,
                                                block.window)


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, w * w, C), windows in row-major order."""
    b, h, ww, c = x.shape
    x = x.reshape(b, h // w, w, ww // w, w, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, c)


def window_reverse(windows: torch.Tensor, w: int, h: int, ww: int) -> torch.Tensor:
    """(B * nW, w * w, C) -> (B, H, W, C)."""
    b = windows.shape[0] // ((h // w) * (ww // w))
    x = windows.reshape(b, h // w, ww // w, w, w, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, ww, -1)


@functools.lru_cache(maxsize=8)
def relative_position_index(w: int, device: torch.device) -> torch.Tensor:
    """(w^2, w^2) index into the (2w - 1)^2 bias table, as published."""
    coords = torch.stack(torch.meshgrid(torch.arange(w), torch.arange(w), indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += w - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    return rel.sum(-1).to(device)


@functools.lru_cache(maxsize=8)
def attn_mask(h: int, w: int, window: int, shift: int, device: torch.device) -> torch.Tensor:
    """(nW, n, n) float32 mask of the shifted (H, W) image, as published
    (`calculate_mask`): 0 within a region, -100 between regions."""
    img = torch.zeros(1, h, w, 1)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[:, hs, ws, :] = cnt
            cnt += 1
    wins = window_partition(img, window).view(-1, window * window)
    mask = wins.unsqueeze(1) - wins.unsqueeze(2)
    return mask.masked_fill(mask != 0, -100.0).masked_fill(mask == 0, 0.0).to(device)


class LayerNorm(nn.LayerNorm):
    def init_rules(self) -> dict:
        return {"weight": ("const", 1.0), "bias": ("const", 0.0)}


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window: int, heads: int):
        super().__init__()
        self.window, self.heads = window, heads
        self.scale = (dim // heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * window - 1) ** 2, heads))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def init_rules(self) -> dict:
        return {"relative_position_bias_table": ("normal", 0.02)}

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        """x (B * nW, n, C); mask (nW, n, n) or None."""
        b_, n, c = x.shape
        qkv = self.qkv(x).reshape(b_, n, 3, self.heads, c // self.heads).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = (q * self.scale) @ k.transpose(-2, -1)
        index = relative_position_index(self.window, x.device)
        bias = self.relative_position_bias_table[index.view(-1)].view(n, n, -1)
        attn = attn + bias.permute(2, 0, 1).contiguous().unsqueeze(0)
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.view(b_ // nw, nw, self.heads, n, n) + mask.unsqueeze(1).unsqueeze(0)
            attn = attn.view(-1, self.heads, n, n)
        attn = attn.softmax(dim=-1)
        return self.proj((attn @ v).transpose(1, 2).reshape(b_, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.act = nn.GELU()
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shift: int, mlp_ratio: float):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, window, heads)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, C), H and W multiples of the window."""
        b, h, w, c = x.shape
        ws, s = self.window, self.shift
        y = self.norm1(x)
        if s:
            y = torch.roll(y, shifts=(-s, -s), dims=(1, 2))
        mask = attn_mask(h, w, ws, s, x.device) if s else None
        y = window_reverse(self.attn(window_partition(y, ws), mask), ws, h, w)
        if s:
            y = torch.roll(y, shifts=(s, s), dims=(1, 2))
        y = x + y
        out = y + self.mlp(self.norm2(y))
        _tally_block(self, x, out)
        return out


class BasicLayer(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, window: int, mlp_ratio: float):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, heads, window, 0 if i % 2 == 0 else window // 2, mlp_ratio)
            for i in range(depth))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x)
        return x


class RSTB(nn.Module):
    """A residual Swin transformer block with the "1conv" connection."""

    def __init__(self, dim: int, depth: int, heads: int, window: int, mlp_ratio: float):
        super().__init__()
        self.residual_group = BasicLayer(dim, depth, heads, window, mlp_ratio)
        self.conv = nn.Conv2d(dim, dim, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.residual_group(x).permute(0, 3, 1, 2)
        return self.conv(y).permute(0, 2, 3, 1) + x


class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(dim)


class SwinIR(nn.Module):
    """(B, 3, H, W) in [0, 1], H and W multiples of the window, ->
    (B, 3, 4H, 4W), before any clipping. Arguments by the published names."""

    def __init__(self, embed_dim: int = 180, depths=(6,) * 6, num_heads=(6,) * 6,
                 window_size: int = 8, mlp_ratio: float = 2.0, upscale: int = 4,
                 upsampler: str = "nearest+conv", num_feat: int = 64,
                 resi_connection: str = "1conv"):
        super().__init__()
        if upscale != 4 or upsampler != "nearest+conv" or resi_connection != "1conv":
            raise ValueError("only SwinIR's x4 'nearest+conv' net with '1conv' RSTBs is here")
        self.window = window_size
        self.conv_first = nn.Conv2d(3, embed_dim, 3, 1, 1)
        self.patch_embed = PatchEmbed(embed_dim)
        self.layers = nn.ModuleList(RSTB(embed_dim, d, nh, window_size, mlp_ratio)
                                    for d, nh in zip(depths, num_heads))
        self.norm = LayerNorm(embed_dim)
        self.conv_after_body = nn.Conv2d(embed_dim, embed_dim, 3, 1, 1)
        self.conv_before_upsample = nn.Sequential(nn.Conv2d(embed_dim, num_feat, 3, 1, 1),
                                                  nn.LeakyReLU(inplace=True))
        self.conv_up1 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_up2 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_hr = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_last = nn.Conv2d(num_feat, 3, 3, 1, 1)
        self.lrelu = nn.LeakyReLU(negative_slope=0.2, inplace=True)

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed.norm(x.permute(0, 2, 3, 1))
        for layer in self.layers:
            x = layer(x)
        return self.norm(x).permute(0, 3, 1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = torch.tensor(RGB_MEAN, device=x.device).view(1, 3, 1, 1)
        x = self.conv_first(x - mean)
        x = self.conv_after_body(self.forward_features(x)) + x
        x = self.conv_before_upsample(x)
        x = self.lrelu(self.conv_up1(F.interpolate(x, scale_factor=2, mode="nearest")))
        x = self.lrelu(self.conv_up2(F.interpolate(x, scale_factor=2, mode="nearest")))
        x = self.conv_last(self.lrelu(self.conv_hr(x)))
        return x + mean


def upscale(net: SwinIR, img255: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) in [0, 255] -> (B, 3, 4H, 4W) float32 in [0, 255]: the
    input mirrored at its last rows and columns up to the window (E4S's
    image_infer.py:50-66), the net, the crop back to 4H x 4W, the clip."""
    x = img255.float().permute(0, 3, 1, 2) / 255.0
    h, w = x.shape[-2:]
    hp, wp = -h % net.window, -w % net.window
    x = torch.cat([x, torch.flip(x, [2])], 2)[:, :, :h + hp, :]
    x = torch.cat([x, torch.flip(x, [3])], 3)[:, :, :, :w + wp]
    out = net(x)[:, :, :4 * h, :4 * w]
    return torch.clamp(out * 255.0, 0.0, 255.0)
