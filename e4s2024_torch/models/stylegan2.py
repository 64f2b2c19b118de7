"""Mask-conditioned StyleGAN2 generator (reference models/stylegan2/model.py).

Counterpart of `e4s2024_tpu/models/stylegan2.py` in NCHW. Module and
parameter names are the reference's state-dict names (`style.{1..8}`,
`input.input`, `conv1`, `to_rgb1`, `convs.{i}`, `to_rgbs.{i}`, and inside
them `conv.weight`, `conv.modulation`, `noise.weight`, `activate.bias`,
`bias`), so reference generator weights load with `load_state_dict`. The
blur and upsample FIR taps are constants of the module, not state.

Latent layout: (B, K, n_latent, 512) per-component W+ codes; layers at or
past `remaining_layer_idx` use component 0 only (reference model.py:685-688).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from e4s2024_torch.ops.fused_act import fused_leaky_relu, scaled_leaky_relu
from e4s2024_torch.ops.modconv import modulated_conv2d, regional_modulated_conv2d
from e4s2024_torch.ops.upfirdn import blur, make_kernel, upsample_2x

BLUR_TAPS = (1, 3, 3, 1)


def channel_schedule(channel_multiplier: int = 2) -> dict[int, int]:
    """StyleGAN2 channels per resolution (reference model.py:512-522)."""
    return {
        4: 512, 8: 512, 16: 512, 32: 512,
        64: 256 * channel_multiplier,
        128: 128 * channel_multiplier,
        256: 64 * channel_multiplier,
        512: 32 * channel_multiplier,
        1024: 16 * channel_multiplier,
    }


def pixel_norm(x: torch.Tensor) -> torch.Tensor:
    """Normalise over the channel axis (reference model.py:15)."""
    return x * torch.rsqrt(torch.mean(x * x, dim=1, keepdim=True) + 1e-8)


class PixelNorm(nn.Module):
    def forward(self, x):
        return pixel_norm(x)


class EqualLinear(nn.Module):
    """Equalized-LR linear (reference model.py:135). Weight (out, in)."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True,
                 bias_init: float = 0.0, lr_mul: float = 1.0,
                 activation: str | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(out_dim, in_dim) / lr_mul)
        self.bias = nn.Parameter(torch.full((out_dim,), float(bias_init))) if bias else None
        self.scale = (1.0 / math.sqrt(in_dim)) * lr_mul
        self.lr_mul = lr_mul
        self.activation = activation

    def forward(self, x):
        out = torch.matmul(x, (self.weight * self.scale).t())
        bias = None if self.bias is None else self.bias * self.lr_mul
        if self.activation == "fused_lrelu":
            return fused_leaky_relu(out, bias)
        return out if bias is None else out + bias


class EqualConv2d(nn.Module):
    """Equalized-LR conv (reference model.py:97). Weight OIHW."""

    def __init__(self, in_channel: int, out_channel: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(
            torch.randn(out_channel, in_channel, kernel_size, kernel_size))
        self.scale = 1.0 / math.sqrt(in_channel * kernel_size ** 2)
        self.stride, self.padding = stride, padding
        self.bias = nn.Parameter(torch.zeros(out_channel)) if bias else None

    def forward(self, x):
        return nn.functional.conv2d(x, self.weight * self.scale, self.bias,
                                    stride=self.stride, padding=self.padding)


class ModulatedConv2d(nn.Module):
    """Style-modulated conv with its modulation MLP (reference model.py:184).
    Weight (1, Cout, Cin, k, k), as the reference stores it."""

    def __init__(self, in_channel: int, out_channel: int, kernel_size: int,
                 style_dim: int = 512, demodulate: bool = True,
                 upsample: bool = False, downsample: bool = False):
        super().__init__()
        self.weight = nn.Parameter(
            torch.randn(1, out_channel, in_channel, kernel_size, kernel_size))
        self.modulation = EqualLinear(style_dim, in_channel, bias_init=1.0)
        self.demodulate, self.upsample, self.downsample = demodulate, upsample, downsample
        self.blur_kernel = make_kernel(BLUR_TAPS)

    def forward(self, x, style, segmap=None, *, regional_mode: str = "exact"):
        """style: (B, 512), or (B, K, 512) with segmap (B, K, Hm, Wm)."""
        weight = self.weight[0]
        if style.ndim == 3:
            if segmap is None:
                raise ValueError("a regional style needs a segmap")
            if self.downsample:
                raise NotImplementedError("regional downsample is not used by E4S")
            b, k, d = style.shape
            s = self.modulation(style.reshape(b * k, d)).reshape(b, k, -1)
            return regional_modulated_conv2d(
                x, weight, s, segmap, demodulate=self.demodulate,
                up=self.upsample, blur_kernel=self.blur_kernel, mode=regional_mode)
        return modulated_conv2d(
            x, weight, self.modulation(style), demodulate=self.demodulate,
            up=self.upsample, down=self.downsample, blur_kernel=self.blur_kernel)


class NoiseInjection(nn.Module):
    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(1))

    def forward(self, x, noise=None):
        return x if noise is None else x + self.weight * noise


class FusedLeakyReLU(nn.Module):
    """Bias + LeakyReLU(0.2) * sqrt(2) (kernel K1)."""

    def __init__(self, channels: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return fused_leaky_relu(x.contiguous(), self.bias)


class StyledConv(nn.Module):
    """ModulatedConv2d + noise + fused LeakyReLU (reference model.py:351).
    With `mask_op` and a (B, K, 512) style the conv is regional."""

    def __init__(self, in_channel: int, out_channel: int, kernel_size: int = 3,
                 style_dim: int = 512, upsample: bool = False,
                 demodulate: bool = True, mask_op: bool = False):
        super().__init__()
        self.conv = ModulatedConv2d(in_channel, out_channel, kernel_size, style_dim,
                                    demodulate=demodulate, upsample=upsample)
        self.noise = NoiseInjection()
        self.activate = FusedLeakyReLU(out_channel)
        self.mask_op = mask_op

    def forward(self, x, style, segmap=None, noise=None, *, regional_mode="exact"):
        if self.mask_op:
            out = self.conv(x, style, segmap, regional_mode=regional_mode)
        else:
            out = self.conv(x, style)
        return self.activate(self.noise(out, noise))


class ToRGB(nn.Module):
    """1x1 modulated conv to RGB plus the upsampled skip (reference
    model.py:426). The masked form always runs the fast regional mode, which
    is exact for a 1x1 kernel."""

    def __init__(self, in_channel: int, style_dim: int = 512, upsample: bool = True,
                 mask_op: bool = False):
        super().__init__()
        self.conv = ModulatedConv2d(in_channel, 3, 1, style_dim, demodulate=False)
        self.bias = nn.Parameter(torch.zeros(1, 3, 1, 1))
        self.mask_op = mask_op
        self.upsample_kernel = make_kernel(BLUR_TAPS)

    def forward(self, x, style, segmap=None, skip=None):
        if self.mask_op:
            out = self.conv(x, style, segmap, regional_mode="fast")
        else:
            out = self.conv(x, style)
        out = out + self.bias
        if skip is not None:
            out = out + upsample_2x(skip.contiguous(), self.upsample_kernel)
        return out


class Blur(nn.Module):
    """FIR blur with explicit pads (reference model.py:78), kernel K2. The
    taps are a constant of the module, not state."""

    def __init__(self, taps, pad: tuple[int, int]):
        super().__init__()
        self.kernel, self.pad = make_kernel(taps), pad

    def forward(self, x):
        return blur(x.contiguous(), self.kernel, self.pad)


class ScaledLeakyReLU(nn.Module):
    def forward(self, x):
        return scaled_leaky_relu(x.contiguous())


class ConvLayer(nn.Sequential):
    """Conv (with a FIR blur and stride 2 when downsampling) and fused
    LeakyReLU (reference model.py:701). As in the reference the layers are
    a Sequential: [Blur,] EqualConv2d, FusedLeakyReLU (K1) or, without a
    bias, ScaledLeakyReLU; the conv has a bias only when not activated."""

    def __init__(self, in_channel: int, out_channel: int, kernel_size: int,
                 downsample: bool = False, bias: bool = True, activate: bool = True):
        layers: list[nn.Module] = []
        if downsample:
            p = (len(BLUR_TAPS) - 2) + (kernel_size - 1)
            layers.append(Blur(BLUR_TAPS, ((p + 1) // 2, p // 2)))
            stride, padding = 2, 0
        else:
            stride, padding = 1, kernel_size // 2
        layers.append(EqualConv2d(in_channel, out_channel, kernel_size, stride=stride,
                                  padding=padding, bias=bias and not activate))
        if activate:
            layers.append(FusedLeakyReLU(out_channel) if bias else ScaledLeakyReLU())
        super().__init__(*layers)


class ResBlock(nn.Module):
    """Residual downsampling block (reference model.py:750): two 3x3
    ConvLayers, the second blurred (K2) and strided, activated by K1, and a
    blurred, strided 1x1 skip without bias; their sum over sqrt(2)."""

    def __init__(self, in_channel: int, out_channel: int):
        super().__init__()
        self.conv1 = ConvLayer(in_channel, in_channel, 3)
        self.conv2 = ConvLayer(in_channel, out_channel, 3, downsample=True)
        self.skip = ConvLayer(in_channel, out_channel, 1, downsample=True, activate=False,
                              bias=False)

    def forward(self, x):
        return (self.conv2(self.conv1(x)) + self.skip(x)) / math.sqrt(2)


class ConstantInput(nn.Module):
    def __init__(self, channel: int, size: int = 4):
        super().__init__()
        self.input = nn.Parameter(torch.randn(1, channel, size, size))

    def forward(self, batch: int):
        return self.input.expand(batch, -1, -1, -1)


class Generator(nn.Module):
    """Mask-conditioned StyleGAN2 generator (reference model.py:482)."""

    def __init__(self, size: int = 1024, style_dim: int = 512, n_mlp: int = 8,
                 channel_multiplier: int = 2, lr_mlp: float = 0.01,
                 split_layer_idx: int = 5, remaining_layer_idx: int = 13):
        super().__init__()
        self.size, self.style_dim = size, style_dim
        self.split_layer_idx = split_layer_idx
        self.remaining_layer_idx = remaining_layer_idx
        self.log_size = int(math.log2(size))
        self.num_layers = (self.log_size - 2) * 2 + 1
        self.n_latent = self.log_size * 2 - 2
        channels = channel_schedule(channel_multiplier)

        self.style = nn.Sequential(PixelNorm(), *[
            EqualLinear(style_dim, style_dim, lr_mul=lr_mlp, activation="fused_lrelu")
            for _ in range(n_mlp)])
        self.input = ConstantInput(channels[4])
        self.conv1 = StyledConv(channels[4], channels[4], 3, style_dim, mask_op=True)
        self.to_rgb1 = ToRGB(channels[4], style_dim, upsample=False, mask_op=True)

        self.convs = nn.ModuleList()
        self.to_rgbs = nn.ModuleList()
        in_ch = channels[4]
        for i in range(3, self.log_size + 1):
            out_ch = channels[2 ** i]
            masked_conv = not i > (2 + remaining_layer_idx // 2)
            masked_rgb = not (remaining_layer_idx != 17
                              and i >= (2 + remaining_layer_idx // 2))
            self.convs.append(StyledConv(in_ch, out_ch, 3, style_dim, upsample=True,
                                         mask_op=masked_conv))
            self.convs.append(StyledConv(out_ch, out_ch, 3, style_dim,
                                         mask_op=masked_conv))
            self.to_rgbs.append(ToRGB(out_ch, style_dim, mask_op=masked_rgb))
            in_ch = out_ch

    def forward(self, latent: torch.Tensor, structure_feats: torch.Tensor | None,
                segmap: torch.Tensor, *, noise: list | None = None,
                use_structure_code: bool = False, regional_mode: str = "exact",
                return_latents: bool = False):
        """latent: (B, K, n_latent, 512); segmap: (B, K, H, W) one-hot at any
        resolution; noise: num_layers (B, 1, res, res) tensors, or None.

        Returns (image NCHW in [-1, 1], latent or None, intermediate feats)."""
        if noise is None:
            noise = [None] * self.num_layers
        out = self.conv1(self.input(latent.shape[0]), latent[:, :, 0], segmap,
                         noise=noise[0], regional_mode=regional_mode)
        skip = self.to_rgb1(out, latent[:, :, 1], segmap)

        intermediate = None
        i = 1
        for j, to_rgb in enumerate(self.to_rgbs):
            conv_a, conv_b = self.convs[2 * j], self.convs[2 * j + 1]
            n1, n2 = noise[2 * j + 1], noise[2 * j + 2]
            if i < self.remaining_layer_idx:
                out = conv_a(out, latent[:, :, i], segmap, noise=n1,
                             regional_mode=regional_mode)
                if i + 2 == self.split_layer_idx:
                    if use_structure_code:
                        out = structure_feats
                    intermediate = out
                out = conv_b(out, latent[:, :, i + 1], segmap, noise=n2,
                             regional_mode=regional_mode)
                if self.remaining_layer_idx == 17 or i + 2 != self.remaining_layer_idx:
                    skip = to_rgb(out, latent[:, :, i + 2], segmap, skip=skip)
                else:
                    skip = to_rgb(out, latent[:, 0, i + 2], skip=skip)
            else:
                out = conv_a(out, latent[:, 0, i], noise=n1)
                out = conv_b(out, latent[:, 0, i + 1], noise=n2)
                skip = to_rgb(out, latent[:, 0, i + 2], skip=skip)
            i += 2
        return skip, (latent if return_latents else None), intermediate


class Discriminator(nn.Module):
    """StyleGAN2 discriminator with minibatch stddev (reference model.py:771;
    `e4s2024_tpu/models/stylegan2.py::Discriminator`). State-dict names are
    the reference's: `convs.0` a 1x1 ConvLayer from RGB, `convs.{1..}`
    ResBlocks down to 4x4, `final_conv`, `final_linear.{0,1}`. A reference
    file's Blur `kernel` buffers go through
    `convert.drop_discriminator_buffers` first.

    The minibatch stddev splits the batch into `min(B, stddev_group)` groups
    of consecutive samples (B must be a multiple of the group), takes each
    feature's population stddev across the groups and appends its mean over
    C, H and W as one channel. The flatten before `final_linear` is NCHW,
    the reference's own.

    Under a process group (`process_group`, which the Coach sets) B is the
    global batch, as in the JAX package's sharded step: the features that
    enter the stddev are gathered from every rank in rank order, through
    an autograd-aware all-gather (differentiable twice, for R1), the
    stddev is taken over the global grouping, and this rank keeps its own
    rows. Every rank must run each forward and each backward together.
    Without a group the forward sees only its own batch."""

    def __init__(self, size: int = 1024, channel_multiplier: int = 2,
                 stddev_group: int = 4):
        super().__init__()
        channels = channel_schedule(channel_multiplier)
        layers: list[nn.Module] = [ConvLayer(3, channels[size], 1)]
        in_ch = channels[size]
        for i in range(int(math.log2(size)), 2, -1):
            layers.append(ResBlock(in_ch, channels[2 ** (i - 1)]))
            in_ch = channels[2 ** (i - 1)]
        self.convs = nn.Sequential(*layers)
        self.stddev_group = stddev_group
        self.process_group = None
        self.final_conv = ConvLayer(in_ch + 1, channels[4], 3)
        self.final_linear = nn.Sequential(
            EqualLinear(channels[4] * 4 * 4, channels[4], activation="fused_lrelu"),
            EqualLinear(channels[4], 1))

    def forward(self, x):
        """x: (B, 3, size, size) in [-1, 1]. Returns (B, 1) logits."""
        out = self.convs(x)
        b, c, h, w = out.shape
        feats, rank = out, 0
        if self.process_group is not None:
            from e4s2024_torch.parallel.ddp import gather_rows_autograd, rank_and_world

            feats = gather_rows_autograd(out, self.process_group)
            rank = rank_and_world(self.process_group)[0]
        n = feats.shape[0]
        group = min(n, self.stddev_group)
        y = feats.reshape(group, n // group, c, h, w)
        stddev = torch.sqrt(y.var(dim=0, unbiased=False) + 1e-8)
        stddev = stddev.mean(dim=(1, 2, 3)).reshape(n // group, 1, 1, 1)
        stddev = stddev.repeat(group, 1, h, w)[rank * b:(rank + 1) * b]
        out = self.final_conv(torch.cat([out, stddev], dim=1))
        return self.final_linear(out.reshape(b, -1))
