"""BiSeNet face parser, 19 classes (reference
swap_face_fine/face_parsing/model.py:234), inference only.

Counterpart of `e4s2024_tpu/models/bisenet.py` in NCHW, with the reference's
state-dict names (`cp.resnet.*`, `cp.arm16`, `cp.arm32`, `cp.conv_head32`,
`cp.conv_head16`, `cp.conv_avg`, `ffm.*`, `conv_out`, `conv_out16`,
`conv_out32`).

A frozen copy of `e4s2024_torch/models/bisenet.py` for the benchmark's plain
reference: no kernel, no split, no process group; it imports nothing of
the port.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .arcface import FrozenBatchNorm
from .resize import resize_bilinear, resize_nearest


def _conv(cin, cout, ks, stride=1, padding=0):
    return nn.Conv2d(cin, cout, ks, stride, padding, bias=False)


class ConvBNReLU(nn.Module):
    def __init__(self, cin, cout, ks=3, stride=1, padding=1):
        super().__init__()
        self.conv = _conv(cin, cout, ks, stride, padding)
        self.bn = FrozenBatchNorm(cout)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class BasicBlock(nn.Module):
    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv1 = _conv(cin, cout, 3, stride, 1)
        self.bn1 = FrozenBatchNorm(cout)
        self.conv2 = _conv(cout, cout, 3, 1, 1)
        self.bn2 = FrozenBatchNorm(cout)
        self.downsample = None
        if cin != cout or stride != 1:
            self.downsample = nn.Sequential(_conv(cin, cout, 1, stride), FrozenBatchNorm(cout))

    def forward(self, x):
        res = torch.relu(self.bn1(self.conv1(x)))
        res = self.bn2(self.conv2(res))
        sc = x if self.downsample is None else self.downsample(x)
        return torch.relu(sc + res)


def _layer(cin, cout, stride):
    return nn.Sequential(BasicBlock(cin, cout, stride), BasicBlock(cout, cout, 1))


class Resnet18(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = _conv(3, 64, 7, 2, 3)
        self.bn1 = FrozenBatchNorm(64)
        self.layer1 = _layer(64, 64, 1)
        self.layer2 = _layer(64, 128, 2)
        self.layer3 = _layer(128, 256, 2)
        self.layer4 = _layer(256, 512, 2)

    def forward(self, x):
        x = F.max_pool2d(torch.relu(self.bn1(self.conv1(x))), 3, 2, padding=1)
        f8 = self.layer2(self.layer1(x))
        f16 = self.layer3(f8)
        return f8, f16, self.layer4(f16)


class AttentionRefinement(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = ConvBNReLU(cin, cout)
        self.conv_atten = _conv(cout, cout, 1)
        self.bn_atten = FrozenBatchNorm(cout)

    def forward(self, x):
        feat = self.conv(x)
        atten = self.bn_atten(self.conv_atten(feat.mean(dim=(2, 3), keepdim=True)))
        return feat * torch.sigmoid(atten)


class ContextPath(nn.Module):
    def __init__(self):
        super().__init__()
        self.resnet = Resnet18()
        self.arm16 = AttentionRefinement(256, 128)
        self.arm32 = AttentionRefinement(512, 128)
        self.conv_head32 = ConvBNReLU(128, 128)
        self.conv_head16 = ConvBNReLU(128, 128)
        self.conv_avg = ConvBNReLU(512, 128, ks=1, padding=0)

    def forward(self, x):
        f8, f16, f32 = self.resnet(x)
        avg = self.conv_avg(f32.mean(dim=(2, 3), keepdim=True))
        f32_arm = self.arm32(f32) + avg
        f32_up = self.conv_head32(resize_nearest(f32_arm, f16.shape[-2:]))
        f16_arm = self.arm16(f16) + f32_up
        f16_up = self.conv_head16(resize_nearest(f16_arm, f8.shape[-2:]))
        return f8, f16_up, f32_up


class FeatureFusion(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.convblk = ConvBNReLU(cin, cout, ks=1, padding=0)
        self.conv1 = _conv(cout, cout // 4, 1)
        self.conv2 = _conv(cout // 4, cout, 1)

    def forward(self, fsp, fcp):
        feat = self.convblk(torch.cat([fsp, fcp], dim=1))
        atten = feat.mean(dim=(2, 3), keepdim=True)
        atten = torch.sigmoid(self.conv2(torch.relu(self.conv1(atten))))
        return feat * atten + feat


class BiSeNetOutput(nn.Module):
    def __init__(self, cin, mid, n_classes):
        super().__init__()
        self.conv = ConvBNReLU(cin, mid)
        self.conv_out = _conv(mid, n_classes, 1)

    def forward(self, x):
        return self.conv_out(self.conv(x))


class BiSeNet(nn.Module):
    """ResNet-18 context path, attention refinement, feature fusion; the
    spatial path is the res-8 feature (reference model.py:252-254)."""

    def __init__(self, n_classes: int = 19):
        super().__init__()
        self.cp = ContextPath()
        self.ffm = FeatureFusion(256, 256)
        self.conv_out = BiSeNetOutput(256, 256, n_classes)
        self.conv_out16 = BiSeNetOutput(128, 64, n_classes)
        self.conv_out32 = BiSeNetOutput(128, 64, n_classes)

    def forward(self, x, aux: bool = True, upsample: bool = True):
        """x: (B, 3, H, W) normalised. upsample=False returns the main logits
        at 1/8 resolution; aux=False skips the two auxiliary heads."""
        h, w = x.shape[-2:]
        f8, f16_up, f32_up = self.cp(x)
        out = self.conv_out(self.ffm(f8, f16_up))

        def up(o):
            return resize_bilinear(o, (h, w), align_corners=True)

        if not aux:
            return (up(out) if upsample else out), None, None
        return up(out), up(self.conv_out16(f16_up)), up(self.conv_out32(f32_up))


def _bicubic_taps(factor: int, a: float = -0.5) -> np.ndarray:
    size = factor * 4
    xs = (np.arange(size) - np.floor(size / 2) + 0.5) / factor
    ax = np.abs(xs)
    k = np.where(
        ax <= 1.0, (a + 2) * ax ** 3 - (a + 3) * ax ** 2 + 1,
        np.where(ax < 2.0, a * ax ** 3 - 5 * a * ax ** 2 + 8 * a * ax - 4 * a, 0.0))
    return (k / k.sum()).astype(np.float32)


def bicubic_downsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Anti-aliased bicubic downsample of NCHW (reference
    face_parsing_demo.py:15-88): separable 4f-tap filter, stride f, reflect
    padding."""
    if factor == 1:
        return x
    taps = torch.from_numpy(_bicubic_taps(factor)).to(device=x.device, dtype=x.dtype)
    size = taps.numel()
    pad = size - factor
    p0, p1 = pad // 2, pad - pad // 2
    c = x.shape[1]
    x = F.pad(x, [0, 0, p0, p1], mode="reflect")
    x = F.conv2d(x, taps.view(1, 1, size, 1).expand(c, 1, size, 1),
                 stride=(factor, 1), groups=c)
    x = F.pad(x, [p0, p1, 0, 0], mode="reflect")
    return F.conv2d(x, taps.view(1, 1, 1, size).expand(c, 1, 1, size),
                    stride=(1, factor), groups=c)


SEG_MEAN, SEG_STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
