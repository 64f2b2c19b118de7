"""The torchvision ResNet-50 Bottleneck (counterpart of `Bottleneck` in
`e4s2024_tpu/models/hopenet.py`), with torchvision's state-dict names
(`conv1`, `bn1`, ..., `downsample.0`, `downsample.1`). RetinaFace's ResNet-50
backbone is built from it; Hopenet itself waits for the reenactment slice.
"""

from __future__ import annotations

import torch
from torch import nn

from e4s2024_torch.models.arcface import FrozenBatchNorm


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride here, torchvision v1.5) -> 1x1 x4, BN after each,
    projection shortcut when `downsample`."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm(planes * 4)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes * 4, 1, stride, bias=False),
                FrozenBatchNorm(planes * 4))

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        sc = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + sc)
