"""RealESRGAN x4plus RRDBNet 64/23/32, plain: a frozen copy of the net of
`e4s2024_torch/models/rrdb.py` and its upscale (reference
realesr/image_infer.py:87)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .resize import resize_nearest


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


class ResidualDenseBlock(nn.Module):
    def __init__(self, num_feat: int = 64, num_grow: int = 32):
        super().__init__()
        for i in range(4):
            setattr(self, f"conv{i + 1}", nn.Conv2d(num_feat + i * num_grow, num_grow, 3, 1, 1))
        self.conv5 = nn.Conv2d(num_feat + 4 * num_grow, num_feat, 3, 1, 1)

    def forward(self, x):
        c = [x]
        for i in range(4):
            c.append(_lrelu(getattr(self, f"conv{i + 1}")(torch.cat(c, 1))))
        return x + 0.2 * self.conv5(torch.cat(c, 1))


class RRDB(nn.Module):
    def __init__(self, num_feat: int = 64, num_grow: int = 32):
        super().__init__()
        self.rdb1 = ResidualDenseBlock(num_feat, num_grow)
        self.rdb2 = ResidualDenseBlock(num_feat, num_grow)
        self.rdb3 = ResidualDenseBlock(num_feat, num_grow)

    def forward(self, x):
        return x + 0.2 * self.rdb3(self.rdb2(self.rdb1(x)))


class RRDBNet(nn.Module):
    """x4 SR net: (B, 3, H, W) in [0, 1] -> (B, 3, 4H, 4W), unclipped."""

    def __init__(self, num_feat: int = 64, num_block: int = 23, num_grow: int = 32):
        super().__init__()
        self.conv_first = nn.Conv2d(3, num_feat, 3, 1, 1)
        self.body = nn.Sequential(*[RRDB(num_feat, num_grow) for _ in range(num_block)])
        self.conv_body = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_up1 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_up2 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_hr = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_last = nn.Conv2d(num_feat, 3, 3, 1, 1)

    def forward(self, x):
        feat = self.conv_first(x)
        feat = feat + self.conv_body(self.body(feat))
        h, w = feat.shape[-2:]
        feat = _lrelu(self.conv_up1(resize_nearest(feat, (2 * h, 2 * w))))
        feat = _lrelu(self.conv_up2(resize_nearest(feat, (4 * h, 4 * w))))
        return self.conv_last(_lrelu(self.conv_hr(feat)))


def upscale(net: RRDBNet, img255: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) in [0, 255] -> (B, 4H, 4W, 3) float32, clip(out x 255)."""
    x = img255.float() / 255.0
    out = net(x.permute(0, 3, 1, 2).contiguous()).permute(0, 2, 3, 1)
    return torch.clamp(out * 255.0, 0, 255)
