"""FAN 68-point facial landmark network (face-alignment's 2DFAN4: stacked
hourglasses over 256 features, 68 heatmaps at a quarter of the input),
inference only.

Counterpart of `e4s2024_tpu/models/fan.py` in NCHW, with face-alignment's
state-dict names (`conv1`, `bn1`, `conv2.downsample.0`/`.2`,
`m{i}.b1_{level}`, `m{i}.b2_plus_1`, `top_m_{i}`, `conv_last{i}`,
`bn_end{i}`, `l{i}`, `bl{i}`, `al{i}`).

Input (B, 3, R, R) RGB in [0, 1]; output a list of (B, 68, R/4, R/4)
heatmaps, one per hourglass module (the last is used).
`heatmaps_to_landmarks` decodes heatmaps to sub-pixel points on the device.
"""

from __future__ import annotations

import torch
from torch import nn

from e4s2024_torch.models.arcface import FrozenBatchNorm
from e4s2024_torch.ops.pool import avg_pool2d
from e4s2024_torch.ops.resize import resize_nearest


def _conv3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, 1, 1, bias=False)


class ConvBlock(nn.Module):
    """Pre-activation 3-branch residual block: bn-relu-conv3x3 at C/2, C/4,
    C/4, concatenated; a bn-relu-conv1x1 shortcut (`downsample.0`/`.2`)
    when the channel count changes."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.bn1 = FrozenBatchNorm(cin)
        self.conv1 = _conv3(cin, cout // 2)
        self.bn2 = FrozenBatchNorm(cout // 2)
        self.conv2 = _conv3(cout // 2, cout // 4)
        self.bn3 = FrozenBatchNorm(cout // 4)
        self.conv3 = _conv3(cout // 4, cout // 4)
        self.downsample = None
        if cin != cout:
            self.downsample = nn.Sequential(FrozenBatchNorm(cin), nn.ReLU(),
                                            nn.Conv2d(cin, cout, 1, bias=False))

    def forward(self, x):
        o1 = self.conv1(torch.relu(self.bn1(x)))
        o2 = self.conv2(torch.relu(self.bn2(o1)))
        o3 = self.conv3(torch.relu(self.bn3(o2)))
        res = x if self.downsample is None else self.downsample(x)
        return torch.cat([o1, o2, o3], dim=1) + res


class HourGlass(nn.Module):
    """Recursive hourglass of `depth` levels."""

    def __init__(self, depth: int, features: int):
        super().__init__()
        self.depth = depth
        for level in range(1, depth + 1):
            for name in ("b1", "b2", "b3"):
                self.add_module(f"{name}_{level}", ConvBlock(features, features))
        self.b2_plus_1 = ConvBlock(features, features)

    def _level(self, n: int, inp):
        up1 = getattr(self, f"b1_{n}")(inp)
        low = getattr(self, f"b2_{n}")(avg_pool2d(inp, 2, 2))
        low = self._level(n - 1, low) if n > 1 else self.b2_plus_1(low)
        low = getattr(self, f"b3_{n}")(low)
        return up1 + resize_nearest(low, up1.shape[-2:])

    def forward(self, x):
        return self._level(self.depth, x)


class FAN(nn.Module):
    """Stacked-hourglass landmark net (face-alignment FAN / 2DFAN4)."""

    def __init__(self, num_modules: int = 4, features: int = 256,
                 num_landmarks: int = 68, depth: int = 4):
        super().__init__()
        f = features
        self.num_modules = num_modules
        self.conv1 = nn.Conv2d(3, f // 4, 7, 2, 3)
        self.bn1 = FrozenBatchNorm(f // 4)
        self.conv2 = ConvBlock(f // 4, f // 2)
        self.conv3 = ConvBlock(f // 2, f // 2)
        self.conv4 = ConvBlock(f // 2, f)
        for i in range(num_modules):
            self.add_module(f"m{i}", HourGlass(depth, f))
            self.add_module(f"top_m_{i}", ConvBlock(f, f))
            self.add_module(f"conv_last{i}", nn.Conv2d(f, f, 1))
            self.add_module(f"bn_end{i}", FrozenBatchNorm(f))
            self.add_module(f"l{i}", nn.Conv2d(f, num_landmarks, 1))
            if i < num_modules - 1:
                self.add_module(f"bl{i}", nn.Conv2d(f, f, 1))
                self.add_module(f"al{i}", nn.Conv2d(num_landmarks, f, 1))

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        x = avg_pool2d(self.conv2(x), 2, 2)
        x = self.conv4(self.conv3(x))
        outputs, previous = [], x
        for i in range(self.num_modules):
            ll = getattr(self, f"top_m_{i}")(getattr(self, f"m{i}")(previous))
            ll = torch.relu(getattr(self, f"bn_end{i}")(getattr(self, f"conv_last{i}")(ll)))
            out = getattr(self, f"l{i}")(ll)
            outputs.append(out)
            if i < self.num_modules - 1:
                previous = previous + getattr(self, f"bl{i}")(ll) + getattr(self, f"al{i}")(out)
        return outputs


def heatmaps_to_landmarks(hm: torch.Tensor) -> torch.Tensor:
    """(B, K, H, W) heatmaps -> (B, K, 2) sub-pixel (x, y) in heatmap pixels
    (0-based): the first maximal index, moved 0.25 towards the larger
    neighbour on each axis (face-alignment's `get_preds_fromhm`); peaks on
    the border are not moved."""
    b, k, h, w = hm.shape
    flat = hm.reshape(b, k, h * w)
    idx = torch.argmax(flat, dim=-1)  # the first maximal index
    px, py = idx % w, idx // w

    def at(dy, dx):
        yy = torch.clamp(py + dy, 0, h - 1)
        xx = torch.clamp(px + dx, 0, w - 1)
        return torch.gather(flat, -1, (yy * w + xx)[..., None])[..., 0]

    interior = ((px > 0) & (px < w - 1) & (py > 0) & (py < h - 1)).float()
    dx = torch.sign(at(0, 1) - at(0, -1)) * 0.25 * interior
    dy = torch.sign(at(1, 0) - at(-1, 0)) * 0.25 * interior
    return torch.stack([px + dx, py + dy], dim=-1)
