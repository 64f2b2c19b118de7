"""Face-parsing U-Net, frozen, for the face-parsing loss (reference
criteria/face_parsing/unet.py:6, feature_scale 4: filters 16-256, 19
classes, transposed-convolution upsampling).

Counterpart of `e4s2024_tpu/models/parser_unet.py` in NCHW, with the names
`convert_parsing_unet` reads: `{conv1..conv4,center}.conv{1,2}.{0,1}` (conv,
BatchNorm), `up_concat{1..4}.up` (a `ConvTranspose2d`, weight (in, out, 2,
2) as torch stores it) and `.conv`, and `final`. The decoder's blocks carry
BatchNorm as the JAX package's do. `extract_feats` returns the 5 encoder
features, flattened in (C, H, W) order and L2-normalised (unet.py:72-93).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from e4s2024_torch.models.arcface import FrozenBatchNorm, l2_normalize
from e4s2024_torch.ops.pool import max_pool2d


class UnetConv2(nn.Module):
    """Two conv -> BatchNorm -> ReLU blocks (model_utils.py:177 `unetConv2`)."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.conv1 = nn.Sequential(nn.Conv2d(in_channels, features, 3, 1, 1),
                                   FrozenBatchNorm(features), nn.ReLU())
        self.conv2 = nn.Sequential(nn.Conv2d(features, features, 3, 1, 1),
                                   FrozenBatchNorm(features), nn.ReLU())

    def forward(self, x):
        return self.conv2(self.conv1(x))


class UnetUp(nn.Module):
    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.up = nn.ConvTranspose2d(in_channels, features, 2, stride=2)
        self.conv = UnetConv2(2 * features, features)

    def forward(self, skip, x):
        x = self.up(x)
        off = x.shape[2] - skip.shape[2]
        if off != 0:
            skip = F.pad(skip, [off // 2] * 4)
        return self.conv(torch.cat([skip, x], dim=1))


class ParsingUNet(nn.Module):
    def __init__(self, n_classes: int = 19, feature_scale: int = 4):
        super().__init__()
        f = [c // feature_scale for c in (64, 128, 256, 512, 1024)]
        self.conv1 = UnetConv2(3, f[0])
        self.conv2 = UnetConv2(f[0], f[1])
        self.conv3 = UnetConv2(f[1], f[2])
        self.conv4 = UnetConv2(f[2], f[3])
        self.center = UnetConv2(f[3], f[4])
        self.up_concat4 = UnetUp(f[4], f[3])
        self.up_concat3 = UnetUp(f[3], f[2])
        self.up_concat2 = UnetUp(f[2], f[1])
        self.up_concat1 = UnetUp(f[1], f[0])
        self.final = nn.Conv2d(f[0], n_classes, 1)

    def _encode(self, x):
        c1 = self.conv1(x)
        c2 = self.conv2(max_pool2d(c1, 2))
        c3 = self.conv3(max_pool2d(c2, 2))
        c4 = self.conv4(max_pool2d(c3, 2))
        return c1, c2, c3, c4, self.center(max_pool2d(c4, 2))

    def forward(self, x):
        """(B, 3, H, W) -> (B, n_classes, H, W) logits."""
        c1, c2, c3, c4, center = self._encode(x)
        up = self.up_concat4(c4, center)
        up = self.up_concat3(c3, up)
        up = self.up_concat2(c2, up)
        return self.final(self.up_concat1(c1, up))

    def extract_feats(self, x) -> list[torch.Tensor]:
        b = x.shape[0]
        return [l2_normalize(t.reshape(b, -1)) for t in self._encode(x)]
