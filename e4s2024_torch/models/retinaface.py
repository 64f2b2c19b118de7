"""RetinaFace face detector (reference
swap_face_fine/gpen/face_detect/facemodels/retinaface.py:48 `RetinaFace`,
net.py:9-136), inference only.

Counterpart of `e4s2024_tpu/models/retinaface.py` in NCHW, with the
reference's state-dict names (`body.stage1.0.0`, `body.layer1.0.conv1`,
`fpn.output1.0`, `ssh1.conv3X3.0`, `ssh1.conv7x7_3.0`,
`ClassHead.{i}.conv1x1`, `BboxHead.{i}.conv1x1`, `LandmarkHead.{i}.conv1x1`):
a MobileNetV1-0.25 or ResNet-50 backbone, a 3-level FPN, SSH context modules
and per-level 1x1 heads with 2 anchors a cell.

The input is RGB in [0, 255], as in the JAX package: the reference's
checkpoints are trained on BGR minus (104, 117, 123), and
`e4s2024_torch.convert.fold_bgr_mean_into_stem` folds both into the stem.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from e4s2024_torch.models.arcface import FrozenBatchNorm
from e4s2024_torch.models.hopenet import Bottleneck
from e4s2024_torch.ops.pool import max_pool2d
from e4s2024_torch.ops.resize import resize_nearest

# anchor and variance settings (reference data/config.py cfg_mnet / cfg_re50)
CFG_MNET = {
    "backbone": "mobilenet",
    "min_sizes": ((16, 32), (64, 128), (256, 512)),
    "steps": (8, 16, 32),
    "variance": (0.1, 0.2),
    "in_channel": 32,
    "out_channel": 64,
}
CFG_RE50 = {
    "backbone": "resnet50",
    "min_sizes": ((16, 32), (64, 128), (256, 512)),
    "steps": (8, 16, 32),
    "variance": (0.1, 0.2),
    "in_channel": 256,
    "out_channel": 256,
}


def conv_bn(cin: int, cout: int, ks: int = 3, stride: int = 1, leaky: float = 0.0,
            relu: bool = True, groups: int = 1) -> nn.Sequential:
    """The reference's conv_bn / conv_bn1X1 / conv_bn_no_relu (net.py:9-27):
    `0` conv without bias, `1` BN, then LeakyReLU(leaky) unless `relu` is
    off (the JAX package's ConvBNLeaky)."""
    layers = [nn.Conv2d(cin, cout, ks, stride, (ks - 1) // 2, groups=groups, bias=False),
              FrozenBatchNorm(cout)]
    if relu:
        layers.append(nn.LeakyReLU(leaky))
    return nn.Sequential(*layers)


def conv_dw(cin: int, cout: int, stride: int = 1, leaky: float = 0.1) -> nn.Sequential:
    """Depthwise-separable block (net.py:29-38): `0`/`1` the depthwise
    conv and its BN, `3`/`4` the pointwise conv and its BN (ConvDW)."""
    return nn.Sequential(*conv_bn(cin, cin, 3, stride, leaky, groups=cin),
                         *conv_bn(cin, cout, 1, 1, leaky))


class MobileNetV1Backbone(nn.Module):
    """MobileNetV1 x0.25, three stages (net.py:102-124); returns the
    stride-8, 16 and 32 features (64, 128, 256 channels)."""

    def __init__(self):
        super().__init__()
        self.stage1 = nn.Sequential(
            conv_bn(3, 8, 3, 2, 0.1),
            *[conv_dw(i, o, s) for i, o, s in
              ((8, 16, 1), (16, 32, 2), (32, 32, 1), (32, 64, 2), (64, 64, 1))])
        self.stage2 = nn.Sequential(conv_dw(64, 128, 2), *[conv_dw(128, 128) for _ in range(5)])
        self.stage3 = nn.Sequential(conv_dw(128, 256, 2), conv_dw(256, 256))

    def forward(self, x):
        f1 = self.stage1(x)
        f2 = self.stage2(f1)
        return f1, f2, self.stage3(f2)


class ResNet50Backbone(nn.Module):
    """torchvision resnet50 trunk returning layer2/3/4 (512, 1024, 2048
    channels; reference retinaface.py:68-72 with cfg_re50's return_layers)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        cin = 64
        for li, (planes, blocks) in enumerate(((64, 3), (128, 4), (256, 6), (512, 3))):
            layer = []
            for b in range(blocks):
                layer.append(Bottleneck(cin, planes, 2 if (li > 0 and b == 0) else 1,
                                        downsample=b == 0))
                cin = planes * 4
            self.add_module(f"layer{li + 1}", nn.Sequential(*layer))

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        x = self.layer1(max_pool2d(x, 3, 2, padding=1))
        f1 = self.layer2(x)
        f2 = self.layer3(f1)
        return f1, f2, self.layer4(f2)


class SSH(nn.Module):
    """Context module (net.py:40-66), with the reference's mixed-case names."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        leaky = 0.1 if cout <= 64 else 0.0
        self.conv3X3 = conv_bn(cin, cout // 2, relu=False)
        self.conv5X5_1 = conv_bn(cin, cout // 4, leaky=leaky)
        self.conv5X5_2 = conv_bn(cout // 4, cout // 4, relu=False)
        self.conv7X7_2 = conv_bn(cout // 4, cout // 4, leaky=leaky)
        self.conv7x7_3 = conv_bn(cout // 4, cout // 4, relu=False)

    def forward(self, x):
        c3 = self.conv3X3(x)
        c5_1 = self.conv5X5_1(x)
        c5 = self.conv5X5_2(c5_1)
        c7 = self.conv7x7_3(self.conv7X7_2(c5_1))
        return torch.relu(torch.cat([c3, c5, c7], dim=1))


class FPN(nn.Module):
    """3-level FPN with nearest upsampling (net.py:68-98)."""

    def __init__(self, in_channels: tuple[int, int, int], cout: int):
        super().__init__()
        leaky = 0.1 if cout <= 64 else 0.0
        for i, cin in enumerate(in_channels):
            self.add_module(f"output{i + 1}", conv_bn(cin, cout, 1, leaky=leaky))
        self.merge1 = conv_bn(cout, cout, leaky=leaky)
        self.merge2 = conv_bn(cout, cout, leaky=leaky)

    def forward(self, f1, f2, f3):
        o1, o2, o3 = self.output1(f1), self.output2(f2), self.output3(f3)
        o2 = self.merge2(o2 + resize_nearest(o3, o2.shape[-2:]))
        o1 = self.merge1(o1 + resize_nearest(o2, o1.shape[-2:]))
        return o1, o2, o3


class _Head(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1x1 = nn.Conv2d(cin, cout, 1)

    def forward(self, x):
        return self.conv1x1(x)


class RetinaFace(nn.Module):
    """The detector. Input (B, 3, H, W) RGB float in [0, 255]. Returns
    (loc (B, N, 4), conf (B, N, 2) softmaxed, landms (B, N, 10)) with
    N = sum over levels of 2 * ceil(H / step) * ceil(W / step), rows ordered
    (level, h, w, anchor) as the reference's priors are."""

    def __init__(self, cfg: dict = CFG_MNET, num_anchors: int = 2):
        super().__init__()
        if cfg["backbone"] == "mobilenet":
            self.body = MobileNetV1Backbone()
        elif cfg["backbone"] == "resnet50":
            self.body = ResNet50Backbone()
        else:
            raise ValueError(f"unknown backbone {cfg['backbone']!r}")
        c, out = cfg["in_channel"], cfg["out_channel"]
        self.fpn = FPN((c * 2, c * 4, c * 8), out)
        for i in range(3):
            self.add_module(f"ssh{i + 1}", SSH(out, out))
        self.ClassHead = nn.ModuleList(_Head(out, num_anchors * 2) for _ in range(3))
        self.BboxHead = nn.ModuleList(_Head(out, num_anchors * 4) for _ in range(3))
        self.LandmarkHead = nn.ModuleList(_Head(out, num_anchors * 10) for _ in range(3))

    def forward(self, x):
        feats = self.fpn(*self.body(x))
        feats = [self.ssh1(feats[0]), self.ssh2(feats[1]), self.ssh3(feats[2])]
        b = x.shape[0]

        def heads(mods, k):
            # (B, A*k, h, w) -> rows ordered (h, w, anchor), the reference's
            # permute(0, 2, 3, 1).view(B, -1, k)
            return torch.cat([m(f).permute(0, 2, 3, 1).reshape(b, -1, k)
                              for m, f in zip(mods, feats)], dim=1)

        loc = heads(self.BboxHead, 4)
        conf = torch.softmax(heads(self.ClassHead, 2), dim=-1)
        return loc, conf, heads(self.LandmarkHead, 10)


def generate_priors(image_hw: tuple[int, int], cfg: dict = CFG_MNET) -> np.ndarray:
    """(N, 4) anchors in normalised (cx, cy, w, h) (reference
    layers/functions/prior_box.py:7-35 `PriorBox`)."""
    h, w = image_hw
    anchors = []
    for min_sizes, step in zip(cfg["min_sizes"], cfg["steps"]):
        fh, fw = math.ceil(h / step), math.ceil(w / step)
        ji, ii = np.meshgrid(np.arange(fw), np.arange(fh))  # (fh, fw)
        cx = (ji + 0.5) * step / w
        cy = (ii + 0.5) * step / h
        for_level = [np.stack([cx, cy, np.full_like(cx, ms / w, dtype=np.float64),
                               np.full_like(cy, ms / h, dtype=np.float64)], axis=-1)
                     for ms in min_sizes]
        # (fh, fw, A, 4) -> rows ordered (h, w, anchor)
        anchors.append(np.stack(for_level, axis=2).reshape(-1, 4))
    return np.concatenate(anchors, axis=0).astype(np.float32)


def decode_boxes(loc: torch.Tensor, priors: torch.Tensor, variance=(0.1, 0.2)) -> torch.Tensor:
    """(..., N, 4) regressions -> (x1, y1, x2, y2) normalised boxes
    (reference utils/box_utils.py:209-227 `decode`)."""
    cxy = priors[..., :2] + loc[..., :2] * variance[0] * priors[..., 2:]
    wh = priors[..., 2:] * torch.exp(loc[..., 2:] * variance[1])
    tl = cxy - wh / 2.0
    return torch.cat([tl, tl + wh], dim=-1)


def decode_landms(pre: torch.Tensor, priors: torch.Tensor, variance=(0.1, 0.2)) -> torch.Tensor:
    """(..., N, 10) regressions -> (..., N, 5, 2) normalised landmark points
    (reference utils/box_utils.py:229-247 `decode_landm`)."""
    p = pre.reshape(*pre.shape[:-1], 5, 2)
    return priors[..., None, :2] + p * variance[0] * priors[..., None, 2:]
