"""Hopenet head-pose estimator (reference head_pose_esit/hopenet.py:7), frozen.

Counterpart of `e4s2024_tpu/models/hopenet.py` in NCHW: a torchvision
ResNet-50 with three binned-angle heads (`fc_yaw`, `fc_pitch`, `fc_roll`,
66 bins of 3 degrees; angle = E[softmax] * 3 - 99), which gates reenactment
on the source/target pose gap (reference Face_swap_with_two_imgs.py:117,
688-700). State-dict names are the reference's (`conv1`, `bn1`,
`layer{1..4}.{i}.*`, `fc_*`); its vestigial `fc_finetune` is dropped on
load, as the JAX converter drops it.

`Bottleneck` is torchvision's, with its names (`conv1`, `bn1`, ...,
`downsample.0`, `downsample.1`); RetinaFace's and DaGAN's ResNet-50s are
built from it too.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from e4s2024_torch import resolve_device
from e4s2024_torch.convert import as_tensors, strip_module_prefix
from e4s2024_torch.models.arcface import FrozenBatchNorm
from e4s2024_torch.ops.pool import max_pool2d
from e4s2024_torch.ops.resize import resize_bilinear

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


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


def resnet_layers(layers) -> list[nn.Sequential]:
    """torchvision ResNet-50's `layer1..4` of Bottlenecks over a 64-channel
    stem; each layer's first block projects (and, past layer1, strides)."""
    out, inplanes = [], 64
    for li, (planes, n) in enumerate(zip((64, 128, 256, 512), layers)):
        blocks = []
        for bi in range(n):
            stride = 2 if (li > 0 and bi == 0) else 1
            blocks.append(Bottleneck(inplanes, planes, stride, downsample=bi == 0))
            inplanes = planes * 4
        out.append(nn.Sequential(*blocks))
    return out


class Hopenet(nn.Module):
    """ResNet-50 + yaw/pitch/roll bin heads. forward: (B, 3, 224, 224)
    ImageNet-normalised -> three (B, num_bins) logit tensors."""

    def __init__(self, num_bins: int = 66, layers=(3, 4, 6, 3)):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        self.layer1, self.layer2, self.layer3, self.layer4 = resnet_layers(layers)
        self.fc_yaw = nn.Linear(2048, num_bins)
        self.fc_pitch = nn.Linear(2048, num_bins)
        self.fc_roll = nn.Linear(2048, num_bins)

    def forward(self, x):
        x = max_pool2d(torch.relu(self.bn1(self.conv1(x))), 3, 2, padding=1)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        x = x.mean(dim=(2, 3))
        return self.fc_yaw(x), self.fc_pitch(x), self.fc_roll(x)


def bins_to_degrees(logits: torch.Tensor) -> torch.Tensor:
    """Softmax expectation over the 66 bins, x 3 - 99 degrees."""
    idx = torch.arange(logits.shape[-1], dtype=torch.float32, device=logits.device)
    return torch.sum(torch.softmax(logits.float(), -1) * idx, -1) * 3.0 - 99.0


def hopenet_state_dict(state_dict: Mapping) -> dict[str, torch.Tensor]:
    """A Hopenet state dict (reference file or
    `convert.hopenet_state_dict_from_jax`) for a strict load: `module.`
    stripped, `fc_finetune` and BatchNorm counters dropped."""
    return as_tensors({k: v for k, v in strip_module_prefix(state_dict).items()
                       if not k.startswith("fc_finetune.")
                       and not k.endswith("num_batches_tracked")})


class PoseEstimator:
    """Euler angles of aligned face crops and the pose-gap gate."""

    def __init__(self, state_dict: Mapping, *, layers=(3, 4, 6, 3), device=None):
        self.device = resolve_device(device)
        self.model = Hopenet(layers=layers)
        self.model.load_state_dict(hopenet_state_dict(state_dict), strict=True)
        self.model.eval().requires_grad_(False).to(self.device)
        self.mean = torch.tensor(IMAGENET_MEAN, device=self.device).view(1, 3, 1, 1)
        self.std = torch.tensor(IMAGENET_STD, device=self.device).view(1, 3, 1, 1)

    def _tensor(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(self.device)

    @torch.inference_mode()
    def estimate(self, img255) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(B, H, W, 3) in [0, 255] -> (yaw, pitch, roll), each (B,) degrees.
        Crops are resized bilinearly (no antialias) to 224^2."""
        x = self._tensor(img255).float().permute(0, 3, 1, 2) / 255.0
        x = resize_bilinear(x, (224, 224))
        y, p, r = self.model((x - self.mean) / self.std)
        return bins_to_degrees(y), bins_to_degrees(p), bins_to_degrees(r)

    def pose_gaps(self, img_a255, img_b255) -> torch.Tensor:
        """(B,) per pair: the largest of |d yaw|, |d pitch|, |d roll| (reference
        Face_swap_with_two_imgs.py:688-700). Both batches run as one forward."""
        a, b = self._tensor(img_a255), self._tensor(img_b255)
        angles = torch.stack(self.estimate(torch.cat([a, b])))  # (3, 2B)
        n = a.shape[0]
        return (angles[:, :n] - angles[:, n:]).abs().amax(0)

    def pose_gap(self, img_a255, img_b255) -> float:
        """The gate's gap for one pair (or the largest over a batch), as a
        Python float: one host synchronisation."""
        return float(self.pose_gaps(img_a255, img_b255).max())
