"""ArcFace IR-SE-50 backbone, frozen, for the ID loss (reference
models/encoders/model_irse.py:9 `Backbone`, with the BatchNorm-flavoured
IR-SE units of helpers.py:97).

Counterpart of `e4s2024_tpu/models/arcface.py` in NCHW, with the
reference's state-dict names (`input_layer.{0,1,2}`,
`body.{i}.res_layer.{0..5}`, `body.{i}.shortcut_layer.{0,1}`,
`output_layer.{0,3,4}`), the ones `convert_arcface` reads. Inference only:
BatchNorm on stored statistics, Dropout the identity. Multi-scale taps
after units 2, 6, 20 and 23 and the final embedding, each L2-normalised
(model_irse.py:44-69); a tap flattens in (C, H, W) order, which the JAX
package's NHWC flatten permutes (the cosine losses are unchanged by it).

A frozen copy of `e4s2024_torch/models/arcface.py` for the benchmark's plain
reference: no kernel, no split, no process group; it imports nothing of
the port.
"""

from __future__ import annotations

import torch
from torch import nn

from .encoders import SEModule


class FrozenBatchNorm(nn.Module):
    """Inference-mode BatchNorm2d on stored running statistics, with the
    reference's state-dict names (`weight`, `bias`, `running_mean`,
    `running_var`); it also serves (N, C) input as BatchNorm1d."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def init_rules(self):
        return {"weight": ("const", 1.0), "bias": ("const", 0.0),
                "running_mean": ("const", 0.0), "running_var": ("const", 1.0)}

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.ndim - 2)
        scale = self.weight / torch.sqrt(self.running_var + self.eps)
        out = (x - self.running_mean.view(shape)) * scale.view(shape)
        return out + self.bias.view(shape)



def l2_normalize(x: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """torch-style l2_norm over the last axis (reference helpers.py:15). The
    norm accumulates in float64: the loss nets' flattened features run to
    4M elements, over which a float32 sum drifts by about 3e-5."""
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True, dtype=torch.float64)
    return x / (norm.to(x.dtype) + eps)


def arcface_body_plan() -> list[tuple[int, int]]:
    """(depth, stride) per unit, num_layers=50 (reference helpers.py:30-36)."""
    plan: list[tuple[int, int]] = []
    for depth, num in ((64, 3), (128, 4), (256, 14), (512, 3)):
        plan.append((depth, 2))
        plan.extend((depth, 1) for _ in range(num - 1))
    return plan


class BottleneckIRSEBN(nn.Module):
    """IR-SE unit, BatchNorm flavour (reference helpers.py:97
    `bottleneck_IR_SE`)."""

    def __init__(self, in_channel: int, depth: int, stride: int):
        super().__init__()
        if in_channel == depth:
            self.shortcut_layer = nn.MaxPool2d(1, stride)
        else:
            self.shortcut_layer = nn.Sequential(
                nn.Conv2d(in_channel, depth, 1, stride, bias=False), FrozenBatchNorm(depth))
        self.res_layer = nn.Sequential(
            FrozenBatchNorm(in_channel),
            nn.Conv2d(in_channel, depth, 3, 1, 1, bias=False),
            nn.PReLU(depth),
            nn.Conv2d(depth, depth, 3, stride, 1, bias=False),
            FrozenBatchNorm(depth),
            SEModule(depth, 16),
        )

    def forward(self, x):
        return self.res_layer(x) + self.shortcut_layer(x)


class ArcFaceBackbone(nn.Module):
    """IR-SE-50 face recognition backbone: 112x112 input, 512-d embedding."""

    def __init__(self, taps: tuple[int, ...] = (2, 6, 20, 23)):
        super().__init__()
        self.taps = taps
        self.input_layer = nn.Sequential(
            nn.Conv2d(3, 64, 3, 1, 1, bias=False), FrozenBatchNorm(64), nn.PReLU(64))
        units, in_ch = [], 64
        for depth, stride in arcface_body_plan():
            units.append(BottleneckIRSEBN(in_ch, depth, stride))
            in_ch = depth
        self.body = nn.Sequential(*units)
        self.output_layer = nn.Sequential(
            FrozenBatchNorm(512), nn.Identity(), nn.Flatten(),
            nn.Linear(512 * 7 * 7, 512), FrozenBatchNorm(512))

    def forward(self, x, multi_scale: bool = False) -> list[torch.Tensor]:
        """x: (B, 3, 112, 112) in [-1, 1]. Returns the L2-normalised taps and
        embedding with `multi_scale`, else [embedding]."""
        b = x.shape[0]
        x = self.input_layer(x)
        tapped = []
        for i, unit in enumerate(self.body):
            x = unit(x)
            if multi_scale and i in self.taps:
                tapped.append(l2_normalize(x.reshape(b, -1)))
        return tapped + [l2_normalize(self.output_layer(x))]
