"""Frozen BatchNorm (counterpart of `FrozenBatchNorm` in
`e4s2024_tpu/models/arcface.py`); the ArcFace backbone waits for the
training slice."""

from __future__ import annotations

import torch
from torch import nn


class FrozenBatchNorm(nn.Module):
    """Inference-mode BatchNorm2d on stored running statistics, with the
    reference's state-dict names (`weight`, `bias`, `running_mean`,
    `running_var`)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.ndim - 2)
        scale = self.weight / torch.sqrt(self.running_var + self.eps)
        out = (x - self.running_mean.view(shape)) * scale.view(shape)
        return out + self.bias.view(shape)
