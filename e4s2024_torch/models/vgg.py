"""VGG16 feature extractor (frozen) and the masked Gram style loss.

Counterpart of `e4s2024_tpu/models/vgg.py` (reference
criteria/style_loss.py: VGG16_Activations :83, StyleLoss :104: VGG16
activations at chosen torchvision indices, optional image masks, the L2
between Gram matrices). Its weight is 0 by default in training
(train_options.py:58). Parameter names are torchvision's `features.{i}`,
which `e4s2024_tpu/convert/torch_loader.py::convert_vgg16` reads.
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

from e4s2024_torch.ops.resize import resize_bilinear

# torchvision vgg16.features: conv widths, "M" a 2x2 max pool
_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
        512, 512, 512, "M", 512, 512, 512, "M")

VGG_MEAN = (0.485, 0.456, 0.406)
VGG_STD = (0.229, 0.224, 0.225)


class VGG16Features(nn.Module):
    """torchvision's vgg16.features (all 31 layers, so its state dict loads
    strictly), run up to the largest of `taps`; returns the activations
    after the layers at the `taps` indices. NCHW."""

    def __init__(self, taps: tuple = (21,)):
        super().__init__()
        self.taps = tuple(taps)
        layers, cin = [], 3
        for c in _CFG:
            if c == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, c, 3, padding=1), nn.ReLU()]
                cin = c
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        out, last = [], max(self.taps)
        for idx, layer in enumerate(self.features):
            x = layer(x)
            if idx in self.taps:
                out.append(x)
            if idx >= last:
                break
        return out


def gram_matrix(feats: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, C) Gram matrix over (H W C)."""
    b, c, h, w = feats.shape
    f = feats.reshape(b, c, h * w)
    return torch.bmm(f, f.transpose(1, 2)) / (h * w * c)


class StyleGramLoss:
    """Masked Gram-matrix style loss (reference style_loss.py:104-254).

    `state_dict`: torchvision's vgg16 weights (`features.*`; the
    classifier's keys are ignored), tensors or numpy arrays. Called with images
    (B, 3, H, W) in [-1, 1] and optional masks (B, 1, Hm, Wm), all resized
    bilinearly to 256^2; `normalize` maps the images to ImageNet's
    statistics first. The net's tensors are on the CPU: move `model` to
    the images' device."""

    def __init__(self, state_dict: Mapping, taps: tuple = (21,), normalize: bool = False):
        self.model = VGG16Features(taps)
        self.model.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()
                                    if k.startswith("features.")}, strict=True)
        self.model.eval().requires_grad_(False)
        self.normalize = normalize

    def __call__(self, x, x_hat, mask_x=None, mask_x_hat=None) -> torch.Tensor:
        size = (256, 256)
        x, x_hat = resize_bilinear(x, size), resize_bilinear(x_hat, size)
        if self.normalize:
            mean = torch.tensor(VGG_MEAN, device=x.device).view(1, 3, 1, 1)
            std = torch.tensor(VGG_STD, device=x.device).view(1, 3, 1, 1)
            x, x_hat = ((x + 1) / 2 - mean) / std, ((x_hat + 1) / 2 - mean) / std
        if mask_x is not None:
            x = x * resize_bilinear(mask_x, size)
            x_hat = x_hat * resize_bilinear(mask_x_hat, size)
        loss = 0.0
        for a, b in zip(self.model(x), self.model(x_hat)):
            loss = loss + (gram_matrix(a) - gram_matrix(b)).square().mean()
        return loss
