"""RealESRGAN x4 super-resolution, RRDBNet (reference
swap_face_fine/realesr/image_infer.py:39: RRDBNet(3, 3, 64, 23, 32,
scale=4); it brings the 256^2 Blender recolor back to 1024^2,
Face_swap_with_two_imgs.py:533).

Counterpart of `e4s2024_tpu/models/rrdb.py` in NCHW, with basicsr's
state-dict names (`conv_first`, `body.{i}.rdb{1,2,3}.conv{1..5}`,
`conv_body`, `conv_up1`, `conv_up2`, `conv_hr`, `conv_last`). Residual-in-
residual dense blocks with 0.2 residual scaling, then two nearest x2
upsamples each followed by a conv. Plain cuDNN convolutions: the JAX
package runs no Pallas kernel here.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from e4s2024_torch import resolve_device
from e4s2024_torch.convert import as_tensors, strip_module_prefix, unwrap_envelope
from e4s2024_torch.ops.resize import resize_nearest


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


class RealESRGANUpscaler:
    """x4 upscale of [0, 255] images (the reference's RealESRBatchInfer,
    realesr/image_infer.py:87). A reference file's `params_ema` (or
    `params`) envelope is opened; every other key loads strictly.
    `fused_form`: see `models/gpen.py::GPENEnhancer`."""

    fused_form = True

    def __init__(self, state_dict: Mapping, *, num_feat: int = 64, num_block: int = 23,
                 num_grow: int = 32, device=None):
        self.device = resolve_device(device)
        self.model = RRDBNet(num_feat, num_block, num_grow)
        sd = strip_module_prefix(unwrap_envelope(state_dict, "params_ema", "params"))
        self.model.load_state_dict(as_tensors(sd), strict=True)
        self.model.to(self.device).eval().requires_grad_(False)

    def forward(self, x01: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) in [0, 1] -> (B, 4H, 4W, 3) float32, unclipped."""
        with torch.inference_mode():
            return self.model(x01.permute(0, 3, 1, 2).contiguous()).permute(0, 2, 3, 1)

    def upscale(self, img255) -> torch.Tensor:
        """(B, H, W, 3) in [0, 255] -> (B, 4H, 4W, 3) float32, clip(out x 255)."""
        x = torch.as_tensor(img255).to(self.device, torch.float32) / 255.0
        return torch.clamp(self.forward(x) * 255.0, 0, 255)
