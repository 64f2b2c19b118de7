"""MISF inpainting, Multi-level Interactive Siamese Filtering (reference
swap_face_fine/MISF/src/networks.py:35 `InpaintGenerator`, kpn/network.py:83
`KPN` and :170 `KernelConv`, run by MISF/inpainting.py:46
`inpainting_face`): an alternative face inpainter to GCFSR (the reference
ships no public MISF checkpoint).

Counterpart of `e4s2024_tpu/models/misf.py` in NCHW, with the reference's
state-dict names (`encoder{0,1,2}`, `middle.{i}.conv_block`, `decoder`,
`kpn_model.conv{1,2,3,4,7,8,9}.conv1`, `kpn_model.kernels`,
`kpn_model.core_img`). An encoder, dilated resblocks and a decoder whose
features are refreshed by predictive filtering: a kernel-prediction U-Net
predicts per-pixel 3x3 kernels, applied depthwise to the 1/4-resolution
features and to the output image. Like the JAX package, each predicted
kernel set is repeated over a group of feature channels (the reference
resizes the flattened kernel axis instead; the two agree when there are as
many kernel sets as feature channels, the default). Plain cuDNN
convolutions: the JAX package runs no Pallas kernel here.
"""

from __future__ import annotations

import re
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from e4s2024_torch import resolve_device
from e4s2024_torch.convert import as_tensors, strip_module_prefix, unwrap_envelope
from e4s2024_torch.models.encoders import InstanceNorm
from e4s2024_torch.ops.resize import resize_bilinear

# a head the reference's KPN builds and its forward never runs
_UNUSED = re.compile(r"^kpn_model\.conv_final\.")


def per_pixel_filter(x: torch.Tensor, kernels: torch.Tensor, ksize: int = 3) -> torch.Tensor:
    """Spatially varying depthwise filter (reference KernelConv,
    network.py:216): x (B, C, H, W), kernels (B, C, ksize^2, H, W) in
    row-major tap order, zero padding."""
    p = ksize // 2
    xp = F.pad(x, (p, p, p, p))
    h, w = x.shape[2:]
    out = None
    for t in range(ksize * ksize):
        i, j = divmod(t, ksize)
        term = xp[:, :, i:i + h, j:j + w] * kernels[:, :, t]
        out = term if out is None else out + term
    return out


class _Basic(nn.Module):
    """KPN `Basic` (kpn/network.py:35): three 3x3 conv + ReLU."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = nn.Sequential(nn.Conv2d(cin, cout, 3, padding=1), nn.ReLU(),
                                   nn.Conv2d(cout, cout, 3, padding=1), nn.ReLU(),
                                   nn.Conv2d(cout, cout, 3, padding=1), nn.ReLU())

    def forward(self, x):
        return self.conv1(x)


class KPN(nn.Module):
    """The kernel-prediction U-Net (kpn/network.py:83-168, default options):
    the 4-channel masked input and the generator's 128-channel 1/2-resolution
    feature -> (feature kernels (B, feat_channels, 9, H/4, W/4), image kernels
    (B, 3, 9, H, W))."""

    def __init__(self, num_kernels: int = 256, feat_channels: int = 256):
        super().__init__()
        if feat_channels % num_kernels:
            raise ValueError("num_kernels must divide feat_channels")
        self.num_kernels, self.feat_channels = num_kernels, feat_channels
        self.conv1, self.conv2, self.conv3 = _Basic(4, 64), _Basic(64, 128), _Basic(256, 256)
        self.kernels = nn.Conv2d(256, num_kernels * 9, 1)
        self.conv4, self.conv7 = _Basic(256, 512), _Basic(768, 256)
        self.conv8, self.conv9 = _Basic(512, 128), _Basic(192, 64)
        self.core_img = nn.Conv2d(64, 27, 1)

    def forward(self, inp4, feat128):
        c1 = self.conv1(inp4)
        c2 = torch.cat([self.conv2(F.avg_pool2d(c1, 2)), feat128], 1)
        c3 = self.conv3(F.avg_pool2d(c2, 2))
        k = self.kernels(c3)
        b, _, h4, w4 = k.shape
        k = k.reshape(b, self.num_kernels, 9, h4, w4).repeat_interleave(
            self.feat_channels // self.num_kernels, dim=1)
        c7 = self.conv7(torch.cat([c3, self.conv4(c3)], 1))
        c8 = self.conv8(torch.cat([c2, resize_bilinear(c7, tuple(c2.shape[2:]))], 1))
        c9 = self.conv9(torch.cat([c1, resize_bilinear(c8, tuple(c1.shape[2:]))], 1))
        ki = self.core_img(c9)
        return k, ki.reshape(b, 3, 9, *ki.shape[2:])


class _ResnetBlockD2(nn.Module):
    """InpaintGenerator residual block (networks.py:210): dilated 3x3 and
    plain 3x3, reflect padding, InstanceNorm without affine."""

    def __init__(self, c: int = 256, dilation: int = 2):
        super().__init__()
        self.conv_block = nn.Sequential(
            nn.ReflectionPad2d(dilation), nn.Conv2d(c, c, 3, dilation=dilation),
            InstanceNorm(), nn.ReLU(), nn.ReflectionPad2d(1), nn.Conv2d(c, c, 3), InstanceNorm())

    def forward(self, x):
        return x + self.conv_block(x)


class MISFGenerator(nn.Module):
    """InpaintGenerator (networks.py:35-107): (B, 4, H, W), the masked image
    in [0, 1] and the mask -> the inpainted image in [0, 1]."""

    def __init__(self, residual_blocks: int = 8, num_kernels: int = 256):
        super().__init__()
        self.encoder0 = nn.Sequential(nn.ReflectionPad2d(3), nn.Conv2d(4, 64, 7), InstanceNorm(),
                                      nn.ReLU())
        self.encoder1 = nn.Sequential(nn.Conv2d(64, 128, 4, 2, 1), InstanceNorm(), nn.ReLU())
        self.encoder2 = nn.Sequential(nn.Conv2d(128, 256, 4, 2, 1), InstanceNorm(), nn.ReLU())
        self.kpn_model = KPN(num_kernels)
        self.middle = nn.Sequential(*[_ResnetBlockD2() for _ in range(residual_blocks)])
        self.decoder = nn.Sequential(
            nn.ConvTranspose2d(256, 128, 4, 2, 1), InstanceNorm(), nn.ReLU(),
            nn.ConvTranspose2d(128, 64, 4, 2, 1), InstanceNorm(), nn.ReLU(),
            nn.ReflectionPad2d(3), nn.Conv2d(64, 3, 7))

    def forward(self, x4):
        e1 = self.encoder1(self.encoder0(x4))
        kernels, kernels_img = self.kpn_model(x4, e1)
        x = per_pixel_filter(self.encoder2(e1), kernels)
        x = per_pixel_filter(self.decoder(self.middle(x)), kernels_img)
        return (torch.tanh(x) + 1.0) / 2.0


def misf_state_dict(state_dict: Mapping) -> dict[str, torch.Tensor]:
    """A MISF state dict (reference file, whose weights sit under
    `generator`, or `convert.misf_state_dict_from_jax`) for a strict load,
    without the unused `kpn_model.conv_final` head (as the JAX converter)."""
    sd = strip_module_prefix(unwrap_envelope(state_dict, "generator"))
    return as_tensors({k: v for k, v in sd.items() if not _UNUSED.search(k)})


class MISFInpainter:
    """`inpainting_face` (inpainting.py:46): the hole masked out, the
    generator run, its prediction pasted into the hole only."""

    def __init__(self, state_dict: Mapping, num_kernels: int = 256, *,
                 residual_blocks: int = 8, device=None):
        self.device = resolve_device(device)
        self.model = MISFGenerator(residual_blocks, num_kernels)
        self.model.load_state_dict(misf_state_dict(state_dict), strict=True)
        self.model.to(self.device).eval().requires_grad_(False)

    def __call__(self, img01, mask) -> torch.Tensor:
        """img01: (B, H, W, 3) in [0, 1]; mask: (B, H, W, 1), 1 in the hole.
        Returns (B, H, W, 3) float32."""
        with torch.inference_mode():
            img = torch.as_tensor(img01).to(self.device, torch.float32).permute(0, 3, 1, 2)
            m = torch.as_tensor(mask).to(self.device, torch.float32).permute(0, 3, 1, 2)
            out = self.model(torch.cat([img * (1.0 - m), m], 1))
            return (out * m + img * (1.0 - m)).permute(0, 2, 3, 1)
