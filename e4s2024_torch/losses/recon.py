"""The shared reconstruction criterion, LPIPS + ID + face parsing + L2
(reference training/coach.py:453-503), counterpart of
`e4s2024_tpu/losses/recon.py` in NCHW.

Under a height split (`parallel.spatial`) recon and img are slabs of rows
and every term comes out whole on every rank: the L2 mean is a sum over
the split, LPIPS runs on the slabs, and ArcFace (on the 112^2 crop of the
256^2 image) and the parsing U-Net (on the 512^2 image) run whole on the
gathered images, the only tensors of the criterion held whole."""

from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

from e4s2024_torch.losses.losses import (feature_cosine_loss, id_loss_crop, multiscale_lpips,
                                         whole_image)
from e4s2024_torch.models.arcface import ArcFaceBackbone
from e4s2024_torch.models.lpips import LPIPS
from e4s2024_torch.models.parser_unet import ParsingUNet
from e4s2024_torch.parallel import spatial

_NETS = {"lpips": LPIPS, "arcface": ArcFaceBackbone, "parser": ParsingUNet}


def _frozen(entry, cls, device) -> nn.Module:
    """A loss net from a module or a state dict, frozen and in eval mode."""
    if isinstance(entry, nn.Module):
        net = entry
    else:
        net = cls()
        net.load_state_dict({k: torch.as_tensor(v) for k, v in entry.items()}, strict=True)
    net = net.eval().requires_grad_(False)
    return net if device is None else net.to(device)


class ReconCriterion:
    """`loss_params` may hold "lpips", "arcface" and "parser" entries, each
    the port's module or its state dict; a missing entry disables its term.

    Called with (recon, img), both (B, 3, S, S) in [-1, 1], it returns
    (loss, metrics), the metrics as tensors. The L2 term runs in the images'
    dtype, the loss nets in float32 (bfloat16 images are cast, as the JAX
    package's float32 nets promote them)."""

    def __init__(self, loss_params: Mapping, lpips_lambda: float = 0.8,
                 id_lambda: float = 0.1, face_parsing_lambda: float = 0.1,
                 l2_lambda: float = 1.0, device=None):
        self.lpips_lambda, self.id_lambda = lpips_lambda, id_lambda
        self.face_parsing_lambda, self.l2_lambda = face_parsing_lambda, l2_lambda
        self.nets = {name: _frozen(loss_params[name], cls, device)
                     for name, cls in _NETS.items() if name in loss_params}

    def __call__(self, recon: torch.Tensor, img: torch.Tensor):
        loss, metrics = 0.0, {}
        if self.l2_lambda > 0:
            l2 = spatial.mean((recon - img).square())
            loss = loss + self.l2_lambda * l2
            metrics["loss_l2"] = l2
        recon, img = recon.float(), img.float()
        if self.lpips_lambda > 0 and "lpips" in self.nets:
            lp = multiscale_lpips(self.nets["lpips"], recon, img)
            loss = loss + self.lpips_lambda * lp
            metrics["loss_lpips"] = lp
        if self.id_lambda > 0 and "arcface" in self.nets:
            arcface = self.nets["arcface"]

            def feats(x):
                crop = id_loss_crop(x)
                with spatial.suspended():
                    return arcface(crop, multi_scale=True)

            idl = feature_cosine_loss(feats(recon), feats(img))
            loss = loss + self.id_lambda * idl
            metrics["loss_id"] = idl
        if self.face_parsing_lambda > 0 and "parser" in self.nets:
            parser = self.nets["parser"]

            def pfeats(x):
                x = whole_image(x, 512)
                with spatial.suspended():
                    return parser.extract_feats(x)

            fpl = feature_cosine_loss(pfeats(recon), pfeats(img))
            loss = loss + self.face_parsing_lambda * fpl
            metrics["loss_face_parsing"] = fpl
        metrics["loss"] = loss
        return loss, metrics
