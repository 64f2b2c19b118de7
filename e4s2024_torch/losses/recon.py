"""The shared reconstruction criterion, LPIPS + ID + face parsing + L2
(reference training/coach.py:453-503), counterpart of
`e4s2024_tpu/losses/recon.py` in NCHW."""

from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

from e4s2024_torch.losses.losses import feature_cosine_loss, id_loss_crop, multiscale_lpips
from e4s2024_torch.models.arcface import ArcFaceBackbone
from e4s2024_torch.models.lpips import LPIPS
from e4s2024_torch.models.parser_unet import ParsingUNet
from e4s2024_torch.ops.pool import adaptive_avg_pool2d

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
    (loss, metrics), the metrics as tensors."""

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
            l2 = (recon - img).square().mean()
            loss = loss + self.l2_lambda * l2
            metrics["loss_l2"] = l2
        if self.lpips_lambda > 0 and "lpips" in self.nets:
            lp = multiscale_lpips(self.nets["lpips"], recon, img)
            loss = loss + self.lpips_lambda * lp
            metrics["loss_lpips"] = lp
        if self.id_lambda > 0 and "arcface" in self.nets:
            arcface = self.nets["arcface"]

            def feats(x):
                return arcface(id_loss_crop(x), multi_scale=True)

            idl = feature_cosine_loss(feats(recon), feats(img))
            loss = loss + self.id_lambda * idl
            metrics["loss_id"] = idl
        if self.face_parsing_lambda > 0 and "parser" in self.nets:
            parser = self.nets["parser"]

            def pfeats(x):
                if x.shape[2] != 512:
                    x = adaptive_avg_pool2d(x, (512, 512))
                return parser.extract_feats(x)

            fpl = feature_cosine_loss(pfeats(recon), pfeats(img))
            loss = loss + self.face_parsing_lambda * fpl
            metrics["loss_face_parsing"] = fpl
        metrics["loss"] = loss
        return loss, metrics
