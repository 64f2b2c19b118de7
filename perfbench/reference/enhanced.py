"""The SwinIR-enhanced swap, plain: a frozen copy of what
`e4s2024_torch/pipelines/full_swap.py::FullFaceSwapPipeline.__call__` does
with the "swinir" enhancer (`models/swinir.py::SwinIREnhancer`), no
recolor and no inpainting (E4S's "SwinIR" face enhancement,
Face_swap_with_two_imgs.py:627-631): the driven crop upscaled x4 by
SwinIR-M with the window padding and clipped to [0, 255], resized back
bilinearly, truncated to uint8 as the staged path does, then the aligned
swap of `swap.Swapper`, uint8 out.
"""

from __future__ import annotations

import torch

from .resize import resize_bilinear
from .swap import Swapper
from .swinir import SwinIR, upscale


def enhance(net: SwinIR, crops255: torch.Tensor) -> torch.Tensor:
    """(B, S, S, 3) in [0, 255] -> the enhanced crops, (B, S, S, 3) float32
    in [0, 255]: x4 by `upscale`, bilinear back to S x S."""
    out = upscale(net, crops255)
    return resize_bilinear(out, tuple(crops255.shape[1:3])).permute(0, 2, 3, 1)


class EnhancedSwapper:
    """The core swap's nets and SwinIR. cfg: the configuration's `swap` and
    `swinir` groups (the latter in SwinIR's published argument names)."""

    def __init__(self, cfg: dict, device="cpu"):
        self.cfg = cfg
        self.core = Swapper(cfg["swap"], device)
        s = cfg["swinir"]
        with torch.device(device):
            self.swinir = SwinIR(
                embed_dim=s["embed_dim"], depths=tuple(s["depths"]),
                num_heads=tuple(s["num_heads"]), window_size=s["window_size"],
                mlp_ratio=s["mlp_ratio"], upscale=s["upscale"], upsampler=s["upsampler"],
                num_feat=s["num_feat"], resi_connection=s["resi_connection"])

    def nets(self) -> dict:
        return {**self.core.nets(), "swinir": self.swinir}

    def load(self, state: dict, device) -> None:
        self.core.load({k: state[k] for k in self.core.nets()}, device)
        self.swinir.to_empty(device=device)
        self.swinir.load_state_dict(state["swinir"], strict=True)
        self.swinir.eval().requires_grad_(False)

    @torch.no_grad()
    def swap_aligned(self, driven255, target255) -> dict:
        """driven255, target255: (B, S, S, 3) uint8 on the device. Returns
        image (B, S, S, 3) uint8 and the enhanced driven crop (B, S, S, 3)
        uint8 that the swap read."""
        driven = torch.clamp(enhance(self.swinir, driven255), 0, 255).to(torch.uint8)
        return {"image": self.core.swap_aligned(driven, target255)["image"], "driven": driven}
