"""The zoo-enhanced swap, plain: a frozen copy of
`e4s2024_torch/pipelines/full_swap.py::FullFaceSwapPipeline.swap_batch` at
the default `FullSwapConfig` with face inpainting, on the path the port
takes when every component has a fused form: GPEN-512 restores the driven
crop, the core swap reads the restored float crop as it is and keeps its
19-class parse, Blender recolors at 256^2, RealESRGAN x4 brings the recolor
back to 1024^2, the edge-aware blend, GCFSR inpaints the hole, uint8 out.
"""

from __future__ import annotations

import torch

from .blend import blend_with_mask, sobel_edge, soft_erosion_planar
from .blender import Blender, recolor
from .gcfsr import FaceInpainting, inpaint
from .gpen import GPENFullGenerator, restore_aligned
from .resize import resize_bilinear
from .rrdb import RRDBNet, upscale
from .swap import Swapper


class ZooSwapper:
    """The core swap's nets and the zoo's. cfg: the configuration's `swap`
    and `zoo` groups."""

    def __init__(self, cfg: dict, device="cpu"):
        self.cfg = cfg
        zoo = cfg["zoo"]
        self.core = Swapper(cfg["swap"], device)
        with torch.device(device):
            self.gpen = GPENFullGenerator(zoo["gpen_size"],
                                          channel_multiplier=zoo["gpen_channel_multiplier"],
                                          narrow=zoo["gpen_narrow"])
            self.blender = Blender()
            self.rrdb = RRDBNet(zoo["rrdb_num_feat"], zoo["rrdb_num_block"],
                                zoo["rrdb_num_grow"])
            self.gcfsr = FaceInpainting(zoo["gcfsr_size"])

    def nets(self) -> dict:
        return {**self.core.nets(), "gpen": self.gpen, "blender": self.blender,
                "rrdb": self.rrdb, "gcfsr": self.gcfsr}

    def load(self, state: dict, device) -> None:
        self.core.load({k: state[k] for k in self.core.nets()}, device)
        for name in ("gpen", "blender", "rrdb", "gcfsr"):
            net = getattr(self, name)
            net.to_empty(device=device)
            net.load_state_dict(state[name], strict=True)
            net.eval().requires_grad_(False)

    def _recolor(self, swapped255, target255, d19, t19):
        rec = recolor(self.blender, swapped255, target255, d19, t19,
                      self.cfg["zoo"]["blender_size"])
        if rec.shape[1] * 4 <= swapped255.shape[1]:
            rec = upscale(self.rrdb, rec)
        h = swapped255.shape[1]
        rec = resize_bilinear(rec.permute(0, 3, 1, 2), (h, h))
        swapped = swapped255.float().permute(0, 3, 1, 2)
        edge = torch.clamp(sobel_edge(swapped) / 255.0, 0.0, 1.0)
        out = blend_with_mask(rec, swapped, edge, up_ratio=self.cfg["zoo"]["blend_up_ratio"])
        return torch.clamp(out, 0, 255).permute(0, 2, 3, 1)

    def _inpaint(self, img255, hole_mask):
        out = inpaint(self.gcfsr, img255, hole_mask, self.cfg["zoo"]["gcfsr_size"])
        mask = resize_bilinear(hole_mask.float()[:, None], (img255.shape[1],) * 2)
        soft = soft_erosion_planar(mask)[0].permute(0, 2, 3, 1)
        return torch.clamp(blend_with_mask(img255.float(), out, soft, 1.0), 0, 255)

    @torch.no_grad()
    def swap_batch(self, src, tgt) -> dict:
        """src, tgt: (B, S, S, 3) uint8 on the device. Returns image
        (B, S, S, 3) uint8, and the core swap's swapped_mask and hole_mask."""
        b = src.shape[0]
        driven = restore_aligned(self.gpen, src.float(), self.cfg["zoo"]["gpen_size"],
                                 src.device)
        masks, sv, labels19 = self.core.parse_invert(torch.cat([driven.float(), tgt.float()]))
        result = self.core.merge_synth_composite(masks[:b], masks[b:], sv[:b], sv[b:], tgt)
        swapped = self._recolor(result["image"].float(), tgt, labels19[:b], labels19[b:])
        swapped = self._inpaint(swapped, result["hole_mask"])
        return {"image": torch.clamp(swapped, 0, 255).to(torch.uint8),
                "swapped_mask": result["swapped_mask"], "hole_mask": result["hole_mask"]}
