"""The aligned-crop swap, plain: a frozen copy of
`e4s2024_torch/pipelines/swap.py::FaceSwapper.swap_aligned` and its stages.

BiSeNet parse of the driven and target crops, RGI inversion to 12 regional
style vectors, `swap_head_mask` and the style-vector mix, the regional
StyleGAN2 re-synthesis, and the soft-erosion and Laplacian-pyramid
composite, in float32, over the plain kernel forms of `plain_kernels`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .bisenet import SEG_MEAN, SEG_STD, BiSeNet, bicubic_downsample
from .blend import laplacian_pyramid_blend_planar, soft_erosion_planar
from .labels import FFHQ_TO_12, map_labels
from .mask_merge import swap_comp_style_vector, swap_head_mask
from .morphology import dilation_planar
from .resize import resize_bilinear
from .rgi import RGINet

class Swapper:
    """RGINet and BiSeNet, and the aligned swap over them.

    cfg: the configuration's `swap` group (out_size, num_seg_cls,
    remaining_layer_idx, outer_dilation, keep_target_components,
    regional_mode, num_blend_levels, encoder_num_units). The nets are
    built on `device` (meta: their shapes alone) and take their weights
    with `load`."""

    def __init__(self, cfg: dict, device="cpu"):
        self.cfg = cfg
        with torch.device(device):
            self.rgi = RGINet(num_seg_cls=cfg["num_seg_cls"], out_size=cfg["out_size"],
                              remaining_layer_idx=cfg["remaining_layer_idx"],
                              encoder_num_units=tuple(cfg["encoder_num_units"]))
            self.bisenet = BiSeNet()
        keep = set(cfg["keep_target_components"])
        self._comp = [c for c in range(cfg["num_seg_cls"]) if c not in keep]

    def nets(self) -> dict:
        return {"rgi": self.rgi, "bisenet": self.bisenet}

    def load(self, state: dict, device) -> None:
        """state: {"rgi": state dict, "bisenet": state dict} on `device`."""
        for name, net in self.nets().items():
            net.to_empty(device=device)
            net.load_state_dict(state[name], strict=True)
            net.eval().requires_grad_(False)

    def _parse19(self, img01):
        h = img01.shape[-2]
        if h > 512:
            x = torch.clamp(bicubic_downsample(img01, h // 512), 0.0, 1.0)
        elif h < 512:
            x = resize_bilinear(img01, (512, 512))
        else:
            x = img01
        mean = torch.tensor(SEG_MEAN, device=x.device).view(1, 3, 1, 1)
        std = torch.tensor(SEG_STD, device=x.device).view(1, 3, 1, 1)
        logits, _, _ = self.bisenet((x - mean) / std, aux=False, upsample=False)
        logits = resize_bilinear(logits.float(), (512, 512), align_corners=True)
        return torch.argmax(logits, dim=1)

    def _onehot(self, labels):
        s = labels.shape[1]
        if self.cfg["remaining_layer_idx"] < 17:
            target = min(s, max(self.cfg["out_size"] // 2, 32))
            step = s // target
            if step > 1 and s % target == 0:
                labels = labels[:, ::step, ::step]
        return F.one_hot(labels, self.cfg["num_seg_cls"]).permute(0, 3, 1, 2).float().contiguous()

    def _composite(self, swapped_pm1, target_pm1, swapped_msk, hole_mask):
        cfg = self.cfg
        bg = torch.zeros_like(swapped_msk, dtype=torch.bool)
        for c in (0, 11, 4, 7, 8):
            bg |= swapped_msk == c
        fg = ((~bg) | hole_mask)[:, None].float()
        r = cfg["outer_dilation"]
        both = dilation_planar(torch.cat([fg, -fg], dim=1), 2 * r + 1)
        full, eroded = both[:, 0:1], -both[:, 1:2]
        soft, _ = soft_erosion_planar(torch.cat([full, eroded, fg], dim=1))
        border = torch.clamp(soft[:, 0:1] - soft[:, 1:2], 0.0, 1.0)
        content = soft[:, 2:3]
        size = (cfg["out_size"], cfg["out_size"])
        cb = resize_bilinear(torch.cat([content, border], dim=1), size)
        content, border = cb[:, 0:1], cb[:, 1:2]
        sw255 = (swapped_pm1 + 1.0) * 127.5
        tg255 = (target_pm1 + 1.0) * 127.5
        out = sw255 * content + tg255 * (1.0 - content)
        out = laplacian_pyramid_blend_planar(tg255, out, border,
                                             num_levels=cfg["num_blend_levels"])
        out = torch.clamp(out, 0.0, 255.0).permute(0, 2, 3, 1)
        return out.to(torch.uint8)

    def parse_invert(self, pair255):
        """Parse and invert the (2B, S, S, 3) pair batch, uint8 or float in
        [0, 255]: (12-class masks, style vectors, 19-class labels)."""
        img01 = pair255.permute(0, 3, 1, 2).float() / 255.0
        labels19 = self._parse19(img01)
        masks = map_labels(labels19, FFHQ_TO_12)
        sv, _ = self.rgi.get_style_vectors(img01 * 2.0 - 1.0, self._onehot(masks))
        return masks, sv, labels19

    def merge_synth_composite(self, d_masks, t_masks, d_sv, t_sv, t255) -> dict:
        """Merge, mix, synthesise and composite B swaps onto the (B, S, S, 3)
        uint8 targets."""
        t_pm1 = t255.permute(0, 3, 1, 2).float() / 127.5 - 1.0
        merged = swap_head_mask(d_masks, t_masks)
        swapped_sv = swap_comp_style_vector(t_sv, d_sv, self._comp)
        codes = self.rgi.cal_style_codes(swapped_sv)
        swapped, _, _ = self.rgi.gen_img(None, codes, self._onehot(merged["mask"]),
                                         regional_mode=self.cfg["regional_mode"])
        image = self._composite(swapped.float(), t_pm1, merged["mask"], merged["hole_mask"])
        return {"image": image, "swapped_mask": merged["mask"],
                "hole_mask": merged["hole_mask"], "swapped_style_vectors": swapped_sv}

    @torch.no_grad()
    def swap_aligned(self, driven255, target255) -> dict:
        """driven255, target255: (B, S, S, 3) uint8 (or float in [0, 255],
        quantised first) on the device. Returns image (B, S, S, 3) uint8,
        swapped_mask and hole_mask (B, 512, 512), swapped_style_vectors
        (B, 12, 1280)."""
        b = driven255.shape[0]
        pair = torch.cat([driven255, target255], dim=0)
        if pair.dtype != torch.uint8:
            pair = torch.clamp(pair, 0, 255).to(torch.uint8)
        masks, sv, _ = self.parse_invert(pair)
        return self.merge_synth_composite(masks[:b], masks[b:], sv[:b], sv[b:], pair[b:])
