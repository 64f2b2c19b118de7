"""Face swap with the auxiliary models around the core swap.

Counterpart of `e4s2024_tpu/pipelines/full_swap.py` (the reference's
`FaceSwap.face_swap_pipeline`, Face_swap_with_two_imgs.py:796), in its
staged form on pre-aligned crops:

  1. enhancement of the driven crop (`components.enhancers`, reference
     :606-643): "gpen" when given, else `cfg.enhancement_mode`; an absent
     enhancer is the identity,
  2. the core swap, `FaceSwapper.swap_aligned`, which truncates the float
     enhanced crop to uint8 as the JAX swapper does,
  3. packaging to uint8.

`swap_raw` and `swap_raw_multi` run it from raw frames through
`FaceSwapper.swap` / `swap_all`.

Ported so far: the enhancers (the SwinIR enhancer of `models/swinir.py`, or
any callable with its contract). Not yet ported, and refused with
NotImplementedError when asked for: the pose driver, the recolorer, the
upscaler, the inpainter, W-space refinement (`optimize_w_steps > 0`) and the
classical `ct_mode`s. `ct_mode="blender"` without a recolorer and
`face_inpainting` without an inpainter are the identity, as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from e4s2024_torch.pipelines.swap import FaceSwapper


@dataclass
class SwapComponents:
    """Pluggable auxiliary models (each may be absent)."""

    enhancers: dict = field(default_factory=dict)  # name -> enhance_aligned fn
    pose_driver: Any = None
    pose_estimator: Any = None
    recolorer: Any = None
    upscaler: Any = None
    inpainter: Any = None
    loss_params: dict = field(default_factory=dict)


@dataclass
class FullSwapConfig:
    pose_gap_threshold: float = 20.0   # degrees; reenact only above this gap
    enhancement_mode: str = "gpen"     # reference fixes driven enhance to gpen
    ct_mode: str = "blender"           # "blender" | lct/rct/mkl/sot/... | "none"
    face_inpainting: bool = False
    optimize_w_steps: int = 0
    optimize_w_lr: float = 1e-2
    blend_up_ratio: float = 0.75
    max_fused_batch: int | None = None


class FullFaceSwapPipeline:
    """Enhanced face swap on aligned crops. Results are tensors on the
    swapper's device."""

    def __init__(self, swapper: FaceSwapper, components: SwapComponents | None = None,
                 cfg: FullSwapConfig | None = None):
        self.swapper = swapper
        self.comp = SwapComponents() if components is None else components
        self.cfg = FullSwapConfig() if cfg is None else cfg
        missing = [name for name in ("pose_driver", "recolorer", "upscaler", "inpainter")
                   if getattr(self.comp, name) is not None]
        if self.cfg.optimize_w_steps > 0:
            missing.append("optimize_w_steps > 0")
        if self.cfg.ct_mode not in ("none", "blender"):
            missing.append(f"ct_mode={self.cfg.ct_mode!r}")
        if missing:
            raise NotImplementedError(
                f"not ported yet: {', '.join(missing)}; the port runs the enhancers "
                "and the core swap")

    def _enhance(self, img255: torch.Tensor, mode: str | None = None) -> torch.Tensor:
        """Stage 3: face restoration of one (S, S, 3) crop (reference
        :606-643); the identity when no enhancer serves the mode."""
        fn = self.comp.enhancers.get(mode or self.cfg.enhancement_mode)
        if fn is None:
            return img255
        return fn(img255.float()[None])[0]

    def __call__(self, source_crop255, target_crop255,
                 return_intermediates: bool = False) -> dict:
        """Swap one pair of aligned (S, S, 3) crops. Returns {"image": (S, S, 3)
        uint8}; `return_intermediates` adds the driven crop (uint8) and the
        swap's `swapped_mask` (uint8) and `hole_mask`."""
        sw = self.swapper
        with torch.inference_mode():
            src, tgt = sw._as_u8(source_crop255), sw._as_u8(target_crop255)
            driven = self._enhance(src, "gpen" if "gpen" in self.comp.enhancers else None)
            result = sw.swap_aligned(driven.float()[None], tgt.float()[None])
            swapped = result["image"][0].float()
            return self._package(swapped, driven, result, return_intermediates)

    def swap_batch(self, source_crops255, target_crops255) -> torch.Tensor:
        """Swap B aligned pairs, (B, S, S, 3) -> (B, S, S, 3) uint8, one staged
        swap per pair (the JAX pipeline's path for an enhancer that has no
        fused form, as the SwinIR enhancer has none)."""
        return torch.stack([self(s, t)["image"]
                            for s, t in zip(source_crops255, target_crops255)])

    def swap_raw(self, source_img, target_img):
        """Raw-frame entry: detection and alignment (the swapper's landmark
        stack), the enhanced swap on the crops, perspective paste-back — the
        reference's `FaceSwap.face_swap_pipeline` from unaligned images.
        Returns the (H, W, 3) uint8 numpy frame."""
        return self.swapper.swap(source_img, target_img, swap_fn=self.swap_batch)

    def swap_raw_multi(self, source_img, target_img, **kw):
        """The source identity onto every face detected in the target frame,
        each through the enhanced swap (`FaceSwapper.swap_all`)."""
        return self.swapper.swap_all(source_img, target_img, swap_fn=self.swap_batch, **kw)

    def _package(self, swapped, driven, result, intermediates: bool = False) -> dict:
        out = {"image": torch.clamp(swapped, 0, 255).to(torch.uint8)}
        if intermediates:
            out.update({
                "driven": torch.clamp(driven.float(), 0, 255).to(torch.uint8),
                "swapped_mask": result["swapped_mask"][0].to(torch.uint8),
                "hole_mask": result["hole_mask"][0],
            })
        return out
