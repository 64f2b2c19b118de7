"""Driver of `FullFaceSwapPipeline.swap_batch`
(`e4s2024_torch/pipelines/full_swap.py`), the zoo-enhanced swap of a batch
of pairs, over the configuration's `swap` and `zoo` groups: GPEN-512, the
core swap, Blender with RealESRGAN x4, GCFSR inpainting.

A call hands the pipeline one batch of host uint8 (driven, target) crops
and ends when the batch's images are on the host; the check compares every
call's images with the reference (`reference/zoo.py`):

- `image_mad_median`: the worst call's median over its 8 images of each
  image's mean |difference|, in levels: rounding's level, which a batch
  computed in a lower precision leaves;
- `image_mad_worst`: the worst image's mean |difference| over every call,
  in levels: what one image swapped wrong leaves, while a parse label
  flipped at a near-tie in one image stays under it.
"""

from __future__ import annotations

from perfbench import checks
from perfbench.pairs_driver import PairsDriver, face_swapper
from perfbench.reference.zoo import ZooSwapper


class Driver(PairsDriver):
    PROGRAM_MODULES = ("e4s2024_torch.pipelines.full_swap", "e4s2024_torch.models.blender",
                       "e4s2024_torch.models.gcfsr", "e4s2024_torch.models.gpen",
                       "e4s2024_torch.models.rrdb")
    REFERENCE = ZooSwapper
    COMPARED = (("image", "image_mad_median", checks.image_mad_median),
                ("image", "image_mad_worst", checks.image_mad_worst))

    def reference_cfg(self):
        return {"swap": self.ctx.config["swap"], "zoo": self.ctx.config["zoo"]}

    def build_program(self, state):
        from e4s2024_torch.models.blender import BlenderRecolorer
        from e4s2024_torch.models.gcfsr import FaceInpainter
        from e4s2024_torch.models.gpen import GPENEnhancer
        from e4s2024_torch.models.rrdb import RealESRGANUpscaler
        from e4s2024_torch.pipelines.full_swap import (
            FullFaceSwapPipeline, FullSwapConfig, SwapComponents)

        zoo, dev = self.ctx.config["zoo"], self.ctx.device
        sw = face_swapper(self.ctx.config["swap"], state, dev)
        comps = SwapComponents(
            enhancers={"gpen": GPENEnhancer(
                state["gpen"], zoo["gpen_size"], channel_multiplier=zoo["gpen_channel_multiplier"],
                narrow=zoo["gpen_narrow"], device=dev).enhance_aligned},
            recolorer=BlenderRecolorer(state["blender"], device=dev),
            upscaler=RealESRGANUpscaler(state["rrdb"], num_feat=zoo["rrdb_num_feat"],
                                        num_block=zoo["rrdb_num_block"],
                                        num_grow=zoo["rrdb_num_grow"], device=dev),
            inpainter=FaceInpainter(state["gcfsr"], zoo["gcfsr_size"], device=dev))
        keys = FullSwapConfig.__dataclass_fields__
        cfg = FullSwapConfig(**{k: v for k, v in zoo.items() if k in keys})
        return FullFaceSwapPipeline(sw, comps, cfg)

    def program_call(self, driven, target):
        return {"image": self.program.swap_batch(driven, target)}

    def reference_swap(self, ref, driven, target):
        return ref.swap_batch(driven, target)

    def end_to_end(self, r) -> dict:
        return {"swaps_per_s": r.items / r.window_s}
