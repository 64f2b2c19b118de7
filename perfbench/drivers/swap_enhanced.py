"""Driver of `FullFaceSwapPipeline.__call__`
(`e4s2024_torch/pipelines/full_swap.py`) with the "swinir" enhancer
(`models/swinir.py::SwinIREnhancer` over `SwinIRUpscaler`, every Swin
block one launch of K5), no recolor and no inpainting, over the
configuration's `swap` and `swinir` groups: the SwinIR-enhanced swap of
one aligned pair.

A call hands the pipeline one host uint8 (driven, target) pair from the
traffic's pool and ends when the swapped image is on the host; the
enhanced driven crop (uint8, as the swap read it) stays on the card until
the check, which compares every call with the reference
(`reference/enhanced.py`):

- `driven_mad`: the worst call's mean |difference| of the enhanced driven
  crop, in levels: what SwinIR and the resize produced;
- `image_mad_median`: the median over the window's calls of each call's
  mean |difference| of the swapped image, in levels. The worst call's
  would not do: a driven level truncated the other way flips parse labels
  at near-ties in a few pairs of a pool, and sound runs then read up to
  2.2 levels there, above the control's least (PERF.md §4).
"""

from __future__ import annotations

import statistics

from perfbench import checks
from perfbench.pairs_driver import PairsDriver, face_swapper
from perfbench.reference.enhanced import EnhancedSwapper


class Driver(PairsDriver):
    PROGRAM_MODULES = ("e4s2024_torch.pipelines.full_swap", "e4s2024_torch.models.swinir")
    REFERENCE = EnhancedSwapper
    COMPARED = (("driven", "driven_mad", checks.image_mad),
                ("image", "image_mad_median", checks.image_mad))
    OVER_CALLS = {"driven_mad": max, "image_mad_median": statistics.median}

    def reference_cfg(self):
        return {"swap": self.ctx.config["swap"], "swinir": self.ctx.config["swinir"]}

    def build_program(self, state):
        from e4s2024_torch.models.swinir import SwinIREnhancer, SwinIRUpscaler
        from e4s2024_torch.pipelines.full_swap import (
            FullFaceSwapPipeline, FullSwapConfig, SwapComponents)

        s, dev = self.ctx.config["swinir"], self.ctx.device
        up = SwinIRUpscaler(state["swinir"], compute_dtype=self.ctx.config["swap"]["compute_dtype"],
                            device=dev, embed_dim=s["embed_dim"], depths=tuple(s["depths"]),
                            heads=tuple(s["num_heads"]), window=s["window_size"],
                            scale=s["upscale"], num_feat=s["num_feat"], mlp_ratio=s["mlp_ratio"])
        return FullFaceSwapPipeline(
            face_swapper(self.ctx.config["swap"], state, dev),
            SwapComponents(enhancers={"swinir": SwinIREnhancer(up).enhance_aligned}),
            FullSwapConfig(enhancement_mode="swinir", ct_mode="none", face_inpainting=False))

    def program_call(self, driven, target):
        out = self.program(driven[0], target[0], return_intermediates=True)
        return {"image": out["image"][None], "driven": out["driven"][None]}

    def reference_swap(self, ref, driven, target):
        return ref.swap_aligned(driven, target)

    def check(self) -> list:
        """`PairsDriver.check`, each number taken over the calls by
        `OVER_CALLS` in place of the worst call's."""
        values: dict = {name: [] for _, name, _ in self.COMPARED}
        by_entry: dict = {}
        for j, out in self.outputs:
            by_entry.setdefault(j, []).append(out)
        for j, outs in sorted(by_entry.items()):
            ref = self.reference_swap(self._reference(), *self._on_device(j))
            for out in outs:
                for key, name, fn in self.COMPARED:
                    values[name].append(fn(out[key], ref[key]))
        self.outputs.clear()
        limits = self.ctx.workload["limits"]
        return [{"name": k, "value": self.OVER_CALLS[k](v), "limit": limits[k]}
                for k, v in values.items()]

    def end_to_end(self, r) -> dict:
        return {"swaps_per_s": r.items / r.window_s}
