"""Driver of `FaceSwapper.swap_aligned` (`e4s2024_torch/pipelines/swap.py`),
the aligned-crop swap, over the configuration's `swap` group.

A call hands the swap one batch of host uint8 (driven, target) crops from
the traffic's pool and ends when the swapped image is on the host; the
swapped mask and style vectors stay on the card until the check, which
compares every call with the reference swap (`reference/swap.py`):

- `image_mad`: the worst call's mean |difference| of the image, in levels;
- `mask_mismatch`: the worst swapped mask's share of pixels that differ;
- `style_gap`: the worst swapped style vectors' largest |difference| over
  the reference's largest |value|.
"""

from __future__ import annotations

from perfbench import checks
from perfbench.pairs_driver import PairsDriver, face_swapper
from perfbench.reference.swap import Swapper


class Driver(PairsDriver):
    PROGRAM_MODULES = ("e4s2024_torch.pipelines.swap",)
    REFERENCE = Swapper
    COMPARED = (("image", "image_mad", checks.image_mad),
                ("swapped_mask", "mask_mismatch", checks.mismatch_share),
                ("swapped_style_vectors", "style_gap", checks.rel_gap))

    def reference_cfg(self):
        return self.ctx.config["swap"]

    def build_program(self, state):
        return face_swapper(self.ctx.config["swap"], state, self.ctx.device)

    def program_call(self, driven, target):
        return self.program.swap_aligned(driven, target)

    def reference_swap(self, ref, driven, target):
        return ref.swap_aligned(driven, target)

    def end_to_end(self, r) -> dict:
        from perfbench.harness import quantile

        return {"swap_ms_p95": 1e3 * quantile(r.latencies_s, 0.95)}
