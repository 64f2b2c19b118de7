"""Face swap with the auxiliary models around the core swap.

Counterpart of `e4s2024_tpu/pipelines/full_swap.py` (the reference's
`FaceSwap.face_swap_pipeline`, Face_swap_with_two_imgs.py:796), on
pre-aligned crops, B pairs at a time:

  1. pose_align: reenactment of the source crop toward the target's pose
     (reference :688-743) by `components.pose_driver` (faceVid2Vid,
     `models/facevid2vid.py`), gated per pair on the Hopenet pose gap of
     `components.pose_estimator` (`models/hopenet.py`): pairs whose gap is
     below `cfg.pose_gap_threshold` keep their crop; without a driver, the
     identity,
  2. enhance: restoration of the driven crop (`components.enhancers`,
     reference :606-643): "gpen" when given, else `cfg.enhancement_mode`;
     an absent enhancer is the identity,
  3. core_swap: parse, invert, merge, synthesise, composite
     (`FaceSwapper`),
  4. parse19 and recolor: the 19-class parse of the driven and target
     crops, the Blender recolor at 256^2 (`models/blender.py`), RealESRGAN
     x4 back up (`models/rrdb.py`) and the edge-aware blend (reference
     :522-560, :910-924); or a classical `ct_mode` (`ops/color.py`),
  5. inpaint: with `face_inpainting`, GCFSR completion of the hole
     (`models/gcfsr.py`) and a soft-eroded composite (reference :223-258),
  6. package: uint8.

The JAX pipeline runs a configuration whose components all have a fused
form (GPEN, Blender, RealESRGAN, GCFSR: `fused_form`) as one program, in
which the enhanced float crop enters the core swap as it is; otherwise
(the SwinIR enhancer, a classical ct_mode, W-space refinement, a pose
driver) it runs stage by stage, and the swap truncates the enhanced crop
to uint8. The port runs the stages in both cases and follows that rule for
the crop, so that each configuration computes what JAX's default call
computes.

`swap_batch` runs B pairs through every stage as one batch, in chunks of
`cfg.max_fused_batch` (None: the whole batch, as in JAX). `swap_raw` and
`swap_raw_multi` run it from raw frames through `FaceSwapper.swap` /
`swap_all`.

With `optimize_w_steps > 0` the core swap refines both crops' style
vectors first (`_swap_with_optimized_w`, stage "optimize_w_swap").
`ct_mode="blender"` without a recolorer and `face_inpainting` without an
inpainter are the identity, as in JAX. With a pose driver, JAX's
`swap_batch` falls back to one staged call per pair, so each pair is gated
on its own gap; the port batches the stages and keeps that per-pair gate.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from e4s2024_torch.ops import color
from e4s2024_torch.ops.blend import blend_with_mask, sobel_edge, soft_erosion_planar
from e4s2024_torch.ops.resize import resize_bilinear
from e4s2024_torch.pipelines.swap import FaceSwapper

CT_MODES = ("none", "blender") + color.DEVICE_MODES + color.HOST_MODES


@dataclass
class SwapComponents:
    """Pluggable auxiliary models (each may be absent)."""

    enhancers: dict = field(default_factory=dict)  # name -> enhance_aligned fn
    pose_driver: Any = None        # FaceVid2VidDriver-like .drive(src01, tgt01)
    pose_estimator: Any = None     # PoseEstimator-like .pose_gaps(a255, b255)
    recolorer: Any = None          # BlenderRecolorer-like .recolor(...)
    upscaler: Any = None           # RealESRGANUpscaler-like .upscale(img255)
    inpainter: Any = None          # FaceInpainter-like .inpaint(img255, hole)
    loss_params: dict = field(default_factory=dict)


@dataclass
class FullSwapConfig:
    pose_gap_threshold: float = 20.0   # degrees; reenact only above this gap
    enhancement_mode: str = "gpen"     # reference fixes driven enhance to gpen
    ct_mode: str = "blender"           # "blender" | lct/rct/mkl/sot/... | "none"
    face_inpainting: bool = False
    optimize_w_steps: int = 0
    optimize_w_lr: float = 1e-2
    blend_up_ratio: float = 0.75       # edge-aware recolor blend (:910-924)
    # the most pairs `swap_batch` runs through the stages at once; None: the
    # whole batch, as in JAX. At 1024^2 the default config's peak memory
    # grows with B (PERF.md gives the largest B that fits the card).
    max_fused_batch: int | None = None


def _owner(fn):
    return getattr(fn, "__self__", fn)


class FullFaceSwapPipeline:
    """The zoo-enhanced face swap on aligned crops. Results are tensors on
    the swapper's device."""

    def __init__(self, swapper: FaceSwapper, components: SwapComponents | None = None,
                 cfg: FullSwapConfig | None = None):
        self.swapper = swapper
        self.comp = SwapComponents() if components is None else components
        self.cfg = FullSwapConfig() if cfg is None else cfg
        # the last pose gate: each pair's gap (None without an estimator) and
        # whether it was driven
        self.last_gate: dict | None = None
        # the group `shard_inference` serves over
        self.process_group = None
        if self.cfg.ct_mode not in CT_MODES:
            raise ValueError(f"unknown ct_mode {self.cfg.ct_mode!r}")

    # ---------------- stages ----------------

    def _enhance_mode(self) -> str:
        return "gpen" if "gpen" in self.comp.enhancers else self.cfg.enhancement_mode

    def _fused(self) -> bool:
        """Whether JAX's default call runs this configuration as its one
        program (`_maybe_build_fused`): no host-side stage, and every present
        component with a fused form. There the enhanced crop enters the swap
        as float; otherwise the swap truncates it to uint8."""
        cfg, comp = self.cfg, self.comp
        if cfg.optimize_w_steps > 0 or comp.pose_driver is not None \
                or cfg.ct_mode not in ("none", "blender"):
            return False
        enh = comp.enhancers.get(self._enhance_mode())
        parts = [enh] if enh is not None else []
        if cfg.ct_mode == "blender" and comp.recolorer is not None:
            parts += [comp.recolorer] + ([comp.upscaler] if comp.upscaler is not None else [])
        if cfg.face_inpainting and comp.inpainter is not None:
            parts.append(comp.inpainter)
        return all(getattr(_owner(p), "fused_form", False) for p in parts)

    def _pose_align(self, src: torch.Tensor, tgt: torch.Tensor, timer=None) -> torch.Tensor:
        """Reenactment of the (B, S, S, 3) uint8 source crops toward their
        targets' poses (reference :688-743). The estimator's gap is each
        pair's own (the largest of |d yaw|, |d pitch|, |d roll|); a pair is
        driven when its gap is at least `cfg.pose_gap_threshold`, every pair
        when there is no estimator. The gate costs one host synchronisation.
        A driven pair's crop: /255, bilinear to 256^2, `pose_driver.drive`,
        bilinear back to S^2, x255, float. Returns the crops unchanged when
        no pair is driven, else float crops. With `timer`, the gate and the
        drive are the stages pose_gate and pose_drive."""
        comp = self.comp
        if comp.pose_driver is None:
            return src

        def stage(name):
            return contextlib.nullcontext() if timer is None else timer.stage(name)

        b = src.shape[0]
        gaps = None
        with stage("pose_gate"):
            if comp.pose_estimator is not None:
                gaps = comp.pose_estimator.pose_gaps(src, tgt).tolist()
        drive = [i for i in range(b)
                 if gaps is None or not gaps[i] < self.cfg.pose_gap_threshold]
        self.last_gate = {"gaps": gaps, "driven": [i in drive for i in range(b)]}
        if not drive:
            return src
        with stage("pose_drive"):
            size = src.shape[1]
            idx = torch.tensor(drive, device=src.device)

            def to256(x):
                return resize_bilinear(x[idx].permute(0, 3, 1, 2).float() / 255.0, (256, 256)
                                       ).permute(0, 2, 3, 1)

            s256, t256 = to256(src), to256(tgt)
            out = torch.cat([comp.pose_driver.drive(s256[i:i + 1], t256[i:i + 1])
                             for i in range(len(drive))]).to(src.device)
            driven = src.float()
            driven[idx] = resize_bilinear(out.permute(0, 3, 1, 2), (size, size)
                                          ).permute(0, 2, 3, 1) * 255.0
        return driven

    def _enhance(self, img255: torch.Tensor, mode: str | None = None) -> torch.Tensor:
        """Face restoration of (B, S, S, 3) crops (reference :606-643); the
        identity when no enhancer serves the mode."""
        fn = self.comp.enhancers.get(mode or self.cfg.enhancement_mode)
        if fn is None:
            return img255
        return fn(img255.float())

    def _core_swap(self, driven: torch.Tensor, target: torch.Tensor, fused: bool) -> dict:
        """The core swap. Where the float driven crop enters it (`fused`), its
        parse is the 19-class parse the recolor reads, kept as `labels19`."""
        sw = self.swapper
        if not fused:
            return sw.swap_aligned(driven, target)
        b = driven.shape[0]
        masks, sv, labels19 = sw._parse_invert(torch.cat([driven.float(), target.float()]),
                                               with_labels19=True)
        result = sw._merge_synth_composite(masks[:b], masks[b:], sv[:b], sv[b:], target)
        result["labels19"] = labels19
        return result

    def _swap_with_optimized_w(self, driven255: torch.Tensor,
                               target255: torch.Tensor) -> dict:
        """The core swap with per-image W-space refinement (reference
        :483-507): both crops' style vectors refined against the
        reconstruction criterion (`training/optim.py`; LPIPS 0.8, ID 0.1,
        face parsing 0.1 and L2 1.0 for the nets in `loss_params`, L2 alone
        without them), inverted with the full-resolution one-hot as JAX
        does, then merged and synthesised. The float driven crops are read
        as they are, as in JAX. Pairs run one after the other."""
        from e4s2024_torch.losses.recon import ReconCriterion
        from e4s2024_torch.training.optim import optimize_style_vectors

        sw = self.swapper
        crit = ReconCriterion(self.comp.loss_params, device=sw.device)
        out = []
        for d, t in zip(driven255.float(), target255):
            masks, _ = sw._parse_invert(torch.stack([d, t.float()]))
            onehot = torch.nn.functional.one_hot(masks, sw.cfg.num_seg_cls)
            onehot = onehot.permute(0, 3, 1, 2).to(sw.dtype)
            svs = []
            for i, img255 in enumerate((d, t.float())):
                img = (img255.permute(2, 0, 1)[None] / 127.5 - 1.0).to(sw.dtype)
                sv, _ = optimize_style_vectors(
                    sw.rgi, crit, img, onehot[i:i + 1], steps=self.cfg.optimize_w_steps,
                    lr=self.cfg.optimize_w_lr)
                svs.append(sv)
            out.append(sw._merge_synth_composite(masks[0:1], masks[1:2], svs[0], svs[1],
                                                 t[None]))
        return {k: torch.cat([o[k] for o in out]) for k in out[0]}

    def _parse19(self, driven: torch.Tensor, target: torch.Tensor, result: dict):
        """19-class labels (B, 512, 512) of the driven and target crops: the
        core swap's own parse where it read the same float crops, else a parse
        of the float driven crop and the target (JAX's staged path)."""
        both = result.get("labels19")
        if both is None:
            both = self.swapper._parse19(
                torch.cat([driven.float(), target.float()]).permute(0, 3, 1, 2) / 255.0)
        return both[:driven.shape[0]], both[driven.shape[0]:]

    def _recolor_composite(self, rec: torch.Tensor, swapped255: torch.Tensor) -> torch.Tensor:
        """Edge-aware composite of the recolor (B, h, h, 3) onto the swap
        (B, H, H, 3) (reference :910-924): the recolor resized to H, the swap
        kept where its Sobel edges are strong."""
        h = swapped255.shape[1]
        rec = resize_bilinear(rec.permute(0, 3, 1, 2), (h, h))
        swapped = swapped255.float().permute(0, 3, 1, 2)
        edge = torch.clamp(sobel_edge(swapped) / 255.0, 0.0, 1.0)
        out = blend_with_mask(rec, swapped, edge, up_ratio=self.cfg.blend_up_ratio)
        return torch.clamp(out, 0, 255).permute(0, 2, 3, 1)

    def _recolor(self, swapped255, target255, d_label19=None, t_label19=None) -> torch.Tensor:
        """Blender at 256^2, RealESRGAN x4 where 4x the recolor fits in the
        crop, the edge-aware blend (reference :522-560, :910-924); or a
        classical colour transfer, per pair."""
        cfg = self.cfg
        if cfg.ct_mode == "none":
            return swapped255
        if cfg.ct_mode == "blender":
            if self.comp.recolorer is None:
                return swapped255
            rec = self.comp.recolorer.recolor(swapped255, target255, d_label19, t_label19)
            if self.comp.upscaler is not None and rec.shape[1] * 4 <= swapped255.shape[1]:
                rec = self.comp.upscaler.upscale(rec)
            return self._recolor_composite(rec, swapped255)
        out = []
        for s, t in zip(swapped255, target255):
            if cfg.ct_mode in color.DEVICE_MODES:
                gen = torch.Generator(device=s.device).manual_seed(0)
                r = color.skin_color_transfer(s.float() / 255.0, t.float() / 255.0,
                                              cfg.ct_mode, generator=gen)
            else:  # numpy on the host: the swap in float32, the target in float64
                r = torch.from_numpy(np.asarray(color.skin_color_transfer(
                    s.float().cpu().numpy() / 255.0, t.cpu().numpy() / 255.0, cfg.ct_mode),
                    np.float32)).to(s.device)
            out.append(r * 255.0)
        return torch.stack(out)

    def _inpaint_soft_mask(self, hole_mask: torch.Tensor, size: int) -> torch.Tensor:
        """The composite's mask (B, 1, size, size): the hole resized
        bilinearly and soft-eroded (zero wherever the cone filter does not
        reach the hole)."""
        mask = resize_bilinear(hole_mask.float()[:, None], (size, size))
        return soft_erosion_planar(mask)[0]

    def _inpaint_composite(self, img255, out, hole_mask) -> torch.Tensor:
        """Soft-eroded composite of the inpainted face into the hole
        (reference :223-258): (B, H, H, 3) x (B, Hm, Wm). Where the soft mask
        is 0 the image keeps its value exactly."""
        soft = self._inpaint_soft_mask(hole_mask, img255.shape[1]).permute(0, 2, 3, 1)
        return torch.clamp(blend_with_mask(img255.float(), out, soft, 1.0), 0, 255)

    def _inpaint(self, img255: torch.Tensor, hole_mask: torch.Tensor) -> torch.Tensor:
        """GCFSR completion of the hole and the soft composite."""
        if not self.cfg.face_inpainting or self.comp.inpainter is None:
            return img255
        out = self.comp.inpainter.inpaint(img255, hole_mask)
        return self._inpaint_composite(img255, out, hole_mask)

    # ---------------- entry points ----------------

    def _run(self, src: torch.Tensor, tgt: torch.Tensor, timer=None,
             intermediates: bool = False) -> dict:
        """Every stage on (B, S, S, 3) uint8 crops on the device."""
        def timed(name, fn, *a):
            if timer is None:
                return fn(*a)
            with timer.stage(name):
                return fn(*a)

        cfg, comp = self.cfg, self.comp
        fused = self._fused()
        driven = timed("pose_align", self._pose_align, src, tgt, timer)
        driven = timed("enhance", self._enhance, driven,
                       "gpen" if "gpen" in comp.enhancers else None)
        if cfg.optimize_w_steps > 0:
            result = timed("optimize_w_swap", self._swap_with_optimized_w, driven, tgt)
        else:
            result = timed("core_swap", self._core_swap, driven, tgt, fused)
        swapped = result["image"].float()
        if cfg.ct_mode == "blender" and comp.recolorer is not None:
            d19, t19 = timed("parse19", self._parse19, driven, tgt, result)
            swapped = timed("recolor", self._recolor, swapped, tgt, d19, t19)
        elif cfg.ct_mode not in ("none", "blender"):
            swapped = timed("recolor", self._recolor, swapped, tgt)
        swapped = timed("inpaint", self._inpaint, swapped, result["hole_mask"])
        return timed("package", self._package, swapped, driven, result, intermediates)

    def __call__(self, source_crop255, target_crop255, verbose: bool = False, timer=None,
                 return_intermediates: bool = False) -> dict:
        """Swap one pair of aligned (S, S, 3) crops. Returns {"image": (S, S, 3)
        uint8}; `return_intermediates` adds the driven crop (uint8) and the
        swap's `swapped_mask` (uint8) and `hole_mask`. With `timer` (a
        `pipelines.video.StageTimer`) or `verbose`, each stage ends in a
        device synchronisation and the result carries `stage_times` (ms by
        stage: pose_align, enhance, core_swap, parse19, recolor, inpaint,
        package; with a pose driver also pose_gate and pose_drive, which
        pose_align holds)."""
        if timer is None and verbose:
            from e4s2024_torch.pipelines.video import StageTimer

            timer = StageTimer()
        sw = self.swapper
        with torch.inference_mode():
            src, tgt = sw._as_u8(source_crop255)[None], sw._as_u8(target_crop255)[None]
            out = {k: v[0] for k, v in self._run(src, tgt, timer, return_intermediates).items()}
        if timer is not None:
            out["stage_times"] = dict(timer.times)
        return out

    def shard_inference(self, process_group) -> None:
        """Data-parallel serving over a process group, the counterpart of
        JAX's `shard_inference(mesh)`: afterwards `swap_batch` on every
        rank takes the whole pair batch, swaps its contiguous share (rank r
        pairs [r B / w, (r + 1) B / w), as `P("dp")` splits the batch) and
        all-gathers the uint8 outputs, so that every rank returns the whole
        batch, as JAX's one program does. The pairs are independent: no
        collective runs inside the swap. A batch that the world size does
        not divide raises ValueError. JAX serves only its fused program, so
        a configuration that takes the staged path (`_fused`) raises
        RuntimeError here too."""
        if not self._fused():
            raise RuntimeError(
                "sharded serving needs the fused path: disable optimize_W, pose driving "
                "and the classical ct modes, and use components with a fused form")
        self.process_group = process_group

    def swap_batch(self, source_crops255, target_crops255) -> torch.Tensor:
        """Swap B aligned pairs, (B, S, S, 3) -> (B, S, S, 3) uint8: every
        stage runs on the batch, in chunks of `cfg.max_fused_batch` pairs
        (the whole batch when None); the pose gate decides per pair. After
        `shard_inference`, each rank swaps its share and the outputs are
        gathered."""
        from e4s2024_torch.parallel.ddp import gather_rows, shard_rows

        sw, group = self.swapper, self.process_group
        with torch.inference_mode():
            src, tgt = sw._as_u8(source_crops255), sw._as_u8(target_crops255)
            src, tgt = shard_rows(src, group), shard_rows(tgt, group)
            b = src.shape[0]
            chunk = b if self.cfg.max_fused_batch is None else max(1, self.cfg.max_fused_batch)
            out = torch.cat([self._run(src[i:i + chunk], tgt[i:i + chunk])["image"]
                             for i in range(0, b, chunk)])
            return gather_rows(out, group)

    def swap_raw(self, source_img, target_img):
        """Raw-frame entry: detection and alignment (the swapper's landmark
        stack), the zoo-enhanced swap on the crops, perspective paste-back —
        the reference's `FaceSwap.face_swap_pipeline` from unaligned images.
        Returns the (H, W, 3) uint8 numpy frame."""
        return self.swapper.swap(source_img, target_img, swap_fn=self.swap_batch)

    def swap_raw_multi(self, source_img, target_img, **kw):
        """The source identity onto every face detected in the target frame,
        all crops through the zoo-enhanced swap as one batch
        (`FaceSwapper.swap_all`)."""
        return self.swapper.swap_all(source_img, target_img, swap_fn=self.swap_batch, **kw)

    def _package(self, swapped, driven, result, intermediates: bool = False) -> dict:
        out = {"image": torch.clamp(swapped, 0, 255).to(torch.uint8)}
        if intermediates:
            out.update({
                "driven": torch.clamp(driven.float(), 0, 255).to(torch.uint8),
                "swapped_mask": result["swapped_mask"].to(torch.uint8),
                "hole_mask": result["hole_mask"],
            })
        return out
