"""Face swap, the E4S pipeline (reference Face_swap_with_two_imgs.py:796
`face_swap_pipeline`).

Counterpart of `FaceSwapper` in `e4s2024_tpu/pipelines/swap.py`. The
aligned-crop swap `swap_aligned` runs in its staged form:

  1. BiSeNet parse of the driven and target crops -> 12-class maps,
  2. RGI style vectors for both,
  3. swapped mask (swap_head_mask) and mixed style vectors,
  4. regional StyleGAN2 synthesis with the swapped mask,
  5. compositing: soft-eroded content and border masks, linear content
     paste and multi-band border blend against the target.

Stages 1-2 run on the (driven, target) pair as one batch, stages 3-5 on the
swaps. The nets run in `compute_dtype`; compositing runs in float32.

Spans (`utils.observability.span`): `swap_aligned` around the call, and in
the helpers `upload` (each tensor moved to the device), `parse`, `invert`,
`merge`, `synthesis` and `composite`, so that a caller of the helpers (the
zoo's fused core swap) records the same stages under its own span.

The raw-frame entries `swap` and `swap_all` take unaligned uint8 frames:
68-point landmarks (the `landmark_fn` hook, or the RetinaFace + FAN stack of
`pipelines/detect.py`), the FFHQ quad and its crop on the device, the
aligned swap, and a perspective paste-back into the target frame.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from e4s2024_torch import resolve_device
from e4s2024_torch.convert import as_tensors, drop_generator_buffers
from e4s2024_torch.data.labels import FFHQ_TO_12, NUM_SEG_CLASSES, map_labels
from e4s2024_torch.models.bisenet import SEG_MEAN, SEG_STD, BiSeNet, bicubic_downsample
from e4s2024_torch.models.rgi import RGINet, fsencoder_type_of
from e4s2024_torch.ops.blend import laplacian_pyramid_blend_planar, soft_erosion_planar
from e4s2024_torch.ops.morphology import dilation_planar
from e4s2024_torch.ops.resize import resize_bilinear
from e4s2024_torch.pipelines import detect
from e4s2024_torch.pipelines.alignment import (
    as_f32, compute_transform_from_landmarks, crop_quad, paste_back_coefficients,
    quad_from_cxy, warp_perspective)
from e4s2024_torch.pipelines.mask_merge import swap_comp_style_vector, swap_head_mask
from e4s2024_torch.utils.observability import span

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class SwapConfig:
    out_size: int = 1024
    num_seg_cls: int = NUM_SEG_CLASSES
    remaining_layer_idx: int = 13
    outer_dilation: int = 2
    # keep target {bg, glasses, hair, neck, ear, earring} (ct_mode branch,
    # reference Face_swap_with_two_imgs.py:469-473)
    keep_target_components: tuple[int, ...] = (0, 10, 4, 8, 7, 11)
    regional_mode: str = "exact"  # or "fast": per-pixel modulation
    num_blend_levels: int = 10
    # kept for configuration compatibility with the JAX package; the port
    # runs eagerly, so "staged" and "fused" run the same staged code
    jit_mode: str = "staged"
    # dtype of the nets ("bfloat16" or "float32"); compositing is float32
    compute_dtype: str = "float32"



class FaceSwapper:
    """Holds the RGI net and the BiSeNet parser and runs the aligned swap.

    Args:
      rgi_state_dict: RGINet weights in the reference's names (`encoder.*`,
        `G.*`, `MLPs.*`, `latent_avg`), as tensors or numpy arrays; the
        generator's fixed buffers of a reference checkpoint (noise maps, FIR
        kernels) are dropped (`convert.drop_generator_buffers`), every other
        key loads strictly; a SEAN encoder's layout selects that encoder
        (`rgi.fsencoder_type_of`).
      bisenet_state_dict: BiSeNet weights (`cp.*`, `ffm.*`, `conv_out*`).
      config: SwapConfig.
      landmark_fn: (H, W, 3) uint8 frame -> (68, 2) landmarks or None, for
        the raw-frame entries; None builds `detect.default_landmarker` on
        first use.
      device: "cuda" (the default) or "cpu".
      encoder_num_units: IR-SE body depth; the reference's (3, 4, 14, 3)
        unless a small test configuration cuts it.
    """

    def __init__(self, rgi_state_dict: Mapping, bisenet_state_dict: Mapping,
                 config: SwapConfig = SwapConfig(),
                 landmark_fn: Callable | None = None, *, device=None,
                 encoder_num_units: tuple = (3, 4, 14, 3)):
        if config.regional_mode not in ("exact", "fast"):
            raise ValueError(f"regional_mode must be 'exact' or 'fast', "
                             f"got {config.regional_mode!r}")
        if config.compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}")
        self.cfg = config
        self.landmark_fn = landmark_fn
        self.device = resolve_device(device)
        self.dtype = _DTYPES[config.compute_dtype]
        self.rgi = RGINet(num_seg_cls=config.num_seg_cls, out_size=config.out_size,
                          remaining_layer_idx=config.remaining_layer_idx,
                          encoder_num_units=encoder_num_units,
                          fsencoder_type=fsencoder_type_of(rgi_state_dict))
        self.rgi.load_state_dict(as_tensors(drop_generator_buffers(rgi_state_dict)),
                                 strict=True)
        self.bisenet = BiSeNet()
        self.bisenet.load_state_dict(as_tensors(bisenet_state_dict), strict=True)
        for net in (self.rgi, self.bisenet):
            net.to(device=self.device, dtype=self.dtype).eval().requires_grad_(False)
        keep = set(config.keep_target_components)
        self._comp = [c for c in range(config.num_seg_cls) if c not in keep]
        self._seg_mean = torch.tensor(SEG_MEAN, device=self.device).view(1, 3, 1, 1)
        self._seg_std = torch.tensor(SEG_STD, device=self.device).view(1, 3, 1, 1)

    # ---------------- stages ----------------

    def _parse19(self, img01: torch.Tensor) -> torch.Tensor:
        """(B, 3, S, S) in [0, 1] -> (B, 512, 512) 19-class labels (reference
        face_parsing_demo.py:153-171)."""
        h = img01.shape[-2]
        if h > 512:
            x = torch.clamp(bicubic_downsample(img01, h // 512), 0.0, 1.0)
        elif h < 512:
            x = resize_bilinear(img01, (512, 512))
        else:
            x = img01
        x = ((x - self._seg_mean) / self._seg_std).to(self.dtype)
        logits, _, _ = self.bisenet(x, aux=False, upsample=False)
        logits = resize_bilinear(logits.float(), (512, 512), align_corners=True)
        return torch.argmax(logits, dim=1)

    def _parse12(self, img01: torch.Tensor) -> torch.Tensor:
        return map_labels(self._parse19(img01), FFHQ_TO_12)

    def _onehot_for_model(self, labels: torch.Tensor) -> torch.Tensor:
        """(B, K, H, W) one-hot at the highest resolution the nets read: with
        remaining_layer_idx < 17 that is out_size / 2 (at least 32), so the
        labels are subsampled first (nearest, the same as subsampling the
        one-hot)."""
        s = labels.shape[1]
        if self.cfg.remaining_layer_idx < 17:
            target = min(s, max(self.cfg.out_size // 2, 32))
            step = s // target
            if step > 1 and s % target == 0:
                labels = labels[:, ::step, ::step]
        onehot = F.one_hot(labels, self.cfg.num_seg_cls).permute(0, 3, 1, 2)
        return onehot.to(self.dtype).contiguous()

    def _parse_invert(self, pair255: torch.Tensor, with_labels19: bool = False):
        """Stages 1-2 on the (2B, S, S, 3) uint8 (or float [0, 255]) pair
        batch: (12-class masks, style vectors), and with `with_labels19` the
        19-class labels the masks were mapped from."""
        with span("parse", self.device):
            img01 = pair255.permute(0, 3, 1, 2).float() / 255.0
            labels19 = self._parse19(img01)
            masks = map_labels(labels19, FFHQ_TO_12)
        with span("invert", self.device):
            onehot = self._onehot_for_model(masks)
            sv, _ = self.rgi.get_style_vectors((img01 * 2.0 - 1.0).to(self.dtype), onehot)
        return (masks, sv, labels19) if with_labels19 else (masks, sv)

    def _composite(self, swapped_pm1, target_pm1, swapped_msk, hole_mask):
        """Content paste plus multi-band border blend (reference _past_back,
        :159-219). Images (B, 3, S, S) float32 in [-1, 1]; masks (B, Hm, Wm).
        Returns (B, S, S, 3) uint8."""
        cfg = self.cfg
        bg = torch.zeros_like(swapped_msk, dtype=torch.bool)
        for c in (0, 11, 4, 7, 8):
            bg |= swapped_msk == c
        fg = ((~bg) | hole_mask)[:, None].float()

        # erosion(x) == -dilation(-x): one windowed max serves both
        r = cfg.outer_dilation
        both = dilation_planar(torch.cat([fg, -fg], dim=1), 2 * r + 1)
        full, eroded = both[:, 0:1], -both[:, 1:2]
        soft, _ = soft_erosion_planar(torch.cat([full, eroded, fg], dim=1))
        border = torch.clamp(soft[:, 0:1] - soft[:, 1:2], 0.0, 1.0)
        content = soft[:, 2:3]

        size = (cfg.out_size, cfg.out_size)
        cb = resize_bilinear(torch.cat([content, border], dim=1), size)
        content, border = cb[:, 0:1], cb[:, 1:2]

        sw255 = (swapped_pm1 + 1.0) * 127.5
        tg255 = (target_pm1 + 1.0) * 127.5
        out = sw255 * content + tg255 * (1.0 - content)
        out = laplacian_pyramid_blend_planar(tg255, out, border,
                                             num_levels=cfg.num_blend_levels)
        out = torch.clamp(out, 0.0, 255.0).permute(0, 2, 3, 1)
        return out.to(torch.uint8)

    def _synth_and_composite(self, swapped_sv, swapped_mask, hole_mask, t_pm1):
        """Stage 4-5: style codes -> regional synthesis -> composite."""
        with span("synthesis", self.device):
            codes = self.rgi.cal_style_codes(swapped_sv.to(self.dtype))
            onehot = self._onehot_for_model(swapped_mask)
            swapped, _, _ = self.rgi.gen_img(None, codes, onehot,
                                             regional_mode=self.cfg.regional_mode)
        with span("composite", self.device):
            return self._composite(swapped.float(), t_pm1, swapped_mask, hole_mask)

    def _merge_synth_composite(self, d_masks, t_masks, d_sv, t_sv, t255):
        """Stages 3-5 on B swaps. d_masks/t_masks: (B, Hm, Wm) labels;
        d_sv/t_sv: (B, K, D); t255: (B, S, S, 3) uint8."""
        t_pm1 = t255.permute(0, 3, 1, 2).float() / 127.5 - 1.0
        with span("merge", self.device):
            merged = swap_head_mask(d_masks, t_masks)
            swapped_sv = swap_comp_style_vector(t_sv, d_sv, self._comp)
        image = self._synth_and_composite(swapped_sv, merged["mask"],
                                          merged["hole_mask"], t_pm1)
        return {
            "image": image,
            "swapped_mask": merged["mask"],
            "hole_mask": merged["hole_mask"],
            "swapped_style_vectors": swapped_sv,
        }

    # ---------------- entry point ----------------

    def _as_u8(self, x) -> torch.Tensor:
        """To a uint8 [0, 255] tensor on the swapper's device (quantised on
        the host for numpy input, so a quarter of the bytes cross)."""
        with span("upload", self.device):
            if not isinstance(x, torch.Tensor):
                x = np.asarray(x)
                if x.dtype != np.uint8:
                    x = np.clip(x, 0, 255).astype(np.uint8)
                x = torch.from_numpy(x)
            elif x.dtype != torch.uint8:
                x = torch.clamp(x, 0, 255).to(torch.uint8)
            return x.to(self.device)

    def swap_aligned(self, driven255, target255) -> dict:
        """Aligned-crop swap. Inputs (B, S, S, 3) uint8 (or float in
        [0, 255]), numpy or tensors. Returns a dict of tensors on the
        swapper's device: image (B, S, S, 3) uint8, swapped_mask and
        hole_mask (B, 512, 512), swapped_style_vectors (B, 12, 1280)."""
        with span("swap_aligned", self.device), torch.inference_mode():
            d, t = self._as_u8(driven255), self._as_u8(target255)
            b = d.shape[0]
            masks, sv = self._parse_invert(torch.cat([d, t], dim=0))
            return self._merge_synth_composite(masks[:b], masks[b:], sv[:b], sv[b:], t)

    # ---------------- raw frames ----------------

    def ensure_landmark_fn(self):
        """The active landmark callable; builds the RetinaFace + FAN stack
        (`detect.default_landmarker`, on this swapper's device) on first use
        when none was supplied."""
        if self.landmark_fn is None:
            self.landmark_fn = detect.default_landmarker(device=self.device)
        return self.landmark_fn

    @staticmethod
    def _hook_input(fn, img, frame: torch.Tensor):
        """What a landmark hook reads: the package's detector the frame
        already uploaded, any other hook the frame as it was given."""
        return frame if isinstance(fn, detect.FaceLandmarkDetector) else img

    def _crop(self, frame: torch.Tensor, quads) -> torch.Tensor:
        """Aligned crops (..., S, S, 3) float32 of quads (..., 4, 2) (float64
        frame coordinates, as float32 quad + 0.5 like the JAX package)."""
        return crop_quad(frame, as_f32(np.asarray(quads) + 0.5, self.device), self.cfg.out_size)

    def _swap_crops(self, src: torch.Tensor, tgt: torch.Tensor, swap_fn) -> torch.Tensor:
        """(B, S, S, 3) float crops -> swapped (B, S, S, 3) float32."""
        if swap_fn is not None:
            return torch.as_tensor(swap_fn(src, tgt)).to(self.device).float()
        return self.swap_aligned(src, tgt)["image"].float()

    def _paste_back(self, frame: torch.Tensor, swapped: torch.Tensor, quads) -> np.ndarray:
        """Alpha-composite each swapped crop over the frame through its quad's
        inverse perspective (reference :264-279); the alpha is the warped
        all-ones plane, gathered with the crop as a fourth channel."""
        s = self.cfg.out_size
        out = frame.float()
        ones = torch.ones(s, s, 1, device=self.device)
        for crop, quad in zip(swapped, quads):
            coeffs = as_f32(paste_back_coefficients(quad, s), self.device)
            warped = warp_perspective(torch.cat([crop, ones], dim=-1), coeffs, frame.shape[:2])
            alpha = warped[..., 3:]
            out = warped[..., :3] * alpha + out * (1.0 - alpha)
        return torch.clamp(out, 0, 255).to(torch.uint8).cpu().numpy()

    def swap(self, source_img, target_img, swap_fn=None) -> np.ndarray:
        """Swap from raw frames: landmarks, FFHQ crop, aligned swap, paste-back.

        source/target: (H, W, 3) uint8 frames. Returns the target frame with
        the swapped face pasted back, (H, W, 3) uint8 numpy. `swap_fn`
        optionally replaces the aligned swap with another
        (B, S, S, 3) -> (B, S, S, 3) uint8 swap, e.g.
        FullFaceSwapPipeline.swap_batch."""
        landmark_fn = self.ensure_landmark_fn()
        crops, quads, frame = [], [], None
        for name, img in (("source", source_img), ("target", target_img)):
            frame = detect.upload(img, self.device)
            lm = landmark_fn(self._hook_input(landmark_fn, img, frame))
            if lm is None:
                raise ValueError(f"no face found in the {name} image (no detection "
                                 "cleared the confidence threshold)")
            quads.append(quad_from_cxy(*compute_transform_from_landmarks(lm)))
            crops.append(self._crop(frame, quads[-1])[None])
        swapped = self._swap_crops(crops[0], crops[1], swap_fn)
        return self._paste_back(frame, swapped, quads[1:])

    def swap_all(self, source_img, target_img, swap_fn=None, max_faces: int = 8,
                 min_score: float = 0.5) -> np.ndarray:
        """The source identity onto every face detected in the target frame:
        all target crops go through the aligned swap as one batch, then are
        pasted back face by face.

        Needs a landmark stack with `detect_all` (the package's
        FaceLandmarkDetector); a single-face hook raises. Faces below
        `min_score` are skipped, at most `max_faces` (by score) are swapped,
        and a face with degenerate landmarks is skipped with a warning.
        Returns the frame unchanged when no face is found."""
        landmark_fn = self.ensure_landmark_fn()
        if not hasattr(landmark_fn, "detect_all"):
            raise RuntimeError(
                "swap_all needs the detector stack (pipelines.detect.FaceLandmarkDetector); "
                "the configured landmark_fn hook only yields one face — use swap() or "
                "supply a FaceLandmarkDetector")
        src = detect.upload(source_img, self.device)
        src_lm = landmark_fn(self._hook_input(landmark_fn, source_img, src))
        if src_lm is None:
            raise ValueError("no face detected in the source image")
        src_crop = self._crop(src, quad_from_cxy(*compute_transform_from_landmarks(src_lm)))

        frame = detect.upload(target_img, self.device)
        _, scores, _, lm68 = landmark_fn.detect_all(
            self._hook_input(landmark_fn, target_img, frame))
        order = np.argsort(np.asarray(scores))[::-1][:max_faces]
        order = [i for i in order if float(scores[i]) >= min_score]
        if not order:
            return np.asarray(target_img, np.uint8)
        quads = []
        for i in order:
            # one degenerate detection in a group photo must not abort the
            # good swaps: skip it (warn) and keep going
            try:
                quads.append(quad_from_cxy(*compute_transform_from_landmarks(
                    np.asarray(lm68[i]))))
            except ValueError as e:
                warnings.warn(f"skipping face {i}: {e}")
        if not quads:
            raise ValueError(f"all {len(order)} detected faces had degenerate landmarks "
                             "— nothing usable to swap")
        tgt_batch = self._crop(frame, np.stack(quads))
        swapped = self._swap_crops(src_crop[None].expand_as(tgt_batch), tgt_batch, swap_fn)
        return self._paste_back(frame, swapped, quads)
