"""Video face swapping, batched over frames on one device.

Counterpart of `e4s2024_tpu/pipelines/video.py` (the reference's 9-stage
`FaceSwapVideoPipeline`, face_swap_video_pipeline.py:71). The clip crosses
to the device once as a uint8 stack; every stage consumes and produces
device tensors, and only the composed frames come back, by asynchronous
copies into pinned memory overlapped with the remaining chunks.

Stages:
  1. detect and crop every frame with temporally smoothed quads,
  2. (hooks) drive the source crop toward each frame, enhance it,
  2b. per-frame recolor targets for PTI's guidance,
  3. parse, 4. invert all frames (driven and target),
  5. swapped masks and mixed style vectors,
  5b. PTI generator tuning on the clip (`training.pti.PTICoach`),
  6b. boundary-stitching tuning (`StitchingCoach`) against the swapped
      synthesis,
  7. synthesis, compositing and perspective paste-back in chunks.

The tuned weights are written back into the swapper (as the JAX package
writes them into `swapper.rgi_variables`), so a second clip through the same
pipeline starts from the first clip's tuned generator. The coaches tune the
swapper's net in its own dtype: a bfloat16 swapper's weights are tuned in
bfloat16, as the JAX package tunes the bfloat16 variables of such a
swapper; for a float32 swapper `PTIConfig.compute_dtype` and
`StitchingConfig.compute_dtype` set the precision of the steps. Video files
are read and written by `e4s2024_torch.video_io`; this module takes frames
as arrays.

With `process_group=` (JAX's `mesh=`) both tunes run over the group, each
rank on its contiguous share of the clip's frames (`training.pti`); every
other stage runs on every rank over the whole clip, so every rank returns
the same frames, and only rank 0 (`is_output_rank`) should write them out.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Callable, Mapping

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from e4s2024_torch.ops.resize import resize_bilinear
from e4s2024_torch.pipelines import detect
from e4s2024_torch.pipelines.alignment import (
    as_f32, compute_transform_from_landmarks, crop_quad, paste_back_coefficients,
    quad_from_cxy, smooth_video_quads, warp_perspective)
from e4s2024_torch.pipelines.mask_merge import swap_comp_style_vector, swap_head_mask
from e4s2024_torch.pipelines.swap import FaceSwapper, SwapConfig
from e4s2024_torch.training.pti import PTICoach, PTIConfig, StitchingCoach, StitchingConfig
from e4s2024_torch.utils.observability import StageTimer


def _to_u8(x: torch.Tensor) -> torch.Tensor:
    """Float [0, 255] -> uint8, rounding half to even as the JAX package's
    `jnp.rint`."""
    return torch.clamp(torch.round(x), 0.0, 255.0).to(torch.uint8)


def _chunked(fn, b: int, *arrs):
    """`fn` over the leading axis in chunks of `b`, the trailing chunk
    padded (by repeating the last row) so that every call sees `b` rows;
    outputs, tensors or tuples of tensors, concatenated and cut back."""
    n = int(arrs[0].shape[0])
    padded = [detect.pad_to_chunk(a, b)[0] for a in arrs]
    outs = [fn(*(p[i:i + b] for p in padded)) for i in range(0, int(padded[0].shape[0]), b)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts)[:n] for parts in zip(*outs))
    return torch.cat(outs)[:n]


def _paste_back(crops_u8: torch.Tensor, frames_u8: torch.Tensor,
                coeffs: torch.Tensor) -> torch.Tensor:
    """Warp swapped crops (B, S, S, 3) onto frames (B, H, W, 3) through
    their inverse perspectives (B, 8) and alpha-compose; the alpha is the
    warped all-ones plane, gathered with the crop as a fourth channel.
    Returns (B, H, W, 3) uint8."""
    ones = torch.ones(*crops_u8.shape[:-1], 1, device=crops_u8.device)
    warped = warp_perspective(torch.cat([crops_u8.float(), ones], dim=-1), coeffs,
                              tuple(frames_u8.shape[1:3]))
    alpha = warped[..., 3:]
    out = warped[..., :3] * alpha + frames_u8.float() * (1.0 - alpha)
    return torch.clamp(out, 0.0, 255.0).to(torch.uint8)


def _to_host_async(t: torch.Tensor):
    """Start the copy of `t` into host memory: pinned and asynchronous from
    a card, with an event to wait on. Returns (host tensor, event or None)."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


@dataclass
class VideoSwapConfig:
    swap: SwapConfig = field(default_factory=SwapConfig)
    pti: PTIConfig = field(default_factory=PTIConfig)
    stitching: StitchingConfig = field(default_factory=StitchingConfig)
    center_sigma: float = 1.0
    xy_sigma: float = 3.0
    run_pti: bool = True
    # boundary-stitching tune after the swap synthesis (reference
    # face_swap_video_pipeline.py:356-390); max_steps=0 or False skips it
    run_stitching: bool = True
    frames_per_batch: int = 4


class FaceSwapVideoPipeline:
    """Swap `source_img`'s identity into every frame of a clip.

    `swapper` provides the nets (float32 or bfloat16); `loss_params` the criterion's
    nets for PTI and stitching ("lpips", "arcface", "parser": modules or
    state dicts). Hooks, all optional: `driven_hook(source_crop,
    target_crops)` poses the source toward each frame (numpy in, (F, S, S,
    3) out; without it every frame uses the source crop); `enhancer` with
    `enhance_aligned((B, S, S, 3) [0, 255]) -> same shape`;
    `recolorer` with `recolor(imgA255, imgT255, a19, t19)`, the PTI recolor
    targets. After a call, `histories` holds the tunes' per-step metrics.
    `process_group` tunes over a group (see the module docstring).
    """

    def __init__(self, swapper: FaceSwapper, cfg: VideoSwapConfig = VideoSwapConfig(),
                 loss_params: Mapping | None = None,
                 driven_hook: Callable | None = None, recolorer=None, enhancer=None,
                 process_group=None):
        self.swapper, self.cfg, self.process_group = swapper, cfg, process_group
        self.loss_params = loss_params or {}
        self.driven_hook, self.recolorer, self.enhancer = driven_hook, recolorer, enhancer
        self.histories: dict[str, list] = {}

    @property
    def device(self) -> torch.device:
        return self.swapper.device

    @property
    def is_output_rank(self) -> bool:
        """Whether this process writes the output: rank 0 of the group, or
        the one process without a group."""
        return self.process_group is None or dist.get_rank(self.process_group) == 0

    # ---------------- stage 1: alignment ----------------

    def align_frames(self, frames: list[np.ndarray], dev_frames: torch.Tensor | None = None):
        """Crop every frame with temporally smoothed quads. Returns (crops
        (F, S, S, 3) float32 [0, 255] on the device, quads (host)).

        A landmark stack with `landmarks_video` (the package's detector)
        runs batched over a same-size clip, and a frame whose best score is
        under the stack's `min_score` raises; any other hook runs frame by
        frame on the numpy frames. Pass `dev_frames`, the clip already
        uploaded as a uint8 stack, to cross to the device only once."""
        s = self.swapper.cfg.out_size
        landmark_fn = self.swapper.ensure_landmark_fn()
        same_size = len({f.shape for f in frames}) == 1
        if same_size and dev_frames is None:
            dev_frames = detect.upload(np.stack(frames), self.device)
        if same_size and hasattr(landmark_fn, "landmarks_video"):
            lms, scores = landmark_fn.landmarks_video(dev_frames,
                                                      chunk=self.cfg.frames_per_batch * 4)
            min_score = getattr(landmark_fn, "min_score", None)
            if min_score is not None:
                bad = np.flatnonzero(np.asarray(scores) < min_score)
                if bad.size:
                    raise ValueError(
                        f"no face above score {min_score} in frames "
                        f"{bad[:8].tolist()}{'...' if bad.size > 8 else ''} "
                        f"({bad.size}/{len(frames)} frames)")
        else:
            lms = [landmark_fn(f) for f in frames]
            missing = [i for i, lm in enumerate(lms) if lm is None]
            if missing:
                raise ValueError(f"no face found in frames {missing[:8]}")
        cs, xs, ys = zip(*(compute_transform_from_landmarks(lm) for lm in lms))
        quads = smooth_video_quads(cs, xs, ys, self.cfg.center_sigma, self.cfg.xy_sigma)
        quads_t = as_f32(np.stack(quads) + 0.5, self.device)
        if same_size:
            crops = _chunked(lambda f, q: crop_quad(f, q, s), self.cfg.frames_per_batch * 4,
                             dev_frames, quads_t)
        else:
            crops = torch.stack([crop_quad(detect.upload(f, self.device), q, s)
                                 for f, q in zip(frames, quads_t)])
        return crops, quads

    # ---------------- stages 3-4: parse and invert ----------------

    def parse_frames(self, crops255: torch.Tensor) -> torch.Tensor:
        """(F, S, S, 3) [0, 255] -> (F, 512, 512) 12-class labels."""
        return _chunked(lambda c: self.swapper._parse12(c.permute(0, 3, 1, 2).float() / 255.0),
                        self.cfg.frames_per_batch, crops255)

    def style_vectors(self, crops255: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """(F, S, S, 3) [0, 255] and their labels -> (F, 12, 1280)."""
        sw = self.swapper

        def f(c, lb):
            pm1 = c.permute(0, 3, 1, 2).float() / 127.5 - 1.0
            # the full-resolution one-hot, as the JAX package's video path
            # gives it (the swapper's subsampled one is the same only where
            # out_size / 2 is the labels' resolution)
            onehot = F.one_hot(lb, sw.cfg.num_seg_cls).permute(0, 3, 1, 2).to(sw.dtype)
            return sw.rgi.get_style_vectors(pm1.to(sw.dtype), onehot)[0]

        return _chunked(f, self.cfg.frames_per_batch, crops255, labels)

    # ---------------- stage 2: hooks ----------------

    def enhance_frames(self, driven255: torch.Tensor) -> torch.Tensor:
        """Batched enhancement of the driven crops through the `enhancer`."""
        return _chunked(
            lambda d: torch.as_tensor(self.enhancer.enhance_aligned(d.float()),
                                      device=self.device).float(),
            self.cfg.frames_per_batch, driven255)

    def recolor_targets(self, driven255: torch.Tensor, t_crops255: torch.Tensor) -> torch.Tensor:
        """Per-frame recolor of each driven crop toward its target frame's
        colours, PTI's guidance images (reference
        face_swap_video_pipeline.py:287-300); the driven crops themselves
        without a recolorer."""
        if self.recolorer is None:
            return driven255
        sw, s = self.swapper, driven255.shape[1]

        def f(d, t):
            d, t = d.float(), t.float()
            d19 = sw._parse19(d.permute(0, 3, 1, 2) / 255.0)
            t19 = sw._parse19(t.permute(0, 3, 1, 2) / 255.0)
            rec = torch.as_tensor(self.recolorer.recolor(d, t, d19, t19),
                                  device=self.device).float()
            if rec.shape[1] != s:
                rec = resize_bilinear(rec.permute(0, 3, 1, 2), (s, s)).permute(0, 2, 3, 1)
            return rec

        return _chunked(f, self.cfg.frames_per_batch, driven255, t_crops255)

    # ---------------- stage 6b: the stitching targets ----------------

    def _gen_raw(self, svs: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        """The swapped faces without compositing, (F, S, S, 3) float32 in
        [-1, 1]: the stitching tune's content targets."""
        sw = self.swapper

        def f(sv, mask):
            codes = sw.rgi.cal_style_codes(sv.to(sw.dtype))
            img, _, _ = sw.rgi.gen_img(None, codes, sw._onehot_for_model(mask),
                                       regional_mode=sw.cfg.regional_mode)
            return img.float().permute(0, 2, 3, 1)

        return _chunked(f, self.cfg.frames_per_batch, svs, masks)

    # ---------------- the whole clip ----------------

    def _write_back(self, state: Mapping) -> None:
        self.swapper.rgi.load_state_dict(state, strict=True)

    def __call__(self, source_img: np.ndarray, frames: list[np.ndarray], verbose: bool = False,
                 timer=None, dev_frames: torch.Tensor | None = None) -> list[np.ndarray]:
        """Swap into every frame. source_img and frames: (H, W, 3) uint8.
        `timer` (anything with a `stage(name, sync=)` context manager, e.g.
        `StageTimer`) records per-stage wall times; `verbose` prints them.
        Pass `dev_frames` (the (F, H, W, 3) uint8 stack already on the
        device) when the caller uploaded the clip itself. Returns the
        frames, (H, W, 3) uint8 numpy each."""
        if timer is None and verbose:
            timer = StageTimer()
        out = self._run(source_img, frames, timer, dev_frames)
        if verbose:
            print({k: round(v, 2) for k, v in timer.times.items()})
        return out

    def _run(self, source_img, frames, timer, dev_frames):
        sw, cfg = self.swapper, self.cfg
        s, b, n = sw.cfg.out_size, cfg.frames_per_batch, len(frames)

        def stage(name):
            return timer.stage(name, sync=None) if timer is not None else contextlib.nullcontext()

        same_size = len({f.shape for f in frames}) == 1
        if dev_frames is None and same_size:
            dev_frames = detect.upload(np.stack(frames), self.device)

        with torch.no_grad():
            with stage("detect_align"):
                t_crops, t_quads = self.align_frames(frames, dev_frames)
            landmark_fn = sw.ensure_landmark_fn()
            src = detect.upload(source_img, self.device)
            lm = landmark_fn(sw._hook_input(landmark_fn, source_img, src))
            if lm is None:
                raise ValueError("no face found in the source image")
            s_crop = sw._crop(src, quad_from_cxy(*compute_transform_from_landmarks(lm)))

            with stage("drive_enhance"):
                if self.driven_hook is not None:
                    driven = torch.as_tensor(
                        np.asarray(self.driven_hook(s_crop.cpu().numpy(), t_crops.cpu().numpy())),
                        device=self.device).float()
                else:
                    driven = s_crop[None].repeat(n, 1, 1, 1)
                if self.enhancer is not None:
                    driven = self.enhance_frames(driven)
            with stage("recolor_targets"):
                recolor_frames = self.recolor_targets(driven, t_crops)
            with stage("parse"):
                d_labels = self.parse_frames(driven)
                t_labels = self.parse_frames(t_crops)
            with stage("invert"):
                d_sv = self.style_vectors(driven, d_labels)
                t_sv = self.style_vectors(t_crops, t_labels)
            with stage("mask_merge"):
                merged = swap_head_mask(d_labels, t_labels)
                swapped_svs = swap_comp_style_vector(t_sv, d_sv, sw._comp)
                merged_masks, holes = merged["mask"], merged["hole_mask"]

        self.histories = {}
        if cfg.run_pti and cfg.pti.max_pti_steps > 0:
            with stage("pti_tune"):
                coach = PTICoach(sw.rgi, self.loss_params, cfg.pti, self.process_group)
                state, self.histories["pti"] = coach.tune(
                    None, frames=_to_u8(driven), labels=d_labels.to(torch.uint8),
                    style_vectors=d_sv, recolor=_to_u8(recolor_frames))
                self._write_back(state)
                del coach, state

        if cfg.run_stitching and cfg.stitching.max_steps > 0:
            with stage("stitching_tune"):
                with torch.no_grad():
                    content = self._gen_raw(swapped_svs, merged_masks)
                stitcher = StitchingCoach(sw.rgi, self.loss_params, cfg.stitching,
                                          self.process_group)
                state, self.histories["stitching"] = stitcher.tune(
                    None, content_imgs=content, border_imgs=_to_u8(t_crops),
                    labels=merged_masks.to(torch.uint8), style_vectors=swapped_svs)
                self._write_back(state)
                del stitcher, state, content

        with torch.no_grad():
            with stage("synth_composite_pasteback"):
                coeffs = as_f32(np.stack([paste_back_coefficients(q, s) for q in t_quads]),
                                self.device)
                t_pm1 = t_crops.permute(0, 3, 1, 2) / 127.5 - 1.0
                if dev_frames is None:
                    # mixed frame sizes: batched synthesis, paste-back frame
                    # by frame
                    out255 = _chunked(sw._synth_and_composite, b, swapped_svs, merged_masks,
                                      holes, t_pm1)
                    return [_paste_back(out255[i:i + 1],
                                        detect.upload(f, self.device)[None],
                                        coeffs[i:i + 1])[0].cpu().numpy()
                            for i, f in enumerate(frames)]
                chunks = []
                for i in range(0, n, b):
                    k = min(b, n - i)

                    def pick(a):
                        part = a[i:i + k]
                        return detect.pad_to_chunk(part, b)[0] if k < b else part

                    out255 = sw._synth_and_composite(pick(swapped_svs), pick(merged_masks),
                                                     pick(holes), pick(t_pm1))
                    composed = _paste_back(out255, pick(dev_frames), pick(coeffs))
                    chunks.append((*_to_host_async(composed), k))
            with stage("d2h_gather"):
                outputs = []
                for host, event, k in chunks:
                    if event is not None:
                        event.synchronize()
                    outputs.extend(host[:k].numpy())
        return outputs
