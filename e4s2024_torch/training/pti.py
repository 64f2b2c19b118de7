"""PTI per-video generator tuning and boundary-stitching tuning.

Counterpart of `e4s2024_tpu/training/pti.py` (reference
training/video_swap_ft_coach.py:239 and video_swap_stich_coach.py:208), on
one device:

- `PTICoach` tunes the generator so that every frame's fixed style vectors
  reconstruct the driven frames, plus a foreground-masked recolor term; one
  optimizer step takes the frame-MEAN gradient of the clip (or of a
  mini-batch of `frames_per_step` frames), accumulated over chunks of
  `frames_per_chunk` frames.
- `StitchingCoach` tunes it so that synthesis matches the PTI result in the
  face (content) region and the target frame in the dilated border ring.

Both step in a plain loop: the JAX package's `scan_steps`, which fuses
optimizer steps into one XLA program, has no counterpart here. Adam runs over the parameters that
`_g_trainable_mask` selects (torch's Adam is optax's: eps outside the square
root); the rest are frozen. `remat` recomputes the synthesis in the backward
pass (`torch.utils.checkpoint`).

Precision, as in the JAX package: the master weights keep the net's dtype.
A float32 net with `compute_dtype="bfloat16"` casts, in every step, its
parameters and buffers, the frames, the one-hot, the style vectors and the
recolor targets to bfloat16, runs the synthesis and the losses in bfloat16
(the loss nets in float32 on the bfloat16 images), and takes the gradients
back through the cast in float32. A bfloat16 net (a bfloat16 swapper's) is
tuned in bfloat16 whatever `compute_dtype` says, as the JAX package tunes
the bfloat16 variables and style vectors of such a swapper. Adam runs on
the master weights; the loss and metrics come back in float32.

`tune` works on a copy of the coach's net and returns its tuned state dict
and the per-step metrics as host floats, fetched once at the end; the net
it was given is left as it was.
"""

from __future__ import annotations

import copy
import itertools
from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from e4s2024_torch.losses.recon import ReconCriterion
from e4s2024_torch.models.rgi import RGINet
from e4s2024_torch.ops.morphology import dilation, erosion
from e4s2024_torch.ops.resize import resize_bilinear
from e4s2024_torch.training.coach import TrainConfig, _g_trainable_mask

# non-face classes of the 12-class map: background, hair, earring
_NON_FACE = (0, 4, 11)
# the recolor term's foreground (reference video_swap_ft_coach.py:296-300)
_RECOLOR_FG = (1, 2, 3, 5, 6, 7, 8, 9, 10)
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def to_pm1_f32(x: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [-1, 1]; float input passes through."""
    if x.dtype == torch.uint8:
        return x.float() / 127.5 - 1.0
    return x


def _non_face(label: torch.Tensor) -> torch.Tensor:
    return (label == 0) | (label == 4) | (label == 11)


def eroded_label_map(label: torch.Tensor, radius: int = 3) -> torch.Tensor:
    """Erode the face region of a (B, H, W) 12-class map; non-face pixels
    and pixels eroded away become background (reference
    video_swap_ft_coach.py:64-93)."""
    face = (~_non_face(label))[:, None].float()
    eroded = erosion(face, 2 * radius + 1)[:, 0] > 0.5
    return torch.where(eroded, label, torch.zeros_like(label))


def foreground_mask_from_label(label: torch.Tensor, size: int) -> torch.Tensor:
    """(B, H, W) -> (B, 1, size, size) float foreground (not background,
    hair or earring), resized bilinearly."""
    fg = (~_non_face(label))[:, None].float()
    return resize_bilinear(fg, (size, size))


def _largest_divisor(n: int, at_most: int) -> int:
    return max(d for d in range(1, at_most + 1) if n % d == 0)


def _chunks(m: int, per_chunk: int | None) -> list[slice]:
    """Equal slices of m rows: the largest divisor of m at or below
    `per_chunk` each, so the chunks' mean is the whole's."""
    cs = _largest_divisor(m, per_chunk) if per_chunk and m > per_chunk else m
    return [slice(i, i + cs) for i in range(0, m, cs)]


@dataclass
class PTIConfig:
    """Reference defaults: gradio_swap.py:146-148,
    our_swap_face_pipeline_options.py:20-45."""

    max_pti_steps: int = 80
    learning_rate: float = 1e-3
    recolor_lambda: float = 5.0
    erode_radius: int = 3
    erode: bool = False
    lpips_lambda: float = 0.8
    id_lambda: float = 0.1
    face_parsing_lambda: float = 0.1
    l2_lambda: float = 1.0
    regional_mode: str = "exact"
    # recompute the synthesis in the backward pass (torch.utils.checkpoint)
    remat: bool = True
    # gradient accumulation over chunks of the largest divisor of the frame
    # count at or below this; the objective is the same at any divisor.
    # Peak memory by chunk on an H100 is in PERF.md.
    frames_per_chunk: int | None = 2
    # each step on a mini-batch of this many frames, drawn as the JAX
    # package draws them (a permutation from sample_seed, consumed
    # frames_per_step at a time, reshuffled when exhausted); None: whole clip
    frames_per_step: int | None = None
    # "bfloat16" runs the synthesis and the losses in bfloat16; the master
    # weights and Adam stay in the net's dtype
    compute_dtype: str = "float32"
    sample_seed: int = 0


@dataclass
class StitchingConfig:
    """Reference defaults: our_swap_face_pipeline_options.py:19,33,36."""

    max_steps: int = 100
    learning_rate: float = 1e-2
    outer_dilation: int = 15
    lpips_lambda: float = 0.8
    id_lambda: float = 0.0
    face_parsing_lambda: float = 0.0
    l2_lambda: float = 1.0
    regional_mode: str = "exact"
    remat: bool = True
    frames_per_chunk: int | None = 2
    # as PTIConfig's (the JAX package's StitchingConfig has no such field
    # and tunes in its variables' dtype)
    compute_dtype: str = "float32"


class _Synthesis(nn.Module):
    """An RGINet's style codes and regional synthesis as one forward, for
    `functional_call` on cast weights."""

    def __init__(self, net: RGINet, regional_mode: str):
        super().__init__()
        self.net, self.regional_mode = net, regional_mode

    def forward(self, style_vectors, onehot):
        codes = self.net.cal_style_codes(style_vectors)
        img, _, _ = self.net.gen_img(None, codes, onehot, regional_mode=self.regional_mode)
        return img


class _Coach:
    """What both coaches share: the working copy, the optimizer over the
    trainable set, the (optionally recomputed) synthesis, the step over
    chunks and the metrics fetched once."""

    def __init__(self, net: RGINet, loss_params: Mapping, cfg):
        if cfg.compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, "
                             f"got {cfg.compute_dtype!r}")
        self.net, self.cfg = net, cfg
        # the steps' dtype: compute_dtype for float32 master weights, the
        # master dtype for lower-precision ones
        master = net.latent_avg.dtype
        self.compute_dtype = _DTYPES[cfg.compute_dtype] if master == torch.float32 else master
        self.device = net.latent_avg.device
        self.criterion = ReconCriterion(
            loss_params, lpips_lambda=cfg.lpips_lambda, id_lambda=cfg.id_lambda,
            face_parsing_lambda=cfg.face_parsing_lambda, l2_lambda=cfg.l2_lambda,
            device=self.device)

    def _working_copy(self, state: Mapping | None):
        """A copy of the net in its own dtype (the master weights) with
        `state` loaded, grad on exactly the trainable set, and Adam over it."""
        work = copy.deepcopy(self.net)
        if state is not None:
            work.load_state_dict(state, strict=True)
        mask = _g_trainable_mask(
            (n for n, _ in work.named_parameters()),
            TrainConfig(out_size=work.G.size, remaining_layer_idx=work.remaining_layer_idx))
        params = []
        for name, p in work.named_parameters():
            p.requires_grad_(mask[name])
            if mask[name]:
                params.append(p)
        return work, torch.optim.Adam(params, lr=self.cfg.learning_rate)

    def _synth(self, work: RGINet, style_vectors: torch.Tensor, onehot: torch.Tensor):
        synthesis = _Synthesis(work, self.cfg.regional_mode)
        dt = self.compute_dtype

        def synth(sv, oh):
            if work.latent_avg.dtype == dt:
                return synthesis(sv, oh)
            # the synthesis's weights (not the encoder's) cast to the compute
            # dtype; their gradients come back through the cast in the
            # master dtype
            cast = {f"net.{n}": t.to(dt)
                    for n, t in itertools.chain(work.named_parameters(), work.named_buffers())
                    if t.is_floating_point() and not n.startswith("encoder.")}
            return functional_call(synthesis, cast, (sv, oh))

        if self.cfg.remat:
            return checkpoint(synth, style_vectors, onehot, use_reentrant=False)
        return synth(style_vectors, onehot)

    def _onehot(self, labels: torch.Tensor) -> torch.Tensor:
        """(c, Hm, Wm) ints -> (c, K, Hm, Wm) one-hot in the compute dtype."""
        onehot = F.one_hot(labels.long(), self.net.num_seg_cls).permute(0, 3, 1, 2)
        return onehot.to(self.compute_dtype)

    def _images(self, x: torch.Tensor) -> torch.Tensor:
        """(c, S, S, 3) uint8 or float [-1, 1] -> (c, 3, S, S) in [-1, 1] in
        the compute dtype."""
        return to_pm1_f32(x).permute(0, 3, 1, 2).to(self.compute_dtype)

    def _step(self, work, opt, inputs: tuple, rows: slice | torch.Tensor) -> dict:
        """One optimizer step on the mean gradient over `rows` of the
        inputs, accumulated chunk by chunk."""
        if isinstance(rows, torch.Tensor):
            inputs = tuple(x[rows] for x in inputs)
            rows = slice(0, int(rows.numel()))
        m = rows.stop - rows.start
        parts = _chunks(m, self.cfg.frames_per_chunk)
        opt.zero_grad(set_to_none=True)
        acc: dict[str, torch.Tensor] = {}
        for part in parts:
            sl = slice(rows.start + part.start, rows.start + part.stop)
            loss, metrics = self._chunk_loss(work, *(x[sl] for x in inputs))
            loss.backward()
            for k, v in metrics.items():
                v = v.detach().float()
                acc[k] = acc[k] + v if k in acc else v
        if len(parts) > 1:
            grads = [p.grad for g in opt.param_groups for p in g["params"] if p.grad is not None]
            torch._foreach_div_(grads, len(parts))
            acc = {k: v / len(parts) for k, v in acc.items()}
        opt.step()
        return acc

    @staticmethod
    def _sync_history(history: list[dict]) -> list[dict[str, float]]:
        """Per-step metric tensors -> host floats, one copy per key."""
        if not history:
            return []
        flat = {k: torch.stack([h[k].float() for h in history]).cpu().tolist()
                for k in history[0]}
        return [{k: v[i] for k, v in flat.items()} for i in range(len(history))]

    def _as_device(self, *arrays) -> tuple:
        return tuple(torch.as_tensor(a).to(self.device) for a in arrays)


class PTICoach(_Coach):
    """Per-video generator tune on one device."""

    def __init__(self, net: RGINet, loss_params: Mapping, cfg: PTIConfig = PTIConfig()):
        super().__init__(net, loss_params, cfg)

    def _chunk_loss(self, work, frames, labels, style_vectors, recolor):
        """Loss and metrics of one chunk. frames and recolor (c, S, S, 3)
        uint8 or float [-1, 1]; labels (c, Hm, Wm) ints, one-hot here."""
        cfg = self.cfg
        frames, recolor = self._images(frames), self._images(recolor)
        onehot = self._onehot(labels)
        recon = self._synth(work, style_vectors.to(self.compute_dtype), onehot)
        loss, metrics = self.criterion(recon, frames)
        fg = onehot[:, list(_RECOLOR_FG)].amax(dim=1, keepdim=True)
        fg = resize_bilinear(fg, tuple(recon.shape[-2:]))
        rloss, _ = self.criterion(recon * fg, recolor * fg)
        loss = loss + cfg.recolor_lambda * rloss
        metrics["loss_recolor"] = rloss
        metrics["loss"] = loss
        return loss, metrics

    def tune(self, state: Mapping | None, frames, labels, style_vectors, recolor,
             steps: int | None = None):
        """Tune the generator on a clip, starting from `state` (a state dict
        of the coach's net; None: the net's own weights).

        frames, recolor: (F, S, S, 3) uint8 [0, 255] or float [-1, 1];
        labels: (F, Hm, Wm) 12-class ints (uint8 welcome); style_vectors:
        (F, K, 1280). Returns (tuned state dict, per-step metrics)."""
        cfg = self.cfg
        frames, labels, style_vectors, recolor = self._as_device(
            frames, labels, style_vectors, recolor)
        if cfg.erode:
            labels = eroded_label_map(labels, cfg.erode_radius)
        work, opt = self._working_copy(state)
        inputs = (frames, labels, style_vectors, recolor)
        f = frames.shape[0]
        n_steps = cfg.max_pti_steps if steps is None else steps
        if cfg.frames_per_step and f > cfg.frames_per_step:
            # the JAX package's draw: a permutation consumed frames_per_step
            # at a time, reshuffled when exhausted
            m, prng = cfg.frames_per_step, np.random.default_rng(cfg.sample_seed)
            perm, pos, rows = prng.permutation(f), 0, []
            for _ in range(n_steps):
                if pos + m > f:
                    perm, pos = prng.permutation(f), 0
                rows.append(torch.as_tensor(perm[pos:pos + m], device=self.device))
                pos += m
        else:
            rows = [slice(0, f)] * n_steps
        history = [self._step(work, opt, inputs, r) for r in rows]
        return work.state_dict(), self._sync_history(history)


class StitchingCoach(_Coach):
    """Boundary-stitching generator tune: content against the PTI result,
    the border ring against the target frame."""

    def __init__(self, net: RGINet, loss_params: Mapping,
                 cfg: StitchingConfig = StitchingConfig()):
        super().__init__(net, loss_params, cfg)

    def _chunk_loss(self, work, content_img, border_img, labels, style_vectors):
        cfg = self.cfg
        content_img, border_img = self._images(content_img), self._images(border_img)
        onehot = self._onehot(labels)
        recon = self._synth(work, style_vectors.to(self.compute_dtype), onehot)
        size = tuple(recon.shape[-2:])
        # the foreground of the swapped mask; content and border ring by
        # dilation at the mask's resolution
        fg = 1.0 - onehot[:, list(_NON_FACE)].amax(dim=1, keepdim=True)
        full = dilation(fg, 2 * cfg.outer_dilation + 1)
        border = resize_bilinear(torch.clamp(full - fg, 0.0, 1.0), size)
        content = resize_bilinear(fg, size)
        c_loss, metrics = self.criterion(recon * content, content_img * content)
        b_l2 = (recon * border - border_img * border).square().mean()
        loss = c_loss + cfg.l2_lambda * b_l2
        metrics["loss_border_l2"] = b_l2
        metrics["loss"] = loss
        return loss, metrics

    def tune(self, state: Mapping | None, content_imgs, border_imgs, labels, style_vectors,
             steps: int | None = None):
        """content and border images: (F, S, S, 3) uint8 [0, 255] or float
        [-1, 1]; labels (F, Hm, Wm) ints (uint8 welcome); style_vectors
        (F, K, 1280). Returns (tuned state dict, per-step metrics)."""
        inputs = self._as_device(content_imgs, border_imgs, labels, style_vectors)
        work, opt = self._working_copy(state)
        n_steps = self.cfg.max_steps if steps is None else steps
        f = inputs[0].shape[0]
        history = [self._step(work, opt, inputs, slice(0, f)) for _ in range(n_steps)]
        return work.state_dict(), self._sync_history(history)
