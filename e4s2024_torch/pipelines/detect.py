"""Face detection and 68-point landmarks from raw frames.

Counterpart of `e4s2024_tpu/pipelines/detect.py`: RetinaFace with decode and
greedy NMS, and a FAN landmarker batched over faces, so that
`FaceSwapper.swap` runs from raw uint8 frames with no external hook.

Where the work runs:
  - A frame is uploaded once as uint8; the aspect-preserving resize with
    zero pad, the net, the decode, the top-k (a stable sort: among equal
    scores the lower index comes first, as `lax.top_k` orders them) and the
    (k, k) IoU-over-threshold matrix run on the device.
  - One copy to the host per detection then carries the k candidates and
    that matrix; the greedy NMS pass over it is a short host loop (the JAX
    package runs it as a k-step loop on the device).
  - FAN crops are bilinear quad samples on the device, all faces of a frame
    (or all frames of a chunk) in one FAN forward; one copy of the landmarks
    comes back.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from e4s2024_torch import resolve_device
from e4s2024_torch.models.arcface import FrozenBatchNorm
from e4s2024_torch.models.fan import FAN, heatmaps_to_landmarks
from e4s2024_torch.models.retinaface import (
    CFG_MNET, CFG_RE50, RetinaFace, decode_boxes, decode_landms, generate_priors)
from e4s2024_torch.ops.resize import resize_bilinear
from e4s2024_torch.pipelines.alignment import crop_quad


def upload(frame, device: torch.device) -> torch.Tensor:
    """A frame (or a stack of frames) on `device`: numpy uint8 crosses as
    uint8, other numpy input as float32; tensors are moved as they are."""
    if not isinstance(frame, torch.Tensor):
        frame = np.asarray(frame)
        if frame.dtype != np.uint8:
            frame = frame.astype(np.float32)
        frame = torch.from_numpy(np.ascontiguousarray(frame))
    return frame.to(device)


def pad_to_chunk(arr, chunk: int):
    """Pad a stack's leading axis up to a multiple of `chunk` by repeating
    the last row (numpy arrays or tensors). Returns (padded, original
    length)."""
    n = arr.shape[0]
    rem = n % chunk
    if rem == 0:
        return arr, n
    reps = [1] * arr.ndim
    reps[0] = chunk - rem
    if isinstance(arr, torch.Tensor):
        return torch.cat([arr, arr[-1:].repeat(*reps)]), n
    arr = np.asarray(arr)
    return np.concatenate([arr, np.tile(arr[-1:], reps)]), n


def pairwise_iou(boxes: torch.Tensor, offset: float = 0.0) -> torch.Tensor:
    """(..., K, 4) xyxy boxes -> (..., K, K) IoU. offset=1.0 is the
    reference's inclusive-pixel convention (py_cpu_nms.py)."""
    area = torch.clamp(boxes[..., 2] - boxes[..., 0] + offset, min=0.0) * torch.clamp(
        boxes[..., 3] - boxes[..., 1] + offset, min=0.0)
    tl = torch.maximum(boxes[..., :, None, :2], boxes[..., None, :, :2])
    br = torch.minimum(boxes[..., :, None, 2:], boxes[..., None, :, 2:])
    wh = torch.clamp(br - tl + offset, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-12)


def _top_k_overlaps(boxes, scores, k: int, iou_thresh: float):
    """Device half of NMS over (..., N): the top k by score (stable: the
    lower index first among equal scores), their boxes, and which pairs
    overlap beyond the threshold (inclusive-pixel IoU)."""
    top_scores, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    top_scores, idx = top_scores[..., :k], idx[..., :k]
    b = torch.gather(boxes, -2, idx[..., None].expand(*idx.shape, 4))
    return b, top_scores, idx, pairwise_iou(b, offset=1.0) > iou_thresh


def greedy_keep(over: np.ndarray) -> np.ndarray:
    """Host half of NMS: over (k, k) bool, rows in score order -> keep (k,)
    bool. Row i is kept unless a kept earlier row overlaps it."""
    k = over.shape[0]
    keep = np.zeros(k, bool)
    for i in range(k):
        keep[i] = not (keep[:i] & over[i, :i]).any()
    return keep


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor, k: int, iou_thresh: float):
    """Greedy NMS over the top-k candidates. Returns (boxes (k, 4), scores
    (k,), keep (k,) bool, idx (k,) into the input) sorted by score, on the
    input's device; suppressed rows have keep=False."""
    k = min(k, scores.shape[0])
    b, top_scores, idx, over = _top_k_overlaps(boxes, scores, k, iou_thresh)
    keep = torch.from_numpy(greedy_keep(over.cpu().numpy())).to(boxes.device)
    return b, top_scores, keep, idx


@dataclass
class DetectorConfig:
    det_size: int = 640
    score_thresh: float = 0.9   # reference retinaface_detection.py:61
    nms_thresh: float = 0.4
    pre_nms_topk: int = 256
    max_faces: int = 16


class RetinaFaceDetector:
    """RetinaFace detection of the faces in a frame.

    `detect(frame)` takes one (H, W, 3) uint8 or float RGB frame (numpy or a
    tensor) and returns numpy (boxes (F, 4) xyxy in frame pixels, scores
    (F,), lm5 (F, 5, 2)) for the F faces above the threshold, sorted by
    score. If none clears it and `fallback_best` is set, the single best
    candidate is returned.
    """

    def __init__(self, state_dict, cfg: dict = CFG_MNET,
                 config: DetectorConfig = DetectorConfig(),
                 fallback_best: bool = True, *, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.config = config
        self.fallback_best = fallback_best
        self.model = RetinaFace(cfg)
        self.model.load_state_dict(state_dict, strict=True)
        self.model.to(self.device).eval().requires_grad_(False)
        s = config.det_size
        self._priors = torch.from_numpy(generate_priors((s, s), cfg)).to(self.device)

    def _preprocess(self, frames: torch.Tensor):
        """(B, H, W, 3) on the device -> (B, 3, det, det) float32, resized
        keeping the aspect ratio and zero padded right and below."""
        h, w = frames.shape[1:3]
        s = self.config.det_size
        scale = s / max(h, w)
        nh, nw = round(h * scale), round(w * scale)
        x = resize_bilinear(frames.permute(0, 3, 1, 2).float(), (nh, nw))
        return F.pad(x, (0, s - nw, 0, s - nh)), scale

    def _run(self, frames: torch.Tensor):
        """Detection of a (B, H, W, 3) stack on the device, then one copy to
        the host and the greedy pass. Returns numpy (boxes (B, K, 4), scores
        (B, K), lm5 (B, K, 5, 2)) in frame pixels, K = max_faces rows
        sorted by score, kept rows first, suppressed rows with score 0."""
        cfg, var = self.config, self.cfg["variance"]
        imgs, scale = self._preprocess(frames)
        s, bsz = cfg.det_size, imgs.shape[0]
        with torch.inference_mode():
            loc, conf, lmr = self.model(imgs)
            boxes = decode_boxes(loc, self._priors, var) * s
            lm5 = decode_landms(lmr, self._priors, var) * s
            k = min(cfg.pre_nms_topk, conf.shape[1])
            b, sc, idx, over = _top_k_overlaps(boxes, conf[..., 1], k, cfg.nms_thresh)
            lm = torch.gather(lm5, 1, idx[..., None, None].expand(bsz, k, 5, 2))
            host = torch.cat([b.reshape(bsz, -1), sc, lm.reshape(bsz, -1),
                              over.reshape(bsz, -1).float()], dim=1).cpu().numpy()
        b, sc = host[:, :4 * k].reshape(bsz, k, 4), host[:, 4 * k:5 * k]
        lm = host[:, 5 * k:15 * k].reshape(bsz, k, 5, 2)
        over = host[:, 15 * k:].reshape(bsz, k, k) > 0.5
        outs = []
        for i in range(bsz):
            keep = greedy_keep(over[i])
            order = np.argsort(~keep, kind="stable")[:cfg.max_faces]
            outs.append((b[i, order] / scale, sc[i, order] * keep[order], lm[i, order] / scale))
        return tuple(np.stack(o) for o in zip(*outs))

    def detect(self, frame):
        boxes, scores, lm5 = (o[0] for o in self._run(upload(frame, self.device)[None]))
        good = scores > self.config.score_thresh
        if not good.any():
            if not self.fallback_best:
                return (np.zeros((0, 4), np.float32), np.zeros((0,), np.float32),
                        np.zeros((0, 5, 2), np.float32))
            good = np.zeros_like(good)
            good[0] = True  # rows are score-sorted; row 0 is the best
        return boxes[good], scores[good], lm5[good]

    def detect_batch(self, frames, chunk: int = 16):
        """Detection over a stack of same-size frames (a clip): (B, H, W, 3)
        -> (boxes (B, K, 4), scores (B, K), lm5 (B, K, 5, 2)), K = max_faces,
        rows score-sorted per frame, suppressed rows with score 0; `chunk`
        frames a forward."""
        outs = [self._run(upload(frames[i:i + chunk], self.device))
                for i in range(0, len(frames), chunk)]
        return tuple(np.concatenate(o) for o in zip(*outs))


class FANLandmarker:
    """FAN 68-point landmarks for detected boxes.

    The crop follows face-alignment's box -> (center, scale) rule: the box
    centre moved down 12% of the height, side 200 * scale with scale =
    (bw + bh) / 195; crops are bilinear quad samples on the device and all
    of a call's faces run one FAN forward.
    """

    def __init__(self, state_dict, num_modules: int = 4, features: int = 256,
                 resolution: int = 256, depth: int = 4, *, device=None):
        self.device = resolve_device(device)
        self.model = FAN(num_modules=num_modules, features=features, depth=depth)
        self.model.load_state_dict(state_dict, strict=True)
        self.model.to(self.device).eval().requires_grad_(False)
        self.resolution = resolution

    @staticmethod
    def box_to_center_side(box: np.ndarray):
        """face-alignment FaceAlignment.get_landmarks box handling."""
        x1, y1, x2, y2 = [float(v) for v in box[:4]]
        center = np.array([(x1 + x2) / 2.0, (y1 + y2) / 2.0])
        center[1] -= (y2 - y1) * 0.12
        scale = (x2 - x1 + y2 - y1) / 195.0
        return center, 200.0 * scale

    def _centers_sides(self, boxes: np.ndarray):
        cs = [self.box_to_center_side(b) for b in np.asarray(boxes, np.float32)]
        centers = torch.tensor(np.stack([c for c, _ in cs]), dtype=torch.float32,
                               device=self.device)
        sides = torch.tensor(np.array([s for _, s in cs]), dtype=torch.float32,
                             device=self.device)
        return centers, sides

    def _run(self, frames: torch.Tensor, centers: torch.Tensor, sides: torch.Tensor):
        """Crops of frames (H, W, 3), or one a frame of (F, H, W, 3), at
        (F, 2) centres and (F,) sides -> (F, 68, 2) frame points, on the
        device."""
        half = sides / 2.0
        d = torch.stack([torch.stack([-half, -half], -1), torch.stack([-half, half], -1),
                         torch.stack([half, half], -1), torch.stack([half, -half], -1)], 1)
        crops = crop_quad(frames, centers[:, None, :] + d, self.resolution)
        with torch.inference_mode():
            hm = self.model(crops.permute(0, 3, 1, 2) / 255.0)[-1]
            pts = heatmaps_to_landmarks(hm.float())  # (F, K, 2)
        # heatmap px -> crop px -> frame px (centre-aligned sampling)
        rel = (pts + 0.5) / hm.shape[-2] - 0.5  # in (-0.5, 0.5) of the crop
        return centers[:, None, :] + rel * sides[:, None, None]

    def landmarks(self, frame, boxes: np.ndarray) -> np.ndarray:
        """frame (H, W, 3) uint8 or float (numpy or a tensor), boxes (F, 4)
        xyxy -> (F, 68, 2) numpy."""
        if np.asarray(boxes).shape[0] == 0:
            return np.zeros((0, 68, 2), np.float32)
        centers, sides = self._centers_sides(boxes)
        return self._run(upload(frame, self.device), centers, sides).cpu().numpy()

    def landmarks_video(self, frames, boxes: np.ndarray, chunk: int = 16) -> np.ndarray:
        """One face a frame: frames (B, H, W, 3), boxes (B, 4) xyxy ->
        (B, 68, 2) numpy; `chunk` frames a FAN forward."""
        centers, sides = self._centers_sides(boxes)
        outs = [self._run(upload(frames[i:i + chunk], self.device),
                          centers[i:i + chunk], sides[i:i + chunk])
                for i in range(0, len(frames), chunk)]
        return torch.cat(outs).cpu().numpy()


class FaceLandmarkDetector:
    """Detector + landmarker: the standalone `landmark_fn`.

    Called with one (H, W, 3) uint8 frame (numpy, or a tensor already on the
    device) it returns the (68, 2) landmarks of the best face, or None;
    `detect_all` gives every face with boxes and 5-point landmarks.
    """

    def __init__(self, detector: RetinaFaceDetector, landmarker: FANLandmarker,
                 min_score: float | None = None):
        self.detector = detector
        self.landmarker = landmarker
        # confidence floor for the single-face path; None keeps the
        # detector's own fallback (demo mode, random weights)
        self.min_score = min_score

    def __call__(self, frame) -> np.ndarray | None:
        frame = upload(frame, self.detector.device)
        boxes, scores, _ = self.detector.detect(frame)
        if boxes.shape[0] == 0:
            return None
        if self.min_score is not None and float(scores[0]) < self.min_score:
            return None
        return self.landmarker.landmarks(frame, boxes[:1])[0]

    def detect_all(self, frame):
        """-> (boxes (F, 4), scores (F,), lm5 (F, 5, 2), lm68 (F, 68, 2))."""
        frame = upload(frame, self.detector.device)
        boxes, scores, lm5 = self.detector.detect(frame)
        return boxes, scores, lm5, self.landmarker.landmarks(frame, boxes)

    def landmarks_video(self, frames, chunk: int = 16):
        """Best face of every frame of a same-size clip: (B, H, W, 3) ->
        (lm68 (B, 68, 2), scores (B,)). Frames whose best score is below
        `min_score` still return landmarks; callers gate on the scores."""
        boxes, scores, _ = self.detector.detect_batch(frames, chunk)
        return self.landmarker.landmarks_video(frames, boxes[:, 0], chunk), scores[:, 0]


def _random_state_dict(model: nn.Module, seed: int) -> dict[str, torch.Tensor]:
    """Demo weights for a net of convolutions and frozen BNs, drawn from an
    explicit generator: LeCun-normal convolution weights, zero biases,
    identity BNs (the JAX package's default initialisers)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, m in model.named_modules():
        p = f"{name}." if name else ""
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            out[f"{p}weight"] = torch.randn(m.weight.shape, generator=g) / fan_in ** 0.5
            if m.bias is not None:
                out[f"{p}bias"] = torch.zeros(m.bias.shape)
        elif isinstance(m, FrozenBatchNorm):
            c = m.weight.shape[0]
            out.update({f"{p}weight": torch.ones(c), f"{p}bias": torch.zeros(c),
                        f"{p}running_mean": torch.zeros(c), f"{p}running_var": torch.ones(c)})
    return out


def default_landmarker(weights_dir: str | None = None, det_size: int = 640,
                       network: str = "mobilenet", fan_modules: int = 4,
                       fan_features: int = 256, fan_depth: int = 4,
                       fan_resolution: int = 256, *, device=None) -> FaceLandmarkDetector:
    """The standard landmark stack, on the card unless `device` says
    otherwise.

    Reads the reference's torch checkpoints `RetinaFace-mobile0.25.pth` (or
    `RetinaFace-R50.pth`) and `2DFAN4.pth` from `weights_dir` or
    $E4S_WEIGHTS; the detector's BGR - mean preprocessing is folded into
    its stem. Without them the nets get random weights from a seeded
    generator (the pipeline runs end to end, the landmarks mean nothing)
    and a warning says so.
    """
    from e4s2024_torch.convert import fold_bgr_mean_into_stem, load_reference_checkpoint

    device = resolve_device(device)
    weights_dir = weights_dir or os.environ.get("E4S_WEIGHTS", "")
    cfg = CFG_MNET if network == "mobilenet" else CFG_RE50
    det_name = "RetinaFace-mobile0.25.pth" if network == "mobilenet" else "RetinaFace-R50.pth"
    det_path = os.path.join(weights_dir, det_name) if weights_dir else ""
    fan_path = os.path.join(weights_dir, "2DFAN4.pth") if weights_dir else ""

    real_det_weights = bool(det_path and os.path.exists(det_path))
    if real_det_weights:
        det_sd = fold_bgr_mean_into_stem(load_reference_checkpoint(det_path), cfg)
    else:
        warnings.warn("no RetinaFace checkpoint found — using RANDOM detector weights "
                      "(set $E4S_WEIGHTS to a dir with RetinaFace-mobile0.25.pth)")
        with torch.device("meta"):  # shapes only: no draws, no memory
            net = RetinaFace(cfg)
        det_sd = _random_state_dict(net, 0)
    if fan_path and os.path.exists(fan_path):
        fan_sd = load_reference_checkpoint(fan_path)
    else:
        warnings.warn("no 2DFAN4 checkpoint found — using RANDOM landmark weights")
        with torch.device("meta"):
            net = FAN(fan_modules, fan_features, depth=fan_depth)
        fan_sd = _random_state_dict(net, 1)

    # With real weights, detection confidence means something: no
    # best-candidate fallback, and the single-face path is gated on
    # score_thresh so that a faceless frame yields None (FaceSwapper.swap
    # then raises). Random-weight demo mode keeps the fallback.
    det_config = DetectorConfig(det_size=det_size)
    det = RetinaFaceDetector(det_sd, cfg, det_config, fallback_best=not real_det_weights,
                             device=device)
    fan = FANLandmarker(fan_sd, num_modules=fan_modules, features=fan_features,
                        depth=fan_depth, resolution=fan_resolution, device=device)
    return FaceLandmarkDetector(
        det, fan, min_score=det_config.score_thresh if real_det_weights else None)
