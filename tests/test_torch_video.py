"""The port's video-swap stages and video_io (e4s2024_torch.pipelines.video,
e4s2024_torch.video_io) against the JAX package's, on the CPU: the cv2
round trip, the padded chunking, batched and per-frame alignment with its
confidence floor, the enhancer and recolorer hooks, and a bfloat16
swapper's tuned clip against JAX's pipeline. The clip with the tunes off is
held in tests/test_torch_untuned_clip.py, whole clips in
tests/test_torch_clip.py, whose configuration and helpers this file
shares.
"""

import os

import numpy as np
import pytest
import torch

import jax

from e4s2024_tpu.pipelines.swap import FaceSwapper as JFaceSwapper
from e4s2024_tpu.pipelines.swap import SwapConfig as JSwapConfig
from e4s2024_tpu.pipelines.video import FaceSwapVideoPipeline as JFaceSwapVideoPipeline
from e4s2024_tpu.pipelines.video import VideoSwapConfig as JVideoSwapConfig
from e4s2024_tpu.training.pti import PTIConfig as JPTIConfig
from e4s2024_tpu.training.pti import StitchingConfig as JStitchingConfig

from e4s2024_torch import video_io
from e4s2024_torch.convert import bisenet_state_dict_from_jax, rgi_state_dict_from_jax
from e4s2024_torch.pipelines import video
from e4s2024_torch.pipelines.swap import FaceSwapper, SwapConfig
from e4s2024_torch.pipelines.video import FaceSwapVideoPipeline
from tests.test_torch_clip import (
    UNITS, _clip, _kw, _vcfg, fake_landmarks, jax_swapper, make_weights, port_swapper)
from tests.test_torch_criterion import two_threads  # noqa: F401


class FakeStack:
    """A batched landmark stack: the fixed landmarks shifted by one pixel a
    frame, with per-frame scores and a confidence floor."""

    def __init__(self, scores, min_score=0.5):
        self.scores, self.min_score = np.asarray(scores), min_score

    def landmarks_video(self, frames, chunk=16):
        first = frames[0].cpu() if isinstance(frames[0], torch.Tensor) else frames[0]
        lms = np.stack([fake_landmarks(np.asarray(first)) + i for i in range(len(frames))])
        return lms, self.scores

    def __call__(self, img):
        return fake_landmarks(np.asarray(img))


@pytest.fixture(scope="module")
def weights():
    return make_weights()


# ------------------------------------------------------------ video_io


def test_video_io_roundtrip_cv2(tmp_path, monkeypatch):
    """tests/test_video_io.py's round trip through the cv2 fallback (this
    host and the card machine have no ffmpeg)."""
    monkeypatch.setattr(video_io, "_FFMPEG", None)
    h, w, n = 64, 96, 12
    base = np.linspace(0, 200, w, dtype=np.float32)[None, :, None]
    frames = [np.clip(base + 5 * i, 0, 255).astype(np.uint8) * np.ones((h, 1, 3), np.uint8)
              for i in range(n)]
    path = os.path.join(tmp_path, "clip.mp4")
    video_io.write_video(frames, path, fps=20.0)
    assert os.path.getsize(path) > 0
    back, fps = video_io.extract_frames(path)
    assert len(back) == n
    assert back[0].shape == (h, w, 3) and back[0].dtype == np.uint8
    assert abs(fps - 20.0) < 0.5
    err = np.mean([np.abs(a.astype(np.float32) - b.astype(np.float32)).mean()
                   for a, b in zip(frames, back)])
    assert err < 8.0, err
    back, _ = video_io.extract_frames(path, max_frames=4)
    assert len(back) == 4


# ------------------------------------------------------------ stages


def test_chunked_pads_the_trailing_chunk():
    calls = []

    def fn(a, b):
        calls.append(a.shape[0])
        return a * 2, b + 1

    a, b = torch.arange(5.0)[:, None], torch.arange(5)
    out_a, out_b = video._chunked(fn, 2, a, b)
    assert calls == [2, 2, 2]
    assert torch.equal(out_a, a * 2) and torch.equal(out_b, b + 1)
    assert torch.equal(video._chunked(lambda x: x + 1, 8, a), a + 1)


def test_align_frames_matches_jax(weights):
    """The per-frame hook path (JAX's test hook), and the batched path of a
    stack with `landmarks_video`, against JAX's align_frames; crops in
    float32 of the same bilinear gather (within 5e-3 of a level)."""
    _, frames = _clip(1, n=5)
    for make in (lambda: fake_landmarks, lambda: FakeStack(np.ones(5))):
        pipe = FaceSwapVideoPipeline(port_swapper(weights, make()), _vcfg("torch"))
        jpipe = JFaceSwapVideoPipeline(jax_swapper(weights, make()), _vcfg("jax"))
        crops, quads = pipe.align_frames(frames)
        jcrops, jquads = jpipe.align_frames(frames)
        np.testing.assert_allclose(np.stack(quads), np.stack(jquads), rtol=1e-12)
        np.testing.assert_allclose(crops.numpy(), np.asarray(jcrops), atol=5e-3)


def test_align_frames_min_score_raises(weights):
    pipe = FaceSwapVideoPipeline(port_swapper(weights, FakeStack([0.9, 0.1, 0.8, 0.2])),
                                 _vcfg("torch"))
    _, frames = _clip(2, n=4)
    with pytest.raises(ValueError, match=r"no face above score 0.5 in frames \[1, 3\]"):
        pipe.align_frames(frames)
    hook = FaceSwapVideoPipeline(port_swapper(weights, lambda img: None), _vcfg("torch"))
    with pytest.raises(ValueError, match="no face found in frames"):
        hook.align_frames(frames)


def test_enhancer_hook_batches_padded(weights):
    """Anything with `enhance_aligned` runs batched; the trailing chunk is
    padded, so every call sees frames_per_batch crops (JAX's
    test_video_enhancer_stage)."""
    batches = []

    class FakeEnhancer:
        def enhance_aligned(self, crops255):
            batches.append(crops255.shape[0])
            return torch.clamp(crops255 + 1.0, 0, 255)

    pipe = FaceSwapVideoPipeline(port_swapper(weights), _vcfg("torch"), enhancer=FakeEnhancer())
    driven = torch.from_numpy((np.random.default_rng(3).random((5, 64, 64, 3)) * 255)
                              .astype(np.float32))
    out = pipe.enhance_frames(driven)
    assert batches == [2, 2, 2]
    torch.testing.assert_close(out, torch.clamp(driven + 1.0, 0, 255))


def test_recolorer_hook_gives_the_pti_targets(weights):
    """The recolorer gets the driven and target crops with both 19-class
    parses, batched; its output, resized to the crop, is the recolor target
    (JAX's FakeRecolorer)."""
    seen = []

    class FakeRecolorer:
        def recolor(self, a255, t255, a19, t19):
            seen.append((a255.shape[0], tuple(a19.shape)))
            return torch.clamp(0.5 * (a255 + t255), 0, 255)[:, ::2, ::2]  # 32^2

    sw = port_swapper(weights)
    pipe = FaceSwapVideoPipeline(sw, _vcfg("torch"), recolorer=FakeRecolorer())
    rng = np.random.default_rng(4)
    d, t = (torch.from_numpy((rng.random((3, 64, 64, 3)) * 255).astype(np.float32))
            for _ in range(2))
    got = pipe.recolor_targets(d, t)
    assert seen == [(2, (2, 512, 512)), (2, (2, 512, 512))]
    want = torch.clamp(0.5 * (d + t), 0, 255)[:, ::2, ::2].permute(0, 3, 1, 2)
    want = video.resize_bilinear(want, (64, 64)).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, want)
    assert FaceSwapVideoPipeline(sw, _vcfg("torch")).recolor_targets(d, t) is d


def test_video_pipeline_refuses_bfloat16(weights):
    """Named for the refusal it replaced: the pipeline now takes a bfloat16
    swapper as JAX's does, its bfloat16 weights tuned in bfloat16 and
    written back. A 2-frame clip with one PTI step (fast mode) against
    JAX's pipeline over a bfloat16 swapper: the trained elements that both
    packages moved (measured: 5.28M of the port's 5.38M and JAX's 5.36M)
    moved the same way for at least 90% (measured 95.3%; a wrong or missing
    tune gives about half or none), and the frames within a mean of 6 levels
    and 99% within 40 (measured 3.4 and 27; the packages' bfloat16
    syntheses round at other places, by 2.6 and 25 untuned, and a random
    net amplifies it). Stitching is left out: its first step on a clip
    whose border ring is empty follows bfloat16 rounding noise."""
    jrgi, rgi_vars, bise = weights
    source, frames = _clip(7, n=2)
    bf16 = dict(compute_dtype="bfloat16", **_kw())
    sw = FaceSwapper(rgi_state_dict_from_jax(rgi_vars), bisenet_state_dict_from_jax(bise),
                     SwapConfig(**bf16), landmark_fn=fake_landmarks, device="cpu",
                     encoder_num_units=UNITS)
    init = {k: v.float() for k, v in sw.rgi.state_dict().items() if v.is_floating_point()}
    pipe = FaceSwapVideoPipeline(sw, _vcfg("torch", 1, 0, tune_mode="fast"))
    outs = pipe(source, frames)
    assert set(pipe.histories) == {"pti"}
    got = sw.rgi.state_dict()
    assert got["G.conv1.conv.weight"].dtype == torch.bfloat16

    jsw = JFaceSwapper(rgi_vars, bise, JSwapConfig(**bf16), landmark_fn=fake_landmarks)
    jsw.rgi = jrgi
    jcfg = JVideoSwapConfig(
        swap=JSwapConfig(**bf16), pti=JPTIConfig(max_pti_steps=1, scan_steps=1,
                                                 regional_mode="fast"),
        stitching=JStitchingConfig(max_steps=0), frames_per_batch=2)
    jouts = JFaceSwapVideoPipeline(jsw, jcfg)(source, frames)
    tuned = rgi_state_dict_from_jax(jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32), jsw.rgi_variables))
    moved = {"port": 0, "jax": 0, "both": 0, "agree": 0}
    for k, v in init.items():
        a, b = got[k].float() - v, tuned[k] - v
        both = (a != 0) & (b != 0)
        moved["port"] += int((a != 0).sum())
        moved["jax"] += int((b != 0).sum())
        moved["both"] += int(both.sum())
        moved["agree"] += int((both & (a.sign() == b.sign())).sum())
    assert moved["both"] > 0.9 * max(moved["port"], moved["jax"]), moved
    assert moved["agree"] >= 0.9 * moved["both"], moved
    for got_frame, want in zip(outs, jouts):
        d = np.abs(got_frame.astype(np.int16) - want.astype(np.int16))
        assert d.mean() <= 6 and np.quantile(d, 0.99) <= 40, (d.mean(), np.quantile(d, 0.99))
