"""The port's video swap over whole clips (e4s2024_torch.pipelines.video)
against the JAX package's, on the CPU: the weight write-back, a port-only
clip with both tunes and one of mixed frame sizes, and (slow) the whole
tuned clip against JAX's (the untuned clip is held in
tests/test_torch_video.py).

The swapper is tests/test_video_pipeline.py's configuration (64^2 output,
remaining_layer_idx 7, 3 blend levels) with the encoder body cut to one
unit per group on both sides, float32, exact mode; weights from a numpy
seed (tests/test_torch_models.py::random_params); landmarks from the JAX
test's fixed hook. Clips are random 96x96 frames. The stages and hooks are
held in tests/test_torch_video.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from e4s2024_tpu.models.bisenet import BiSeNet as JBiSeNet
from e4s2024_tpu.models.rgi import RGINet as JRGINet
from e4s2024_tpu.pipelines.swap import FaceSwapper as JFaceSwapper
from e4s2024_tpu.pipelines.swap import SwapConfig as JSwapConfig
from e4s2024_tpu.pipelines.video import FaceSwapVideoPipeline as JFaceSwapVideoPipeline
from e4s2024_tpu.pipelines.video import VideoSwapConfig as JVideoSwapConfig
from e4s2024_tpu.training.pti import PTIConfig as JPTIConfig
from e4s2024_tpu.training.pti import StitchingConfig as JStitchingConfig

from e4s2024_torch.convert import bisenet_state_dict_from_jax, rgi_state_dict_from_jax
from e4s2024_torch.pipelines import video
from e4s2024_torch.pipelines.swap import FaceSwapper, SwapConfig
from e4s2024_torch.pipelines.video import FaceSwapVideoPipeline, VideoSwapConfig
from e4s2024_torch.training import pti
from e4s2024_torch.training.pti import PTIConfig, StitchingConfig
from tests.test_torch_models import random_params
from tests.test_torch_criterion import two_threads  # noqa: F401

SIZE, REMAINING, LEVELS, UNITS = 64, 7, 3, (1, 1, 1, 1)


def fake_landmarks(img):
    """tests/test_video_pipeline.py's hook: a fixed face in every frame."""
    h, w = img.shape[:2]
    lm = np.zeros((68, 2))
    lm[36:42] = [w * 0.35, h * 0.4]
    lm[42:48] = [w * 0.65, h * 0.4]
    lm[48] = [w * 0.4, h * 0.7]
    lm[54] = [w * 0.6, h * 0.7]
    return lm


def make_weights():
    """(JAX RGINet, its variables, BiSeNet params) from a numpy seed."""
    jrgi = JRGINet(out_size=SIZE, remaining_layer_idx=REMAINING, encoder_num_units=UNITS)
    rgi_vars = random_params(jax.eval_shape(
        jrgi.init, jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)),
        jnp.zeros((1, SIZE, SIZE, 12))), 21)
    bise = random_params(jax.eval_shape(
        JBiSeNet().init, jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3)))["params"], 22)
    return jrgi, rgi_vars, bise


@pytest.fixture(scope="module")
def weights():
    return make_weights()


def _kw():
    return dict(out_size=SIZE, remaining_layer_idx=REMAINING, num_blend_levels=LEVELS)


def port_swapper(weights, landmark_fn=fake_landmarks):
    _, rgi_vars, bise = weights
    return FaceSwapper(rgi_state_dict_from_jax(rgi_vars), bisenet_state_dict_from_jax(bise),
                       SwapConfig(**_kw()), landmark_fn=landmark_fn, device="cpu",
                       encoder_num_units=UNITS)


def jax_swapper(weights, landmark_fn=fake_landmarks):
    jrgi, rgi_vars, bise = weights
    jswap = JFaceSwapper(rgi_vars, bise, JSwapConfig(**_kw()), landmark_fn=landmark_fn)
    jswap.rgi = jrgi  # the JAX swapper builds the full-depth encoder
    return jswap


def _clip(seed, n=3, size=96):
    rng = np.random.default_rng(seed)
    frames = [(rng.random((size, size, 3)) * 255).astype(np.uint8) for _ in range(n)]
    return (rng.random((size, size, 3)) * 255).astype(np.uint8), frames


def _vcfg(package, pti_steps=2, stitch_steps=1, batch=2, tune_mode="exact"):
    """The video configuration; `tune_mode` is the coaches' regional mode
    (the port-only runs tune in fast mode, a twelfth of exact mode's CPU
    time; tests/test_torch_pti.py and the JAX comparison tune in exact)."""
    if package == "jax":
        return JVideoSwapConfig(swap=JSwapConfig(**_kw()),
                                pti=JPTIConfig(max_pti_steps=pti_steps, scan_steps=1),
                                stitching=JStitchingConfig(max_steps=stitch_steps, scan_steps=1),
                                frames_per_batch=batch)
    return VideoSwapConfig(
        swap=SwapConfig(**_kw()), pti=PTIConfig(max_pti_steps=pti_steps, regional_mode=tune_mode),
        stitching=StitchingConfig(max_steps=stitch_steps, regional_mode=tune_mode),
        frames_per_batch=batch)


# ------------------------------------------------------------ the whole clip


def test_tuned_weights_are_written_back(weights, monkeypatch):
    """As the JAX pipeline writes the tuned variables into its swapper, the
    port loads them into `swapper.rgi`: PTI starts from the swapper's
    weights, stitching from PTI's, the swapper ends with stitching's, and a
    second clip's PTI starts from the first clip's tuned generator."""
    sw = port_swapper(weights)
    starts, results = [], []
    for cls in (pti.PTICoach, pti.StitchingCoach):
        tune = cls.tune

        def spy(self, state, *args, _tune=tune, **kwargs):
            starts.append({k: v.clone() for k, v in self.net.state_dict().items()})
            out = _tune(self, state, *args, **kwargs)
            results.append({k: v.clone() for k, v in out[0].items()})
            return out

        monkeypatch.setattr(cls, "tune", spy)
    before = {k: v.clone() for k, v in sw.rgi.state_dict().items()}
    source, frames = _clip(5, n=2)
    pipe = FaceSwapVideoPipeline(sw, _vcfg("torch", 1, 1, tune_mode="fast"))
    pipe(source, frames)
    assert set(pipe.histories) == {"pti", "stitching"}
    pipe.cfg.run_stitching = False  # the second clip: PTI only
    pipe(source, frames)
    assert len(starts) == len(results) == 3

    def same(a, b):
        return all(torch.equal(a[k], b[k]) for k in a)

    assert same(starts[0], before)
    assert same(starts[1], results[0]) and same(starts[2], results[1])
    assert same(sw.rgi.state_dict(), results[2])
    assert not same(results[1], before)
    assert torch.equal(sw.rgi.state_dict()["G.style.1.weight"], before["G.style.1.weight"])
    assert not any(p.requires_grad for p in sw.rgi.parameters())


def _diff(got, want):
    assert got.dtype == np.uint8 and got.shape == want.shape
    d = np.abs(got.astype(np.int16) - np.asarray(want).astype(np.int16))
    return int(d.max()), float(d.mean()), float(np.mean(d <= 1))


def test_video_pipeline_end_to_end(weights):
    """The port alone: 3 frames, PTI 2 steps, stitching 1 step; uint8
    frames of the input size, finite per-step losses, the stages timed; a
    clip of mixed frame sizes through the per-frame paste-back."""
    source, frames = _clip(6)
    pipe = FaceSwapVideoPipeline(port_swapper(weights), _vcfg("torch", tune_mode="fast"))
    timer = video.StageTimer()
    outs = pipe(source, frames, timer=timer)
    assert len(outs) == 3
    for o, f in zip(outs, frames):
        assert o.shape == f.shape and o.dtype == np.uint8
    assert len(pipe.histories["pti"]) == 2 and len(pipe.histories["stitching"]) == 1
    assert all(np.isfinite(v) for h in pipe.histories.values() for m in h for v in m.values())
    assert {"detect_align", "pti_tune", "stitching_tune", "synth_composite_pasteback",
            "d2h_gather"} <= set(timer.times)
    # mixed frame sizes take the per-frame paste-back
    mixed = [frames[0], np.ascontiguousarray(frames[1][:80]), frames[2]]
    outs = FaceSwapVideoPipeline(port_swapper(weights), _vcfg("torch", 0, 0))(source, mixed)
    assert [o.shape for o in outs] == [f.shape for f in mixed]


@pytest.mark.slow
def test_video_pipeline_matches_jax(weights, capsys):
    """The whole clip against JAX's pipeline (scan_steps=1): 99% of pixels
    within 1 level and a mean under 0.1 level, the raw-frame swap's bound
    (measured: max 1 level, mean 0.035-0.039, CPU; Adam's sign noise on
    near-0 gradients moves the tuned weights by up to 2 lr an element).
    Slow, as JAX's own end-to-end video test: the JAX side compiles the PTI
    and stitching steps at this size (97 s here); the stages around the
    tunes are held in tier 1 by test_untuned_clip_matches_jax, the tunes by
    tests/test_torch_pti.py."""
    source, frames = _clip(7)
    outs = FaceSwapVideoPipeline(port_swapper(weights), _vcfg("torch"))(source, frames)
    jouts = JFaceSwapVideoPipeline(jax_swapper(weights), _vcfg("jax"))(source, frames)
    for i, (got, want) in enumerate(zip(outs, jouts)):
        mx, mean, share = _diff(got, want)
        with capsys.disabled():
            print(f"\n[video frame {i} vs JAX] max|d| {mx} levels, mean {mean:.4g}, "
                  f"within 1 level {share:.6f}")
        assert share >= 0.99 and mean <= 0.1, (i, mx, mean, share)
