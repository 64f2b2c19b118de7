"""The port's raw-frame swap (FaceSwapper.swap / swap_all,
FullFaceSwapPipeline.swap_raw / swap_raw_multi, swap_cli) against the JAX
package's, on the CPU.

The swap is tests/test_torch_swap.py's (128^2, remaining_layer_idx 9, 4
blend levels, one encoder unit per group) in fast regional mode (the CLI's
default; the CPU runs it in a quarter of exact mode's time), the landmark
stack
tests/test_torch_detect.py's small one (RetinaFace at det_size 160, FAN with
1 module, 32 features, depth 2 at 64^2), the frames smooth 150x200 uint8.
Landmarks of the two stacks agree within 1e-3 px, so the quads, crops and
paste-back positions differ by about that much.
"""

import copy
import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from e4s2024_tpu.models.bisenet import BiSeNet as JBiSeNet
from e4s2024_tpu.models.rgi import RGINet as JRGINet
from e4s2024_tpu.models.swinir import SwinIR as JSwinIR
from e4s2024_tpu.models.swinir import SwinIREnhancer as JSwinIREnhancer
from e4s2024_tpu.models.swinir import SwinIRUpscaler as JSwinIRUpscaler
from e4s2024_tpu.pipelines.full_swap import FullFaceSwapPipeline as JFullFaceSwapPipeline
from e4s2024_tpu.pipelines.full_swap import FullSwapConfig as JFullSwapConfig
from e4s2024_tpu.pipelines.full_swap import SwapComponents as JSwapComponents
from e4s2024_tpu.pipelines.swap import FaceSwapper as JFaceSwapper
from e4s2024_tpu.pipelines.swap import SwapConfig as JSwapConfig

from e4s2024_torch.convert import (
    bisenet_state_dict_from_jax, rgi_state_dict_from_jax, swinir_state_dict_from_jax)
from e4s2024_torch.models.swinir import SwinIREnhancer, SwinIRUpscaler
from e4s2024_torch.pipelines import detect
from e4s2024_torch.pipelines.full_swap import FullFaceSwapPipeline, FullSwapConfig, SwapComponents
from e4s2024_torch.pipelines.swap import FaceSwapper, SwapConfig
from tests.test_torch_detect import FAN_RES, DET, _frames, small_stacks
from tests.test_torch_models import random_params
from tests.test_torch_swinir import TINY, swin_params

SIZE, REMAINING, LEVELS, UNITS = 128, 9, 4, (1, 1, 1, 1)


@pytest.fixture(scope="module")
def weights():
    jrgi = JRGINet(out_size=SIZE, remaining_layer_idx=REMAINING, encoder_num_units=UNITS)
    rgi_vars = random_params(jax.eval_shape(
        jrgi.init, jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)),
        jnp.zeros((1, SIZE, SIZE, 12))), 11)
    bise = random_params(jax.eval_shape(
        JBiSeNet().init, jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3)))["params"], 12)
    return jrgi, rgi_vars, bise


@pytest.fixture(scope="module")
def swappers(weights):
    """(JAX swapper, port swapper), each over its own package's small
    landmark stack with the same weights."""
    jrgi, rgi_vars, bise = weights
    jstack, stack = small_stacks()
    kw = dict(out_size=SIZE, remaining_layer_idx=REMAINING, num_blend_levels=LEVELS,
              regional_mode="fast")
    jswap = JFaceSwapper(rgi_vars, bise, JSwapConfig(**kw), landmark_fn=jstack)
    jswap.rgi = jrgi  # the JAX swapper builds the full-depth encoder
    swap = FaceSwapper(rgi_state_dict_from_jax(rgi_vars), bisenet_state_dict_from_jax(bise),
                       SwapConfig(**kw), landmark_fn=stack, device="cpu",
                       encoder_num_units=UNITS)
    return jswap, swap


def _diff(got, want):
    assert got.dtype == np.uint8 and got.shape == want.shape
    d = np.abs(got.astype(np.int16) - np.asarray(want).astype(np.int16))
    return int(d.max()), float(d.mean()), float(np.mean(d <= 1))


def test_geometry_matches_jax(swappers):
    """Crop and paste-back alone (the swap returns the target crop): the
    frames agree within 1 level, and pixels outside the pasted quad are the
    target's."""
    jswap, swap = swappers
    src, tgt = _frames(20, 2)
    ident = lambda d, t: t  # noqa: E731
    got, want = swap.swap(src, tgt, swap_fn=ident), jswap.swap(src, tgt, swap_fn=ident)
    assert got.shape == tgt.shape
    assert _diff(got, want)[0] <= 1
    assert not np.array_equal(got, tgt)  # a quad was pasted (resampled twice)


def test_swap_and_swap_all_match_jax(swappers, capsys):
    """End to end. The crops are truncated to uint8 before the swap; a
    1e-3 px move of a quad moves a crop pixel that straddles an integer by
    one level, which can flip a parse pixel at a near-tie (the aligned
    swap's "masks equal, 1 level" standard does not hold here). Held to:
    99% of pixels within 1 level, mean under 0.1 level."""
    jswap, swap = swappers
    src, tgt = _frames(21, 2)
    # one face through swap_all: the JAX program of swap serves it
    for name, got, want in (
            ("swap", swap.swap(src, tgt), jswap.swap(src, tgt)),
            ("swap_all", swap.swap_all(src, tgt, max_faces=1),
             jswap.swap_all(src, tgt, max_faces=1))):
        mx, mean, share = _diff(got, want)
        with capsys.disabled():
            print(f"\n[{name} vs JAX] max|d| {mx} levels, mean {mean:.4g}, "
                  f"within 1 level {share:.6f}")
        assert share >= 0.99 and mean <= 0.1, (name, mx, mean, share)


def test_no_face(swappers):
    _, swap = swappers
    frame = _frames(22, 1)[0]
    hook = FaceSwapper.__new__(FaceSwapper)
    hook.__dict__.update(swap.__dict__)
    hook.landmark_fn = lambda img: None
    with pytest.raises(ValueError, match="no face found in the source"):
        hook.swap(frame, frame)
    with pytest.raises(RuntimeError, match="needs the detector stack"):
        hook.swap_all(frame, frame)
    # no detection clears min_score: the frame comes back unchanged
    out = swap.swap_all(frame, frame, min_score=1.5)
    assert out.dtype == np.uint8 and np.array_equal(out, frame)


@pytest.fixture(scope="module")
def pipelines(weights, swappers):
    jswap, swap = swappers
    jsr = JSwinIR(**TINY)
    sr = swin_params(jax.eval_shape(jsr.init, jax.random.PRNGKey(2),
                                    jnp.zeros((1, 16, 16, 3)))["params"], 22)
    jenh = JSwinIREnhancer(JSwinIRUpscaler(sr, model=jsr))
    jpipe = JFullFaceSwapPipeline(jswap, JSwapComponents(enhancers={"swinir": jenh.enhance_aligned}),
                                  JFullSwapConfig(enhancement_mode="swinir"))
    enh = SwinIREnhancer(SwinIRUpscaler(swinir_state_dict_from_jax(sr), device="cpu", **TINY))
    pipe = FullFaceSwapPipeline(swap, SwapComponents(enhancers={"swinir": enh.enhance_aligned}),
                                FullSwapConfig(enhancement_mode="swinir"))
    return jpipe, pipe


def test_swap_raw_matches_jax(pipelines):
    """The enhanced swap from raw frames against JAX, with the tolerance of
    test_swap_and_swap_all_match_jax; swap_raw_multi, which differs from it
    only in the path test_swap_and_swap_all_match_jax holds against JAX,
    swaps and pastes the face with the enhancer too."""
    jpipe, pipe = pipelines
    src, tgt = _frames(23, 2)
    got = pipe.swap_raw(src, tgt)
    mx, mean, share = _diff(got, jpipe.swap_raw(src, tgt))
    assert share >= 0.99 and mean <= 0.1, (mx, mean, share)
    multi = pipe.swap_raw_multi(src, tgt, max_faces=1)
    assert multi.shape == tgt.shape and multi.dtype == np.uint8
    assert not np.array_equal(multi, tgt)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory, weights):
    """Reference-style torch files of the small swap's weights: RGI in E4S's
    {state_dict, latent_avg} envelope, BiSeNet under DDP's `module.`
    prefix."""
    _, rgi_vars, bise = weights
    d = tmp_path_factory.mktemp("ckpts")
    rgi = rgi_state_dict_from_jax(rgi_vars)
    latent_avg = rgi.pop("latent_avg")
    torch.save({"state_dict": rgi, "latent_avg": latent_avg, "opts": {"size": SIZE}},
               d / "rgi.pt")
    torch.save({f"module.{k}": v for k, v in bisenet_state_dict_from_jax(bise).items()},
               d / "bisenet.pth")
    return d


@pytest.fixture
def cli(tmp_path, checkpoints, monkeypatch):
    """Runs swap_cli.main on two frames written as PNGs; the CLI's swapper
    (the reference's IR-SE-50 encoder) is cut to the small one-unit-a-group
    encoder of the files. Returns the output image."""
    from PIL import Image

    from e4s2024_torch import swap_cli
    from e4s2024_torch.pipelines import swap as swap_mod

    monkeypatch.setattr(swap_mod, "FaceSwapper",
                        functools.partial(FaceSwapper, encoder_num_units=UNITS))

    def run(src, tgt, *extra):
        Image.fromarray(src).save(tmp_path / "s.png")
        Image.fromarray(tgt).save(tmp_path / "t.png")
        swap_cli.main([
            "--source", str(tmp_path / "s.png"), "--target", str(tmp_path / "t.png"),
            "--out", str(tmp_path / "o.png"), "--rgi", str(checkpoints / "rgi.pt"),
            "--bisenet", str(checkpoints / "bisenet.pth"), "--size", str(SIZE),
            "--remaining_layer_idx", str(REMAINING), "--compute_dtype", "float32",
            "--device", "cpu", *extra])
        return np.asarray(Image.open(tmp_path / "o.png"))

    return run


def test_cli_aligned(cli):
    src, tgt = (f[:SIZE, :SIZE] for f in _frames(24, 2))
    out = cli(src, tgt, "--aligned")
    assert out.shape == (SIZE, SIZE, 3) and out.dtype == np.uint8


def test_cli_landmarks_json(cli, tmp_path, swappers):
    """Precomputed landmarks: the CLI's output equals FaceSwapper.swap with
    the same landmarks and weights in the CLI's configuration (the small
    swapper with the SwapConfig default of 10 blend levels)."""
    _, swap = swappers
    src, tgt = _frames(25, 2)
    lms = {p: swap.landmark_fn(img) for p, img in (("s.png", src), ("t.png", tgt))}
    table = {os.path.abspath(str(tmp_path / p)): v.tolist() for p, v in lms.items()}
    (tmp_path / "lm.json").write_text(json.dumps(table))
    out = cli(src, tgt, "--landmarks-json", str(tmp_path / "lm.json"))
    seq = iter([lms["s.png"], lms["t.png"]])
    ref = copy.copy(swap)
    ref.cfg = dataclasses.replace(swap.cfg, num_blend_levels=SwapConfig().num_blend_levels)
    ref.landmark_fn = lambda img: next(seq)
    np.testing.assert_array_equal(out, ref.swap(src, tgt))


def test_cli_unaligned_uses_default_detector(cli, tmp_path, monkeypatch):
    """Without --landmarks-json the CLI builds the default stack (random
    weights here, a warning says so) on the asked-for device."""
    orig = detect.default_landmarker
    monkeypatch.setenv("E4S_WEIGHTS", str(tmp_path))
    monkeypatch.setattr(detect, "default_landmarker", lambda *a, **kw: orig(
        *a, det_size=DET, fan_modules=1, fan_features=32, fan_depth=2,
        fan_resolution=FAN_RES, **kw))
    src, tgt = _frames(26, 2)
    with pytest.warns(UserWarning, match="RANDOM"):
        out = cli(src, tgt)
    assert out.shape == tgt.shape and out.dtype == np.uint8


def test_cli_refuses_checkpoint_directories(tmp_path, checkpoints):
    from e4s2024_torch.swap_cli import load_params

    with pytest.raises(ValueError, match="directory"):
        load_params(str(tmp_path))


def test_cli_needs_the_card_unless_asked_for_the_cpu(tmp_path, checkpoints):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the check is for hosts without one")
    from PIL import Image

    from e4s2024_torch import swap_cli

    src = _frames(27, 1)[0]
    Image.fromarray(src).save(tmp_path / "s.png")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        swap_cli.main(["--source", str(tmp_path / "s.png"), "--target", str(tmp_path / "s.png"),
                       "--out", str(tmp_path / "o.png"), "--rgi", str(checkpoints / "rgi.pt"),
                       "--bisenet", str(checkpoints / "bisenet.pth")])
