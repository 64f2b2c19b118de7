"""The port's enhanced face swap (FullFaceSwapPipeline with the SwinIR
enhancer) against the JAX package's, end to end on the CPU.

The configuration is tests/test_torch_swap.py's (128^2 output,
remaining_layer_idx=9, 4 blend levels, one encoder unit per group) with the
tiny SwinIR of tests/test_torch_swinir.py as the "swinir" enhancer. JAX runs
its staged path, as it does for this enhancer (which has no fused form);
the port runs the plain versions of its kernels.
"""

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
from e4s2024_torch.pipelines.full_swap import FullFaceSwapPipeline, FullSwapConfig, SwapComponents
from e4s2024_torch.pipelines.swap import FaceSwapper, SwapConfig
from tests.test_torch_models import random_params
from tests.test_torch_swinir import TINY, swin_params

SIZE, REMAINING, LEVELS, UNITS = 128, 9, 4, (1, 1, 1, 1)


@pytest.fixture(scope="module")
def pipelines():
    jrgi = JRGINet(out_size=SIZE, remaining_layer_idx=REMAINING, encoder_num_units=UNITS)
    rgi_vars = random_params(jax.eval_shape(
        jrgi.init, jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)),
        jnp.zeros((1, SIZE, SIZE, 12))), 11)
    bise = random_params(jax.eval_shape(
        JBiSeNet().init, jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3)))["params"], 12)
    jsr = JSwinIR(**TINY)
    sr = swin_params(jax.eval_shape(jsr.init, jax.random.PRNGKey(2),
                                    jnp.zeros((1, 16, 16, 3)))["params"], 22)
    kw = dict(out_size=SIZE, remaining_layer_idx=REMAINING, num_blend_levels=LEVELS)

    jswap = JFaceSwapper(rgi_vars, bise, JSwapConfig(**kw))
    jswap.rgi = jrgi  # the JAX swapper builds the full-depth encoder
    jenh = JSwinIREnhancer(JSwinIRUpscaler(sr, model=jsr))
    jpipe = JFullFaceSwapPipeline(jswap, JSwapComponents(enhancers={"swinir": jenh.enhance_aligned}),
                                  JFullSwapConfig(enhancement_mode="swinir"))

    swap = FaceSwapper(rgi_state_dict_from_jax(rgi_vars), bisenet_state_dict_from_jax(bise),
                       SwapConfig(**kw), device="cpu", encoder_num_units=UNITS)
    enh = SwinIREnhancer(SwinIRUpscaler(swinir_state_dict_from_jax(sr), device="cpu", **TINY))
    pipe = FullFaceSwapPipeline(swap, SwapComponents(enhancers={"swinir": enh.enhance_aligned}),
                                FullSwapConfig(enhancement_mode="swinir"))
    return jpipe, pipe


def _pairs(seed, b):
    rng = np.random.default_rng(seed)
    # smooth crops, so that the enhancer's float output is not noise
    coarse = rng.random((2, b, 8, 8, 3))
    img = np.kron(coarse, np.ones((1, 1, SIZE // 8, SIZE // 8, 1))) * 200
    img += rng.random(img.shape) * 55
    return img[0].astype(np.uint8), img[1].astype(np.uint8)


def _assert_close_images(got, want, max_levels, mean_levels):
    assert got.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= max_levels, diff.max()
    assert diff.mean() <= mean_levels, diff.mean()


def test_enhanced_swap_matches_jax(pipelines):
    jpipe, pipe = pipelines
    src, tgt = _pairs(31, 1)
    want = jpipe(src[0], tgt[0], return_intermediates=True)
    got = {k: v.numpy() for k, v in pipe(src[0], tgt[0], return_intermediates=True).items()}
    assert set(got) == {"image", "driven", "swapped_mask", "hole_mask"}
    # the enhanced float crop is truncated to uint8 on both sides; where the
    # two float32 enhancers straddle an integer the driven crops differ by
    # one level
    _assert_close_images(got["driven"], want["driven"], 1, 0.01)
    assert not np.array_equal(got["driven"], src[0])  # the enhancer ran
    # where a driven pixel differs by one level, BiSeNet's argmax may flip
    # at a near-tie: the masks agree on all but a 1e-4 fraction of pixels
    for key in ("swapped_mask", "hole_mask"):
        assert got[key].shape == want[key].shape == (512, 512)
        assert np.mean(got[key] != np.asarray(want[key])) <= 1e-4, key
    assert len(np.unique(got["swapped_mask"])) > 1
    # float32 synthesis and compositing on both sides, from style vectors
    # that the few one-level driven differences move slightly
    _assert_close_images(got["image"], want["image"], 2, 0.02)


def test_swap_batch_matches_jax(pipelines):
    jpipe, pipe = pipelines
    src, tgt = _pairs(32, 2)
    want = np.asarray(jpipe.swap_batch(src, tgt))
    got = pipe.swap_batch(src, tgt).numpy()
    assert got.shape == (2, SIZE, SIZE, 3)
    _assert_close_images(got, want, 2, 0.02)


def test_unported_components_raise(pipelines):
    _, pipe = pipelines
    for comp, cfg in [(SwapComponents(pose_driver=object()), None),
                      (SwapComponents(recolorer=object()), None),
                      (SwapComponents(upscaler=object()), None),
                      (SwapComponents(inpainter=object()), None),
                      (None, FullSwapConfig(optimize_w_steps=5)),
                      (None, FullSwapConfig(ct_mode="rct"))]:
        with pytest.raises(NotImplementedError):
            FullFaceSwapPipeline(pipe.swapper, comp, cfg)


def test_mode_resolution_and_identity(pipelines):
    """"gpen" wins when present, as in JAX; no enhancer for the mode is the
    identity."""
    _, pipe = pipelines
    crop = torch.from_numpy(_pairs(33, 1)[0][0])
    seen = []
    comp = SwapComponents(enhancers={"gpen": lambda x: seen.append("gpen") or x + 1,
                                     "swinir": lambda x: seen.append("swinir") or x})
    full = FullFaceSwapPipeline(pipe.swapper, comp, FullSwapConfig(enhancement_mode="swinir"))
    assert torch.equal(full._enhance(crop, "gpen"), crop.float() + 1)
    assert torch.equal(full._enhance(crop), crop.float())
    assert seen == ["gpen", "swinir"]
    plain = FullFaceSwapPipeline(pipe.swapper)
    assert plain._enhance(crop) is crop
