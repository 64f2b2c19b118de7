"""The port's zoo-enhanced face swap, FullFaceSwapPipeline at the
reference's default configuration (GPEN enhancement, Blender recolor with
the RealESRGAN upscaler, GCFSR inpainting), against the JAX package's
default call, on the CPU.

The swapper is tests/test_torch_full_swap.py's (128^2 output,
remaining_layer_idx 9, 4 blend levels, one encoder unit per group) in fast
regional mode on both sides (the mode is not what these tests hold, and
fast mode is 2.4x cheaper here); GPEN at
64^2 (narrow 0.25: the crop is resized to 64 and back), Blender at its only
width, RealESRGAN 16/2/8 (at 128^2 the 256^2 recolor is 4x too large for
the crop, so both pipelines skip it), GCFSR at 64^2 (narrow 0.25). JAX's
default call runs this configuration as its one fused program, in which the
enhanced float crop enters the swap as it is; the port computes the same
thing stage by stage, with the plain versions of its kernels.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from e4s2024_tpu.convert.torch_loader import (
    convert_blender, convert_gcfsr, convert_gpen, convert_rrdbnet)
from e4s2024_tpu.models.bisenet import BiSeNet as JBiSeNet
from e4s2024_tpu.models.blender import BlenderRecolorer as JBlenderRecolorer
from e4s2024_tpu.models.gcfsr import FaceInpainter as JFaceInpainter
from e4s2024_tpu.models.gcfsr import FaceInpainting as JFaceInpainting
from e4s2024_tpu.models.gpen import GPENEnhancer as JGPENEnhancer
from e4s2024_tpu.models.gpen import GPENFullGenerator as JGPENFullGenerator
from e4s2024_tpu.models.rgi import RGINet as JRGINet
from e4s2024_tpu.models.rrdb import RealESRGANUpscaler as JRealESRGANUpscaler
from e4s2024_tpu.models.rrdb import RRDBNet as JRRDBNet
from e4s2024_tpu.pipelines.full_swap import FullFaceSwapPipeline as JFullFaceSwapPipeline
from e4s2024_tpu.pipelines.full_swap import FullSwapConfig as JFullSwapConfig
from e4s2024_tpu.pipelines.full_swap import SwapComponents as JSwapComponents
from e4s2024_tpu.pipelines.swap import FaceSwapper as JFaceSwapper
from e4s2024_tpu.pipelines.swap import SwapConfig as JSwapConfig

from e4s2024_torch.convert import bisenet_state_dict_from_jax, rgi_state_dict_from_jax
from e4s2024_torch.models import blender
from e4s2024_torch.models.blender import BlenderRecolorer
from e4s2024_torch.models.gcfsr import FaceInpainter
from e4s2024_torch.models.gpen import GPENEnhancer
from e4s2024_torch.models.rrdb import RealESRGANUpscaler, RRDBNet
from e4s2024_torch.pipelines.full_swap import FullFaceSwapPipeline, FullSwapConfig, SwapComponents
from e4s2024_torch.pipelines.swap import FaceSwapper, SwapConfig
from tests.test_torch_aux_nets import GCFSR, SPECTRAL, gcfsr_reference_state_dict
from tests.test_torch_criterion import two_threads  # noqa: F401  (autouse fixture)
from tests.test_torch_full_swap import LEVELS, REMAINING, SIZE, UNITS, _pairs
from tests.test_torch_gpen import (
    GPEN, RRDB, gpen_reference_state_dict, np_sd, reference_state_dict)
from tests.test_torch_models import random_params


def zoo_state_dicts(seed: int = 40) -> dict:
    """Reference-style files for the four zoo nets."""
    with torch.device("meta"):
        bl, rr = blender.Blender(), RRDBNet(**RRDB)
    return {"gpen": gpen_reference_state_dict(seed),
            "blender": reference_state_dict(bl, seed + 1, spectral=SPECTRAL),
            "rrdb": reference_state_dict(rr, seed + 2),
            "gcfsr": gcfsr_reference_state_dict(seed + 3)[1]}


def port_components(sds: dict) -> SwapComponents:
    return SwapComponents(
        enhancers={"gpen": GPENEnhancer(sds["gpen"], 64, narrow=0.25,
                                        device="cpu").enhance_aligned},
        recolorer=BlenderRecolorer(sds["blender"], device="cpu"),
        upscaler=RealESRGANUpscaler(sds["rrdb"], **RRDB, device="cpu"),
        inpainter=FaceInpainter(sds["gcfsr"], 64, narrow=0.25, device="cpu"))


def small_swappers(seed: int = 41):
    """The JAX swapper and the port's, on the same seeded weights."""
    jrgi = JRGINet(out_size=SIZE, remaining_layer_idx=REMAINING, encoder_num_units=UNITS)
    rgi_vars = random_params(jax.eval_shape(
        jrgi.init, jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)),
        jnp.zeros((1, SIZE, SIZE, 12))), seed)
    bise = random_params(jax.eval_shape(
        JBiSeNet().init, jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3)))["params"], seed + 1)
    kw = dict(out_size=SIZE, remaining_layer_idx=REMAINING, num_blend_levels=LEVELS,
              regional_mode="fast")
    jswap = JFaceSwapper(rgi_vars, bise, JSwapConfig(**kw))
    jswap.rgi = jrgi  # the JAX swapper builds the full-depth encoder
    swap = FaceSwapper(rgi_state_dict_from_jax(rgi_vars), bisenet_state_dict_from_jax(bise),
                       SwapConfig(**kw), device="cpu", encoder_num_units=UNITS)
    return jswap, swap


@pytest.fixture(scope="module")
def pipelines():
    sds = zoo_state_dicts()
    jswap, swap = small_swappers()
    jgen = JGPENFullGenerator(**GPEN)
    jcomp = JSwapComponents(
        enhancers={"gpen": JGPENEnhancer(convert_gpen(np_sd(sds["gpen"])), 64,
                                         jgen).enhance_aligned},
        recolorer=JBlenderRecolorer(convert_blender(np_sd(sds["blender"]))),
        upscaler=JRealESRGANUpscaler(convert_rrdbnet(np_sd(sds["rrdb"])), JRRDBNet(**RRDB)),
        inpainter=JFaceInpainter(convert_gcfsr(np_sd(sds["gcfsr"])), JFaceInpainting(**GCFSR)))
    cfg = dict(face_inpainting=True)
    jpipe = JFullFaceSwapPipeline(jswap, jcomp, JFullSwapConfig(**cfg))
    pipe = FullFaceSwapPipeline(swap, port_components(sds), FullSwapConfig(**cfg))
    return jpipe, pipe


def test_default_swap_matches_jax(pipelines):
    jpipe, pipe = pipelines
    src, tgt = _pairs(42, 1)
    want = jpipe(src[0], tgt[0])  # the default call: JAX's fused program
    assert jpipe._fused_call is not None
    assert pipe._fused()
    got = pipe(src[0], tgt[0], return_intermediates=True, verbose=True)
    assert set(got["stage_times"]) == {"pose_align", "enhance", "core_swap", "parse19",
                                       "recolor", "inpaint", "package"}
    image = got["image"].numpy()
    assert image.shape == (SIZE, SIZE, 3) and image.dtype == np.uint8
    # the float enhanced crops agree to the GPEN nets' float32 order; where
    # a parse logit of a driven or target crop is near a tie, BiSeNet's
    # argmax may flip, and the recolor and the regional synthesis follow it
    # locally; and the core swap's float32 image, truncated, has about 1% of
    # its values a level apart (tests/test_torch_batch_swap.py); measured
    # on this pair: max 2 levels, mean 0.0082
    diff = np.abs(image.astype(np.int16) - np.asarray(want["image"]).astype(np.int16))
    assert diff.max() <= 2 and diff.mean() <= 0.02, (diff.max(), diff.mean())
    # every stage changed the picture: the enhanced crop, the recolored and
    # inpainted swap against the plain core swap of the enhanced crop
    assert not np.array_equal(got["driven"].numpy(), src[0])
    hole = got["hole_mask"].numpy()
    assert hole.shape == (512, 512) and hole.any(), "the random masks leave a hole"
