"""The Blender stage of the port's reenacted swap against the JAX package's,
on the CPU. A pose driver makes the call staged, so the recolor reads a
19-class parse of the float driven crop of its own (parse19), not the core
swap's: both stages run here on a float crop with fractional values, as a
drive leaves it, and a swap output, through the staged stages of each
pipeline (tests/test_torch_default_swap.py's 128^2 swapper and Blender
file). The whole reenacted call is held in tests/test_torch_reenact_swap.py
and tests/test_torch_reenact_gate.py (GPEN and GCFSR).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from e4s2024_tpu.convert.torch_loader import convert_blender
from e4s2024_tpu.models.blender import BlenderRecolorer as JBlenderRecolorer
from e4s2024_tpu.pipelines.full_swap import FullFaceSwapPipeline as JFullFaceSwapPipeline
from e4s2024_tpu.pipelines.full_swap import SwapComponents as JSwapComponents

from e4s2024_torch.models import blender
from e4s2024_torch.models.blender import BlenderRecolorer
from e4s2024_torch.pipelines.full_swap import FullFaceSwapPipeline, SwapComponents
from tests.test_torch_aux_nets import SPECTRAL
from tests.test_torch_criterion import two_threads  # noqa: F401  (autouse fixture)
from tests.test_torch_default_swap import small_swappers
from tests.test_torch_facevid2vid import np_sd
from tests.test_torch_gpen import reference_state_dict
from tests.test_torch_reenact_swap import pairs


class _Driver:
    """A pose driver that is never called: its presence makes the call staged."""

    def drive(self, *a):
        raise AssertionError("not called by these stages")


@pytest.fixture(scope="module")
def pipelines():
    jswap, swap = small_swappers()
    with torch.device("meta"):
        net = blender.Blender()
    sd = reference_state_dict(net, 41, spectral=SPECTRAL)
    jpipe = JFullFaceSwapPipeline(jswap, JSwapComponents(
        recolorer=JBlenderRecolorer(convert_blender(np_sd(sd))), pose_driver=_Driver()))
    pipe = FullFaceSwapPipeline(swap, SwapComponents(
        recolorer=BlenderRecolorer(sd, device="cpu"), pose_driver=_Driver()))
    return jpipe, pipe


def test_staged_parse19_and_recolor_match_jax(pipelines):
    """The driven crop's and the target's parse as JAX's staged call takes
    them (the float crop / 255), then Blender at 256^2 and the edge-aware
    composite at 128^2."""
    jpipe, pipe = pipelines
    src, tgt = pairs(56, 1)
    rng = np.random.default_rng(57)
    driven = np.clip(src[0] + rng.uniform(-3, 3, src[0].shape), 0, 255).astype(np.float32)
    swapped = np.clip(tgt[0] * 0.7 + driven * 0.3, 0, 255).astype(np.float32)
    assert not pipe._fused()
    d19, t19 = pipe._parse19(torch.from_numpy(driven)[None], torch.from_numpy(tgt), {})
    jsw = jpipe.swapper
    want_d19 = np.asarray(jsw._parse19(jnp.asarray(driven)[None] / 255.0))[0]
    want_t19 = np.asarray(jsw._parse19(jnp.asarray(tgt, jnp.float32) / 255.0))[0]
    # BiSeNet's argmax may flip at a near-tie: a 1e-4 fraction of pixels
    assert np.mean(d19[0].numpy() != want_d19) <= 1e-4
    assert np.mean(t19[0].numpy() != want_t19) <= 1e-4
    assert len(np.unique(want_d19)) > 1
    want = np.asarray(jpipe._recolor(jnp.asarray(swapped), jnp.asarray(tgt[0]),
                                     jnp.asarray(want_d19), jnp.asarray(want_t19)))
    got = pipe._recolor(torch.from_numpy(swapped)[None], torch.from_numpy(tgt),
                        torch.from_numpy(want_d19)[None],
                        torch.from_numpy(want_t19)[None]).numpy()[0]
    assert got.shape == (128, 128, 3)
    # Blender's float32 sums on both sides, through the x2 resize and blend
    err = np.abs(got - want)
    assert err.max() <= 0.05 and err.mean() <= 5e-3, (err.max(), err.mean())
    assert np.abs(got - swapped).mean() > 1.0  # the recolor changed the swap
