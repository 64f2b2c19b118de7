"""The port's stitching coach against the JAX package's, on the CPU, on
tests/test_pti_optim.py's tiny RGINet (64^2, remaining_layer_idx 7), with
tests/test_torch_coaches.py's net and helpers; held against JAX with
scan_steps=1, in float32 and in bfloat16 steps.
"""

import numpy as np
import pytest
import torch

from e4s2024_tpu.training import pti as jpti

from e4s2024_torch.training import pti
from tests.test_torch_coaches import _assert_history, _check_tuned, _clip, tiny  # noqa: F401
from tests.test_torch_criterion import _images, two_threads  # noqa: F401


KW = dict(max_steps=3, outer_dilation=3, learning_rate=1e-2, lpips_lambda=0.0,
          regional_mode="fast")


@pytest.fixture(scope="module")
def stitch_inputs():
    frames, labels, sv, _ = _clip(11, 2)
    content = (_images(12, 2, 64) * 0.9).astype(np.float32)
    return content, frames, labels, sv


@pytest.fixture(scope="module")
def jax_tune(tiny, stitch_inputs):
    """JAX's StitchingCoach (scan_steps=1) on the inputs: (tuned variables,
    per-step metrics), which both tests hold the port against."""
    jnet, variables, _ = tiny
    return jpti.StitchingCoach(jnet, {}, jpti.StitchingConfig(
        scan_steps=1, remat=False, **KW)).tune(variables, *stitch_inputs)


def test_stitching_coach_matches_jax(tiny, stitch_inputs, jax_tune):
    """3 steps of content L2 and the border ring's L2 (outer dilation 3, lr
    1e-2) in fast regional mode (the mode is not the point here), 2
    frames, content float [-1, 1] and border frames uint8, against
    JAX's StitchingCoach (scan_steps=1). The first step's loss within 1e-6
    (measured 3.1e-7); at lr 1e-2 the sign noise of near-0 gradients grows
    faster, so the later losses are held within 1e-3 (measured 7.6e-5) and
    each update within 10% (measured 0.86%, CPU; in exact mode 1.8e-7,
    1.7e-4 and 3.7%)."""
    _, variables, net = tiny
    tuned, hist = pti.StitchingCoach(net, {}, pti.StitchingConfig(**KW)).tune(
        None, *stitch_inputs)
    jtuned, jhist = jax_tune
    _assert_history(hist, jhist, (1e-6, 1e-3, 1e-3))
    assert hist[-1]["loss"] < hist[0]["loss"]
    _check_tuned(tuned, jtuned, variables, 1e-2, 3, max_rel=0.1)


def test_stitching_bfloat16_matches_jax(tiny, stitch_inputs, jax_tune):
    """The same 3 steps in bfloat16 against JAX's StitchingCoach, whose
    config has no compute dtype (float32; the same objective): each step's
    loss within 2e-2 relative (bfloat16 rounds the synthesis and the loss to
    8 bits: 2^-8 = 3.9e-3 a rounding; measured 4.1e-3, CPU), the loss falls,
    the tuned weights float32."""
    _, _, net = tiny
    tuned, hist = pti.StitchingCoach(net, {}, pti.StitchingConfig(
        compute_dtype="bfloat16", **KW)).tune(None, *stitch_inputs)
    _assert_history(hist, jax_tune[1], (2e-2,) * 3)
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert all(v.dtype == torch.float32 for v in tuned.values() if v.is_floating_point())
