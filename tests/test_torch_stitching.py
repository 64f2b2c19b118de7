"""The port's stitching coach against the JAX package's, on the CPU, on
tests/test_pti_optim.py's tiny RGINet (64^2, remaining_layer_idx 7), with
tests/test_torch_coaches.py's net and helpers; held against JAX with
scan_steps=1.
"""

import numpy as np

from e4s2024_tpu.training import pti as jpti

from e4s2024_torch.training import pti
from tests.test_torch_coaches import _assert_history, _check_tuned, _clip, tiny  # noqa: F401
from tests.test_torch_criterion import _images, two_threads  # noqa: F401


def test_stitching_coach_matches_jax(tiny):
    """3 steps of content L2 and the border ring's L2 (outer dilation 3, lr
    1e-2), 2 frames, content float [-1, 1] and border frames uint8, against
    JAX's StitchingCoach (scan_steps=1). The first step's loss within 1e-6
    (measured 1.8e-7); at lr 1e-2 the sign noise of near-0 gradients grows
    faster, so the later losses are held within 1e-3 (measured 1.7e-4) and
    each update within 10% (measured 3.7%, CPU)."""
    jnet, variables, net = tiny
    frames, labels, sv, _ = _clip(11, 2)
    content = (_images(12, 2, 64) * 0.9).astype(np.float32)
    kw = dict(max_steps=3, outer_dilation=3, learning_rate=1e-2, lpips_lambda=0.0)
    tuned, hist = pti.StitchingCoach(net, {}, pti.StitchingConfig(**kw)).tune(
        None, content, frames, labels, sv)
    jtuned, jhist = jpti.StitchingCoach(
        jnet, {}, jpti.StitchingConfig(scan_steps=1, remat=False, **kw)).tune(
        variables, content, frames, labels, sv)
    _assert_history(hist, jhist, (1e-6, 1e-3, 1e-3))
    assert hist[-1]["loss"] < hist[0]["loss"]
    _check_tuned(tuned, jtuned, variables, 1e-2, 3, max_rel=0.1)
