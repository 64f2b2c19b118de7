"""The port's PTI and stitching coaches over a process group at world size
2 (two spawned CPU ranks over gloo) against the JAX package's coaches on
a 2-device frame-axis mesh (`mesh=make_mesh(2, axis="fr")`), on
tests/test_torch_coaches.py's tiny RGINet (64^2, fast mode, loss nets off,
no recomputation on either side): 4 frames, 2 steps, each rank tuning its
2 frames (PTI in chunks of one frame, stitching in one chunk); and the
refusal of a frame count that the world does not divide. The video pipeline over a group is held in
tests/test_torch_shard_serving.py, whose ranks build its swapper.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e4s2024_tpu.models.rgi import RGINet as JRGINet
from e4s2024_tpu.parallel import make_mesh
from e4s2024_tpu.training import pti as jpti

from e4s2024_torch.convert import rgi_state_dict_from_jax
from tests.test_torch_coaches import TINY, _assert_history, _check_tuned, _clip
from tests.test_torch_criterion import _images
from tests.test_torch_coach import module_threads  # noqa: F401
from tests.test_torch_models import random_params
from tests.torch_ranks import start_ranks, tuning_world

STEPS = 2
PTI = dict(max_pti_steps=STEPS, learning_rate=1e-3, lpips_lambda=0.0, id_lambda=0.0,
           face_parsing_lambda=0.0, regional_mode="fast")
STITCH = dict(max_steps=STEPS, outer_dilation=3, learning_rate=1e-2, lpips_lambda=0.0,
              regional_mode="fast")


@pytest.fixture(scope="module")
def runs(tmp_path_factory, module_threads):
    jnet = JRGINet(**TINY)
    variables = random_params(jax.eval_shape(
        jnet.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
        jnp.zeros((1, 64, 64, 12))), 5)
    pti_clip = _clip(20, 4)
    frames, labels, sv, _ = _clip(21, 4)
    stitch_clip = ((_images(22, 4, 64) * 0.9).astype(np.float32), frames, labels, sv)
    inputs = {
        "net": TINY, "sd": rgi_state_dict_from_jax(variables), "steps": STEPS,
        "pti": dict(PTI, frames_per_chunk=1, remat=False), "pti_clip": pti_clip,
        "stitching": dict(STITCH, frames_per_chunk=2, remat=False), "stitch_clip": stitch_clip}
    ranks = start_ranks(tuning_world, inputs, tmp_path_factory.mktemp("pti_group"))

    # JAX on a 2-device frame-axis mesh
    mesh = make_mesh(2, axis="fr")
    jpti_run = jpti.PTICoach(jnet, {}, jpti.PTIConfig(scan_steps=1, remat=False, **PTI),
                             mesh=mesh).tune(variables, *pti_clip)
    jstitch_run = jpti.StitchingCoach(jnet, {}, jpti.StitchingConfig(
        scan_steps=1, remat=False, **STITCH), mesh=mesh).tune(variables, *stitch_clip)
    return dict(variables=variables, ranks=ranks.join(), jpti=jpti_run, jstitch=jstitch_run)


def test_pti_over_the_group_matches_jax_frame_mesh(runs):
    """Per-step losses within 2e-5 relative and each tensor's update within
    3% of JAX's in norm, each element within 2 lr a step
    (tests/test_torch_coaches.py's bounds); both ranks hold the same
    weights."""
    jtuned, jhist = runs["jpti"]
    tuned, hist, _ = runs["ranks"][0]["pti"]
    _assert_history(hist, jhist, (2e-5,) * STEPS)
    _check_tuned(tuned, jtuned, runs["variables"], 1e-3, STEPS, max_rel=0.03)
    (_, h0, fp0), (_, h1, fp1) = (rank["pti"] for rank in runs["ranks"])
    assert h1 == h0 and fp1 == fp0


def test_stitching_over_the_group_matches_jax_frame_mesh(runs):
    """The first step's loss within 1e-6 relative, the second's within 1e-3,
    each tensor's update within 10% of JAX's in norm
    (tests/test_torch_stitching.py's bounds); both ranks hold the same
    weights."""
    jtuned, jhist = runs["jstitch"]
    tuned, hist, _ = runs["ranks"][0]["stitching"]
    _assert_history(hist, jhist, (1e-6, 1e-3))
    _check_tuned(tuned, jtuned, runs["variables"], 1e-2, STEPS, max_rel=0.1)
    (_, h0, fp0), (_, h1, fp1) = (rank["stitching"] for rank in runs["ranks"])
    assert h1 == h0 and fp1 == fp0


def test_indivisible_frame_count_raises(runs):
    for rank in runs["ranks"]:
        msg = rank["refused"]
        assert msg is not None and "3" in msg and "2" in msg, msg
