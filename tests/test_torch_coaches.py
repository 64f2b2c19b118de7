"""The port's PTI coach against the JAX package's, on the CPU, on
tests/test_pti_optim.py's tiny RGINet (64^2, remaining_layer_idx 7), held
against JAX with scan_steps=1 (the JAX package's own scan path disagrees
with its per-step loop). The coach runs the L2 and recolor terms, whose
gradients flow through the whole synthesis; the loss nets are held in
tests/test_torch_criterion.py, the stitching coach in
tests/test_torch_stitching.py. The tiny net and the comparison helpers
here serve both.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from e4s2024_tpu.models.rgi import RGINet as JRGINet
from e4s2024_tpu.training import pti as jpti

from e4s2024_torch.convert import rgi_state_dict_from_jax
from e4s2024_torch.models.rgi import RGINet
from e4s2024_torch.training import pti
from tests.test_torch_criterion import two_threads  # noqa: F401
from tests.test_torch_models import random_params

TINY = dict(out_size=64, remaining_layer_idx=7, channel_multiplier=1, encoder_input_size=64,
            encoder_num_units=(1, 1, 2, 1))


@pytest.fixture(scope="module")
def tiny():
    """The tiny RGINet of tests/test_pti_optim.py: JAX module and variables
    (a numpy seed), the port's net with the same weights."""
    jnet = JRGINet(**TINY)
    variables = random_params(jax.eval_shape(
        jnet.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
        jnp.zeros((1, 64, 64, 12))), 5)
    net = RGINet(num_seg_cls=12, **TINY)
    net.load_state_dict(rgi_state_dict_from_jax(variables), strict=True)
    return jnet, variables, net.eval()


def _clip(seed, f):
    rng = np.random.default_rng(seed)
    frames = (rng.random((f, 64, 64, 3)) * 255).astype(np.uint8)
    recolor = (rng.random((f, 64, 64, 3)) * 255).astype(np.uint8)
    base = rng.integers(0, 12, (f, 8, 8))
    labels = np.repeat(np.repeat(base, 8, 1), 8, 2).astype(np.uint8)
    sv = (rng.standard_normal((f, 12, 1280)) * 0.1).astype(np.float32)
    return frames, labels, sv, recolor


def _port_params(jax_params, variables):
    """JAX params (or gradients) as a port state dict."""
    return rgi_state_dict_from_jax({"params": jax_params, "buffers": variables["buffers"]})


def _check_tuned(got_sd, want_vars, variables, lr, steps, max_rel):
    """Adam moves an element by about lr * sign(g) a step whatever the size
    of g, so where a gradient is near 0 the packages' float32 noise can
    step it either way: a tuned element may differ by up to 2 lr a step.
    Each tensor's update (tuned - initial) is held within `max_rel` of
    JAX's in norm."""
    want = _port_params(want_vars["params"], variables)
    init = _port_params(variables["params"], variables)
    worst, rel = 0.0, 0.0
    for k, w in want.items():
        worst = max(worst, float((got_sd[k] - w).abs().max()))
        moved = (w - init[k]).norm()
        if moved > 0:
            rel = max(rel, float((got_sd[k] - w).norm() / moved))
    assert worst <= 2 * lr * steps, worst
    assert rel <= max_rel, rel


def _assert_history(hist, jhist, rel):
    """Per-step metrics, step i within rel[i] of JAX's."""
    assert len(hist) == len(jhist) == len(rel)
    for a, b, r in zip(hist, jhist, rel):
        assert set(a) == set(b)
        for k in b:
            assert a[k] == pytest.approx(b[k], rel=r), (k, a[k], b[k])


@pytest.mark.parametrize("mode", ["frames_per_chunk", "frames_per_step"])
def test_pti_coach_matches_jax(tiny, mode):
    """3 steps of L2 + recolor (lr 1e-3): 2 frames in two chunks of one
    frame a step, or mini-batches of 2 of 3 frames (JAX's draw). Against
    JAX's PTICoach (scan_steps=1; the port recomputes the synthesis under
    remat, JAX does not; the chunked port against JAX's whole-clip step,
    the same frame mean, which JAX's own tests hold against its chunked
    one): the losses within 2e-5 (measured 7.1e-6 at step 3), each tensor's
    update within 3% (measured 0.83% and 0.29%, CPU). The first step's
    gradient is held in tests/test_torch_pti.py."""
    jnet, variables, net = tiny
    frames, labels, sv, recolor = _clip(10, 2 if mode == "frames_per_chunk" else 3)
    kw = dict(max_pti_steps=3, learning_rate=1e-3, lpips_lambda=0.0, id_lambda=0.0,
              face_parsing_lambda=0.0)
    kw.update(frames_per_chunk=1) if mode == "frames_per_chunk" else kw.update(
        frames_per_step=2, sample_seed=3)
    coach = pti.PTICoach(net, {}, pti.PTIConfig(**kw))
    jcoach = jpti.PTICoach(jnet, {}, jpti.PTIConfig(scan_steps=1, remat=False, **dict(
        kw, frames_per_chunk=None)))

    tuned, hist = coach.tune(None, frames, labels, sv, recolor)
    jtuned, jhist = jcoach.tune(variables, frames, labels, sv, recolor)
    _assert_history(hist, jhist, (2e-5,) * 3)
    _check_tuned(tuned, jtuned, variables, 1e-3, 3, max_rel=0.03)
    # the caller's net is untouched; the style MLP is frozen, conv1 trains
    start = rgi_state_dict_from_jax(variables)
    assert all(torch.equal(v, start[k]) for k, v in net.state_dict().items())
    assert torch.equal(tuned["G.style.1.weight"], start["G.style.1.weight"])
    assert not torch.equal(tuned["G.conv1.conv.weight"], start["G.conv1.conv.weight"])
