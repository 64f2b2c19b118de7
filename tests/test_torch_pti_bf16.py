"""bfloat16 tuning in the port's coaches (e4s2024_torch.training.pti)
against the JAX package's, on the CPU, on tests/test_pti_optim.py's tiny
RGINet (64^2, remaining_layer_idx 7) with tests/test_torch_coaches.py's net
and helpers, JAX held with scan_steps=1.

`compute_dtype="bfloat16"` runs the steps in bfloat16 over float32 master
weights; a bfloat16 net (a bfloat16 swapper's) is tuned as bfloat16 master
weights, as the JAX package tunes the bfloat16 variables it is given. The
bfloat16 PTI coach against JAX's is
tests/test_torch_pti.py::test_coach_refuses_what_is_not_ported, the
bfloat16 video pipeline against JAX's
tests/test_torch_video.py::test_video_pipeline_refuses_bfloat16 (both keep
the names of the refusals they replaced), bfloat16 stitching in
tests/test_torch_stitching.py (beside the float32 stitching test, whose
JAX tune it shares; this file stays under a minute of worker time).
"""

import copy

import numpy as np
import torch

import jax
import jax.numpy as jnp

from e4s2024_tpu.training import pti as jpti

from e4s2024_torch.training import pti
from tests.test_torch_coaches import _assert_history, _clip, tiny  # noqa: F401
from tests.test_torch_criterion import two_threads  # noqa: F401

L2_ONLY = dict(lpips_lambda=0.0, id_lambda=0.0, face_parsing_lambda=0.0)


def test_pti_bfloat16_keeps_float32_master_weights(tiny):
    """tests/test_pti_optim.py::test_pti_bf16_compute's tune (L2 + recolor
    at lr 1e-3) on 2 frames, 3 steps in fast mode: the lowest loss under
    the first, the tuned weights float32, the frozen ones unchanged, each
    metric a float32 host float. (Mini-batches and chunks in bfloat16 are
    held against JAX in tests/test_torch_pti.py.)"""
    _, _, net = tiny
    rng = np.random.default_rng(0)
    frames = (rng.standard_normal((2, 64, 64, 3)) * 0.3).astype(np.float32)
    labels = rng.integers(0, 12, (2, 64, 64))
    sv = (rng.standard_normal((2, 12, 1280)) * 0.1).astype(np.float32)
    kw = dict(max_pti_steps=3, compute_dtype="bfloat16", recolor_lambda=1.0,
              learning_rate=1e-3, regional_mode="fast", frames_per_chunk=None, **L2_ONLY)
    tuned, hist = pti.PTICoach(net, {}, pti.PTIConfig(**kw)).tune(None, frames, labels, sv, frames)
    assert min(h["loss"] for h in hist) < hist[0]["loss"]
    start = net.state_dict()
    assert all(v.dtype == torch.float32 for v in tuned.values() if v.is_floating_point())
    assert torch.equal(tuned["G.style.1.weight"], start["G.style.1.weight"])
    assert not torch.equal(tuned["G.conv1.conv.weight"], start["G.conv1.conv.weight"])
    assert all(isinstance(v, float) for h in hist for v in h.values())


def test_bfloat16_net_is_tuned_in_its_own_dtype(tiny):
    """A bfloat16 copy of the net (a bfloat16 swapper's), PTIConfig's
    default compute dtype, against JAX's PTICoach on the same weights and
    style vectors cast to bfloat16 (what a bfloat16 JAX swapper hands its
    coach): 2 steps of L2 + recolor on 2 frames in fast mode, both in bfloat16; the
    losses within 2e-2 relative (bfloat16 roundings at other places;
    measured 3.5e-3, CPU), the
    tuned weights bfloat16 as JAX's, the caller's net left as it was."""
    jnet, variables, net = tiny
    frames, labels, sv, recolor = _clip(13, 2)
    bnet = copy.deepcopy(net).to(torch.bfloat16)
    before = {k: v.clone() for k, v in bnet.state_dict().items()}
    sv16 = torch.from_numpy(sv).to(torch.bfloat16)
    kw = dict(max_pti_steps=2, learning_rate=1e-3, frames_per_chunk=None,
              regional_mode="fast", **L2_ONLY)
    tuned, hist = pti.PTICoach(bnet, {}, pti.PTIConfig(**kw)).tune(None, frames, labels, sv16,
                                                                  recolor)
    bf16 = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), (variables, sv))
    jtuned, jhist = jpti.PTICoach(jnet, {}, jpti.PTIConfig(scan_steps=1, remat=False, **kw)).tune(
        bf16[0], frames, labels, bf16[1], recolor)
    _assert_history(hist, jhist, (2e-2,) * 2)
    assert tuned["G.conv1.conv.weight"].dtype == torch.bfloat16
    assert jtuned["params"]["generator"]["conv1"]["conv"]["weight"].dtype == jnp.bfloat16
    assert all(torch.equal(v, before[k]) for k, v in bnet.state_dict().items())
