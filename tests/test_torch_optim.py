"""The port's W-space refinement (e4s2024_torch.training.optim) against the
JAX package's optax-based `optimize_style_vectors`, on the CPU, and the
pipeline's optimize_W path.

The update rules of the four optimisers are held against optax's on a
sequence of gradients; the refinement itself against JAX's on the tiny
RGINet of tests/test_torch_coaches.py (64^2, exact regional mode as JAX's
`gen_img` default) with the L2 term alone, two steps of Adam.
"""

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

from e4s2024_tpu.losses.recon import ReconCriterion as JReconCriterion
from e4s2024_tpu.training.optim import optimize_style_vectors as j_optimize_style_vectors

from e4s2024_torch.losses.recon import ReconCriterion
from e4s2024_torch.models.bisenet import BiSeNet
from e4s2024_torch.models.rgi import RGINet
from e4s2024_torch.pipelines.full_swap import FullFaceSwapPipeline, FullSwapConfig
from e4s2024_torch.pipelines.swap import FaceSwapper, SwapConfig
from e4s2024_torch.training import optim
from tests.test_torch_coaches import tiny  # noqa: F401  (fixture)
from tests.test_torch_criterion import two_threads  # noqa: F401  (autouse fixture)
from tests.test_torch_full_swap import LEVELS, REMAINING, SIZE, UNITS, _pairs

OPTAX = {"adam": optax.adam, "sgd": optax.sgd,
         "sgdm": lambda lr: optax.sgd(lr, momentum=0.9), "adamax": optax.adamax}


@pytest.mark.parametrize("name", sorted(OPTAX))
def test_update_rules_match_optax(name):
    rng = np.random.default_rng(60)
    grads = (rng.standard_normal((6, 40)) * np.logspace(-4, 1, 40)).astype(np.float32)
    tx = OPTAX[name](0.01)
    state = tx.init(jnp.zeros(40))
    mine = optim.OPTIMIZERS[name](0.01)
    mine_state = mine.init({"w": torch.zeros(40)})
    for g in grads:
        want, state = tx.update(jnp.asarray(g), state, jnp.zeros(40))
        got, mine_state = mine.update({"w": torch.from_numpy(g)}, mine_state,
                                      {"w": torch.zeros(40)})
        got = got["w"]
        # the bias corrections are float32 on both sides, but XLA's and
        # torch's float32 pow round decay^t differently at some t (1e-5
        # relative at t = 3 for 0.999); the rest is float32 rounding
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=1e-12)


def test_optimize_style_vectors_matches_jax(tiny):  # noqa: F811
    name = "adam"  # the others' rules: test_update_rules_match_optax
    jnet, variables, net = tiny
    rng = np.random.default_rng(61)
    img = (rng.random((1, 64, 64, 3)) * 2 - 1).astype(np.float32)
    labels = np.repeat(np.repeat(rng.integers(0, 12, (1, 8, 8)), 8, 1), 8, 2)
    onehot = np.eye(12, dtype=np.float32)[labels]
    sv0 = (rng.standard_normal((1, 12, 1280)) * 0.1).astype(np.float32)
    want_sv, want_losses = j_optimize_style_vectors(
        jnet, variables, JReconCriterion({}), jnp.asarray(img), jnp.asarray(onehot), steps=2,
        lr=1e-2, optimizer=name, init_style_vectors=jnp.asarray(sv0))
    got_sv, got_losses = optim.optimize_style_vectors(
        net, ReconCriterion({}), torch.from_numpy(img.transpose(0, 3, 1, 2)),
        torch.from_numpy(onehot.transpose(0, 3, 1, 2)), steps=2, lr=1e-2, optimizer=name,
        init_style_vectors=torch.from_numpy(sv0))
    # the L2 loss through the float32 generator, before each update
    np.testing.assert_allclose(got_losses.numpy(), np.asarray(want_losses), rtol=1e-5)
    # Adam moves an element by about lr whatever its gradient's size, so
    # where a gradient is rounding noise the two may step it either way;
    # the refinement (sv - sv0) is held in norm
    move, want_move = got_sv.numpy() - sv0, np.asarray(want_sv) - sv0
    assert np.linalg.norm(move - want_move) <= 1e-3 * np.linalg.norm(want_move)


def test_pipeline_optimize_w_stage(monkeypatch):
    """The pipeline's optimize_W path on a swapper of the small configuration
    (torch's seeded initialisation), the refinement itself replaced by its
    warm start (it is held above): each crop's style vectors from the
    full-resolution one-hot, the refined swap in place of the core swap."""
    torch.manual_seed(62)
    kw = dict(out_size=SIZE, remaining_layer_idx=REMAINING, num_blend_levels=LEVELS,
              regional_mode="fast")
    swap = FaceSwapper(RGINet(out_size=SIZE, remaining_layer_idx=REMAINING,
                              encoder_num_units=UNITS).state_dict(), BiSeNet().state_dict(),
                       SwapConfig(**kw), device="cpu", encoder_num_units=UNITS)
    calls = []

    def warm_start(net, crit, img, onehot, *, steps, lr):
        calls.append((tuple(img.shape), tuple(onehot.shape), steps, lr))
        return net.get_style_vectors(img, onehot)[0], torch.zeros(steps)

    monkeypatch.setattr(optim, "optimize_style_vectors", warm_start)
    src, tgt = _pairs(62, 1)
    pipe = FullFaceSwapPipeline(swap, None, FullSwapConfig(ct_mode="none", optimize_w_steps=3,
                                                           optimize_w_lr=0.05))
    out = pipe(src[0], tgt[0], verbose=True, return_intermediates=True)
    assert "optimize_w_swap" in out["stage_times"] and "core_swap" not in out["stage_times"]
    assert calls == [((1, 3, SIZE, SIZE), (1, 12, 512, 512), 3, 0.05)] * 2
    assert out["image"].shape == (SIZE, SIZE, 3) and out["swapped_mask"].shape == (512, 512)
    assert not pipe._fused()
