"""The port's Coach against the JAX package's, on the CPU, at the tiny
trainer size (16^2, channel multiplier 1, remaining_layer_idx 5, one IR-SE
unit a group, B=4, fast regional mode; the encoder at 32^2): `fit` for 3
steps with d_every=2 and d_reg_every=2 (D with R1 at steps 0 and 2) from
the same weights (`convert.coach_state_from_jax`), the loss nets off (the
criterion is held in tests/test_torch_criterion.py): the metrics, the
parameters, the frozen set and the EMA. The port's own state handling
(remat, the EMA's formula, checkpoints, validation, reference files) is
held in tests/test_torch_coach_state.py, so that each file stays within
its share of the suite's time.

The JAX state is built from numpy-seeded parameters (`random_params`)
instead of `Coach.init_state`, whose jitted inits cost more to compile
here than the steps themselves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from e4s2024_tpu.models import Discriminator as JDiscriminator
from e4s2024_tpu.models.rgi import RGINet as JRGINet
from e4s2024_tpu.training import Coach as JCoach
from e4s2024_tpu.training import TrainConfig as JTrainConfig
from e4s2024_tpu.training.coach import CoachState as JCoachState
from e4s2024_tpu.training.coach import _g_trainable_mask as j_mask

from e4s2024_torch.convert import coach_state_from_jax, rgi_state_dict_from_jax
from e4s2024_torch.training.coach import EMA_ACCUM, Coach, TrainConfig
from tests.test_torch_criterion import two_threads  # noqa: F401  (autouse fixture)
from tests.test_torch_models import random_params
from tests.torch_ranks import release_memory

# 16^2, not 32^2: the Discriminator is 512 channels wide at and under 32^2,
# and at 32^2 its R1 steps made this file 108 s of worker time in the
# suite's six-worker run (4x the work of 16^2)
SIZE = 16
TINY = dict(out_size=SIZE, remaining_layer_idx=5, channel_multiplier=1, encoder_input_size=32,
            encoder_num_units=(1, 1, 1, 1), batch_size=4, d_every=2, d_reg_every=2,
            regional_mode="fast")
STEPS = 3


def _batches(seed, n, b=4):
    """n (img, onehot) NHWC batches: img in (-1, 1), a random 12-class map."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        img = np.tanh(rng.standard_normal((b, SIZE, SIZE, 3))).astype(np.float32)
        onehot = np.eye(12, dtype=np.float32)[rng.integers(0, 12, (b, SIZE, SIZE))]
        out.append((img, onehot))
    return out


def _nchw(batches):
    return [(i.transpose(0, 3, 1, 2), s.transpose(0, 3, 1, 2)) for i, s in batches]


def _jax_start(cfg):
    """A JAX Coach and CoachState from numpy-seeded weights (as init_state
    builds it, without its jitted inits)."""
    coach = JCoach(cfg)
    x, s = jnp.zeros((1, SIZE, SIZE, 3)), jnp.zeros((1, SIZE, SIZE, 12))
    net = JRGINet(num_seg_cls=12, out_size=SIZE, remaining_layer_idx=5, channel_multiplier=1,
                  encoder_input_size=32, encoder_num_units=(1, 1, 1, 1))
    variables = random_params(jax.eval_shape(net.init, jax.random.PRNGKey(0), x, s), 3)
    d_params = random_params(jax.eval_shape(
        JDiscriminator(size=SIZE, channel_multiplier=1).init, jax.random.PRNGKey(1), x), 4)["params"]
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    coach._g_tx = optax.multi_transform(
        {True: coach._g_tx_inner, False: optax.set_to_zero()}, j_mask(params, cfg))
    state = JCoachState(step=jnp.zeros((), jnp.int32), params=params,
                        buffers=variables["buffers"],
                        ema_params=jax.tree_util.tree_map(jnp.copy, params), d_params=d_params,
                        g_opt=coach._g_tx.init(params), d_opt=coach._d_tx.init(d_params))
    return coach, state, coach_state_from_jax(variables["params"], variables["buffers"],
                                              variables["params"], d_params)


def _port(tree, **kw):
    coach = Coach(TrainConfig(**{**TINY, **kw}), device="cpu")
    return coach, coach.load_tree(coach.init_state(torch.Generator().manual_seed(0)), tree)


@pytest.fixture(scope="module")
def module_threads():
    """Two torch threads for a module-scoped fixture (set up before the
    function-scoped `two_threads`), restored after the module, whose
    memory then goes back to the system (`torch_ranks.release_memory`)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
    release_memory()


@pytest.fixture(scope="module")
def runs(module_threads):
    batches = _batches(0, STEPS)
    jcoach, jstate, tree = _jax_start(JTrainConfig(**TINY))
    jlogs = []
    jstate = jcoach.fit(batches, jstate, STEPS, callback=lambda s, m: jlogs.append((s, m)))
    coach, state = _port(tree)
    logs = []
    state = coach.fit(_nchw(batches), state, STEPS, callback=lambda s, m: logs.append((s, m)))
    return dict(tree=tree, jstate=jstate, jlogs=jlogs, state=state, logs=logs)


def test_fit_metrics_match_jax(runs):
    """Each step's metrics: D with R1 at steps 0 and 2, G every step; step 0
    within 1e-4 relative of JAX's (float32 summation order; R1 a second
    derivative), later steps within 1e-3 (Adam turns rounding noise in
    near-zero gradients into lr-sized steps of either sign)."""
    assert [s for s, _ in runs["logs"]] == [0, 1, 2]
    for (step, got), (_, want) in zip(runs["logs"], runs["jlogs"]):
        assert set(got) == set(want), (step, set(got) ^ set(want))
        assert ("r1_loss" in got) == (step % 2 == 0)
        for k, w in want.items():
            assert np.isfinite(got[k]), (step, k)
            rel = abs(got[k] - w) / max(abs(w), 1e-12)
            assert rel <= (1e-4 if step == 0 else 1e-3), (step, k, got[k], w)
    assert runs["state"].step == STEPS


def _port_tensors(jparams, buffers):
    sd = rgi_state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, jparams),
                                  "buffers": jax.tree_util.tree_map(np.asarray, buffers)})
    sd.pop("latent_avg")
    return sd


def test_parameters_frozen_set_and_ema_match_jax(runs):
    """After 3 steps: every RGI parameter within 2 learning rates a step of
    JAX's (Adam moves an element by about lr a step whatever its gradient,
    so where a gradient is rounding noise the two can step apart) and all
    of them together, in norm, within 1e-2 of JAX's move; the frozen
    tensors (the style MLP, the tail convs and ToRGBs) bit-for-bit
    unchanged; the EMA within 1e-6 relative of JAX's; the D's parameters (2
    updates, one with R1) within 2 learning rates an update and, in norm,
    within 1e-2 of JAX's move."""
    from e4s2024_torch.convert import discriminator_state_dict_from_jax

    state, jstate, tree = runs["state"], runs["jstate"], runs["tree"]
    lr = TrainConfig().learning_rate
    want = _port_tensors(jstate.params, jstate.buffers)
    want_ema = _port_tensors(jstate.ema_params, jstate.buffers)
    frozen = {k for k in tree["params"] if k.startswith(("G.style.", "G.convs.", "G.to_rgbs."))}
    assert frozen and not frozen & {k for k, p in state.params.items() if p.requires_grad}
    diff = moved = 0.0
    for k, p in state.params.items():
        init, p = tree["params"][k], p.detach()
        # the EMA's two products and sum round once each a step (XLA may
        # fuse them): a few ulps of |ema| (up to ~5) over 3 steps
        torch.testing.assert_close(state.ema_params[k], want_ema[k], rtol=1e-6, atol=1e-6,
                                   msg=k)
        if k in frozen:
            assert not state.params[k].requires_grad and torch.equal(p, init), k
            continue
        assert float((p - want[k]).abs().max()) <= 2 * lr * STEPS, k
        diff += float((p - want[k]).square().sum())
        moved += float((want[k] - init).square().sum())
    assert moved > 0 and diff ** 0.5 <= 1e-2 * moved ** 0.5, (diff ** 0.5, moved ** 0.5)
    jd = discriminator_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.d_params))
    diff = moved = 0.0
    for name, w in jd.items():
        got = state.d_params[name].detach()
        torch.testing.assert_close(got, w, rtol=0, atol=2 * lr * 2, msg=name)
        diff += float((got - w).square().sum())
        moved += float((w - tree["d_params"][name]).square().sum())
    assert moved > 0 and diff ** 0.5 <= 1e-2 * moved ** 0.5, (diff ** 0.5, moved ** 0.5)
