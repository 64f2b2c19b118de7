"""The port's trainer at world size 2 (two spawned CPU ranks over gloo)
against the JAX package's `Coach(mesh=make_mesh(2))` on the virtual CPU
devices, at tests/test_torch_coach.py's tiny trainer size (16^2, channel
multiplier 1, fast mode, loss nets off) with a global batch of 2, one row
a rank: the Discriminator's logits and R1 over the global batch (its
minibatch stddev gathers the ranks' features), one G step and one D step
with R1 from the same weights (metrics and updated parameters), the two
ranks' weights equal after each step, and the refusal of a batch that the
world does not divide.

At B=2 the stddev group is 2: a Discriminator that took its stddev over
each rank's one row (group 1) gives every stddev feature sqrt(1e-8), and
its logits, loss and R1 leave JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from e4s2024_tpu.losses import r1_penalty as j_r1_penalty
from e4s2024_tpu.models import Discriminator as JDiscriminator
from e4s2024_tpu.models.rgi import RGINet as JRGINet
from e4s2024_tpu.parallel import make_mesh
from e4s2024_tpu.training import Coach as JCoach
from e4s2024_tpu.training import TrainConfig as JTrainConfig
from e4s2024_tpu.training.coach import CoachState as JCoachState
from e4s2024_tpu.training.coach import _g_trainable_mask as j_mask

from e4s2024_torch.convert import (coach_state_from_jax, discriminator_state_dict_from_jax,
                                   rgi_state_dict_from_jax)
from tests.test_torch_coach import TINY, _batches, _nchw
from tests.test_torch_coach import module_threads  # noqa: F401
from tests.test_torch_models import random_params
from tests.torch_ranks import start_ranks, trainer_world

SIZE = TINY["out_size"]
CFG = {**TINY, "batch_size": 2}
LR = JTrainConfig().learning_rate


def _jax_state(coach, variables, d_params, cfg):
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    coach._g_tx = optax.multi_transform(
        {True: coach._g_tx_inner, False: optax.set_to_zero()}, j_mask(params, cfg))
    return JCoachState(step=jnp.zeros((), jnp.int32), params=params,
                       buffers=jax.tree_util.tree_map(jnp.asarray, variables["buffers"]),
                       ema_params=jax.tree_util.tree_map(jnp.copy, params),
                       d_params=jax.tree_util.tree_map(jnp.asarray, d_params),
                       g_opt=coach._g_tx.init(params),
                       d_opt=coach._d_tx.init(d_params))


@pytest.fixture(scope="module")
def world2(tmp_path_factory, module_threads):
    cfg = JTrainConfig(**CFG)
    x, s = jnp.zeros((1, SIZE, SIZE, 3)), jnp.zeros((1, SIZE, SIZE, 12))
    net = JRGINet(num_seg_cls=12, out_size=SIZE, remaining_layer_idx=5, channel_multiplier=1,
                  encoder_input_size=32, encoder_num_units=(1, 1, 1, 1))
    variables = random_params(jax.eval_shape(net.init, jax.random.PRNGKey(0), x, s), 3)
    jdisc = JDiscriminator(size=SIZE, channel_multiplier=1)
    d_params = random_params(jax.eval_shape(jdisc.init, jax.random.PRNGKey(1), x), 4)["params"]
    (img, onehot), = _batches(7, 1, b=2)

    # the port's ranks run while JAX computes; the EMA starts equal to the
    # weights, so the tree holds one copy of them
    tree = coach_state_from_jax(variables["params"], variables["buffers"], variables["params"],
                                d_params)
    tree["ema_params"] = tree["params"]
    (pimg, ponehot), = _nchw([(img, onehot)])
    inputs = {"cfg": CFG, "tree": tree,
              "batch": (torch.from_numpy(pimg), torch.from_numpy(ponehot)),
              "size": SIZE, "sd": tree["d_params"], "x": torch.from_numpy(pimg)}
    ranks = start_ranks(trainer_world, inputs, tmp_path_factory.mktemp("world2"))

    # JAX: the global batch sharded over a 2-device 'dp' mesh
    coach = JCoach(cfg, mesh=make_mesh(2))
    jg_state, jg_metrics = coach._g_step(_jax_state(coach, variables, d_params, cfg),
                                         jnp.asarray(img), jnp.asarray(onehot))
    jd_state, jd_metrics = coach._d_step(_jax_state(coach, variables, d_params, cfg),
                                         jnp.asarray(img), jnp.asarray(onehot), True)
    d_apply = lambda xx: jdisc.apply({"params": d_params}, xx)  # noqa: E731
    j_logits = np.asarray(d_apply(jnp.asarray(img)))
    j_r1 = float(j_r1_penalty(d_apply, jnp.asarray(img)))
    return dict(tree=tree, variables=variables, d_params=d_params, ranks=ranks.join(),
                jg=(jg_state, {k: float(v) for k, v in jg_metrics.items()}),
                jd=(jd_state, {k: float(v) for k, v in jd_metrics.items()}),
                j_logits=j_logits, j_r1=j_r1)


def _assert_metrics(got, want, rel=1e-4):
    """Step-0 metrics within 1e-4 relative of JAX's (float32 summation
    order; R1 a second derivative), as tests/test_torch_coach.py holds them."""
    assert set(got) == set(want), set(got) ^ set(want)
    for k, w in want.items():
        assert abs(got[k] - w) <= rel * max(abs(w), 1e-12), (k, got[k], w)


def _assert_params(got, want, init, steps=1):
    """Every element within 2 learning rates a step of JAX's (Adam moves an
    element by about lr whatever its gradient, so a rounding-noise gradient
    can step either way), plus 1e-6 for the rounding of the two weights,
    and, in norm over all of them, within 1e-2 of JAX's move
    (tests/test_torch_coach.py's bounds)."""
    diff = moved = 0.0
    for k, w in want.items():
        g = got[k]
        assert float((g - w).abs().max()) <= 2 * LR * steps + 1e-6, k
        diff += float((g - w).square().sum())
        moved += float((w - init[k]).square().sum())
    assert moved > 0 and diff ** 0.5 <= 1e-2 * moved ** 0.5, (diff ** 0.5, moved ** 0.5)


def test_discriminator_over_the_group_matches_jax_global_batch(world2):
    """The logits of the global batch within 1e-5 of their largest
    magnitude (tests/test_torch_discriminator.py's bound) and R1 within
    1e-5 relative, on both ranks."""
    want = world2["j_logits"]
    for rank in world2["ranks"]:
        got = rank["disc"]["logits"].numpy()
        assert got.shape == want.shape == (2, 1)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
        np.testing.assert_allclose(rank["disc"]["r1"], world2["j_r1"], rtol=1e-5)


def test_g_step_matches_jax_sharded_step(world2):
    jstate, jmetrics = world2["jg"]
    init = {k: torch.as_tensor(np.asarray(v)) for k, v in world2["tree"]["params"].items()}
    want = rgi_state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, jstate.params),
                                    "buffers": world2["variables"]["buffers"]})
    want.pop("latent_avg")
    for rank in world2["ranks"]:
        metrics, params = rank["coach"]["g"]
        _assert_metrics(metrics, jmetrics)
        _assert_params(params, want, init)


def test_d_r1_step_matches_jax_sharded_step(world2):
    jstate, jmetrics = world2["jd"]
    assert "r1_loss" in jmetrics
    init = world2["tree"]["d_params"]
    want = discriminator_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.d_params))
    for rank in world2["ranks"]:
        metrics, params = rank["coach"]["d_r1"]
        _assert_metrics(metrics, jmetrics)
        _assert_params(params, want, init)


def test_encoder_gradient_splits_over_rows():
    """The encoder's gradient of a batch of two is the sum of its rows' (a
    rank with one row trains its share): `instance_norm`'s backward is its
    formula's (torch's `F.instance_norm` backward is wrong at a batch of one
    on this CPU build). Within 1e-5 of the gradient's largest element."""
    from e4s2024_torch.models.encoders import FSEncoderPSP

    torch.manual_seed(0)
    enc = FSEncoderPSP((1, 1, 1, 1))
    x = torch.randn(2, 3, 32, 32)
    seg = torch.nn.functional.one_hot(torch.randint(0, 12, (2, 16, 16)), 12)
    seg = seg.permute(0, 3, 1, 2).float()
    w = torch.randn(2, 12, 256 + 512 + 512)

    def grads(rows):
        out = {}
        for r in rows:
            enc.zero_grad()
            (enc(x[r], seg[r])[0] * w[r]).sum().backward()
            for k, p in enc.named_parameters():
                out[k] = out.get(k, 0) + p.grad
        return out

    both, split = grads([slice(0, 2)]), grads([slice(0, 1), slice(1, 2)])
    for k, g in both.items():
        if ".fc" in k:  # the SE MLPs read a zero mean: their gradients are rounding noise
            continue
        torch.testing.assert_close(split[k], g, rtol=0, atol=1e-5 * float(g.abs().max()), msg=k)


def test_ranks_hold_equal_weights_and_refuse_an_indivisible_batch(world2):
    r0, r1 = world2["ranks"]
    for kind in ("g", "d_r1"):
        for k, p in r0["coach"][kind][1].items():
            assert torch.equal(p, r1["coach"][kind][1][k]), (kind, k)
    for rank in (r0, r1):
        assert rank["refused"] is not None and "3" in rank["refused"] and "2" in rank["refused"]
