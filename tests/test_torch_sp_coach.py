"""The port's trainer over a `(dp, sp)` grid of spawned CPU ranks over gloo
(`Coach(process_group=make_process_grid(dp, sp))`), at
tests/test_torch_ddp_world2.py's tiny trainer size (16^2, channel
multiplier 1, fast mode, loss nets off, a global batch of 2):

- grid (1, 2), two ranks each holding half of every image's rows: one G
  step, one G step with remat and one D step with R1 from the same
  weights, against JAX's step (metrics and updated parameters), every
  rank's weights equal after each step;
- grid (2, 2), four ranks: one D step with R1 (the minibatch stddev over
  the batch gathered on `dp` and the rows gathered on `sp`), and the
  split's ops over all four ranks as one split of 4, where a 5x5
  convolution on 4 rows reads its neighbour's neighbour;
- the refusals of an indivisible height and of a scale the nets reach
  that sp does not divide.

The two grids' ranks run at once, beside JAX's steps in this process.

The JAX side is `Coach` without a mesh, which computes the same function
as its `Coach(mesh=make_mesh_2d(1, 2))`: on an 8-core CPU that program's
compile took 21.1 s against 11.5 s for the steps without a mesh, more than
this file's share of the suite's time, and its G-step metrics were equal
to the meshless step's and its D+R1 metrics within one float32 ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e4s2024_tpu.models import Discriminator as JDiscriminator
from e4s2024_tpu.models.rgi import RGINet as JRGINet
from e4s2024_tpu.training import Coach as JCoach
from e4s2024_tpu.training import TrainConfig as JTrainConfig

from e4s2024_torch.convert import (coach_state_from_jax, discriminator_state_dict_from_jax,
                                   rgi_state_dict_from_jax)
from tests.test_torch_coach import _batches, _nchw
from tests.test_torch_coach import module_threads  # noqa: F401
from tests.test_torch_ddp_world2 import CFG, SIZE, _assert_metrics, _assert_params, _jax_state
from tests.test_torch_models import random_params
from tests.test_torch_sp_ops import FWD_REL, GRAD_REL, PARAMS_REL
from tests.torch_ranks import grid_world, start_ranks

WORLD_SPLIT = ("conv5x5_far_halo", "upfirdn_up", "blur_conv_stride2", "generator_fast",
               "discriminator_r1")


def _jax_start():
    """The JAX trainer's start (numpy-seeded weights, as
    tests/test_torch_ddp_world2.py builds them), the port's tree of the
    same weights, and the global batch: (cfg, variables, d_params, (img,
    onehot) NHWC, the ranks' inputs)."""
    cfg = JTrainConfig(**CFG)
    x, s = jnp.zeros((1, SIZE, SIZE, 3)), jnp.zeros((1, SIZE, SIZE, 12))
    net = JRGINet(num_seg_cls=12, out_size=SIZE, remaining_layer_idx=5, channel_multiplier=1,
                  encoder_input_size=32, encoder_num_units=(1, 1, 1, 1))
    variables = random_params(jax.eval_shape(net.init, jax.random.PRNGKey(0), x, s), 3)
    jdisc = JDiscriminator(size=SIZE, channel_multiplier=1)
    d_params = random_params(jax.eval_shape(jdisc.init, jax.random.PRNGKey(1), x), 4)["params"]
    (img, onehot), = _batches(7, 1, b=2)

    tree = coach_state_from_jax(variables["params"], variables["buffers"], variables["params"],
                                d_params)
    tree["ema_params"] = tree["params"]
    (pimg, ponehot), = _nchw([(img, onehot)])
    inputs = {"cfg": CFG, "tree": tree,
              "batch": (torch.from_numpy(pimg), torch.from_numpy(ponehot))}
    return cfg, variables, d_params, (img, onehot), inputs


def _jax_d_r1(cfg, variables, d_params, img, onehot):
    """JAX's D step with R1: (metrics, the updated Discriminator as the
    port's state dict)."""
    coach = JCoach(cfg)
    state, metrics = coach._d_step(_jax_state(coach, variables, d_params, cfg),
                                   jnp.asarray(img), jnp.asarray(onehot), True)
    return ({k: float(v) for k, v in metrics.items()},
            discriminator_state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                     state.d_params)))


@pytest.fixture(scope="module")
def grid(tmp_path_factory, module_threads):
    cfg, variables, d_params, (img, onehot), inputs = _jax_start()
    tmp = tmp_path_factory.mktemp("grid")
    runs = [start_ranks(grid_world, {**inputs, "grid": (1, 2),
                                     "kinds": ("g", "g_remat", "d_r1")}, tmp, world=2),
            start_ranks(grid_world, {**inputs, "grid": (2, 2), "kinds": ("d_r1",),
                                     "world_split": WORLD_SPLIT}, tmp, world=4)]
    coach = JCoach(cfg)
    jg_state, jg_metrics = coach._g_step(_jax_state(coach, variables, d_params, cfg),
                                         jnp.asarray(img), jnp.asarray(onehot))
    want_g = rgi_state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray,
                                                                       jg_state.params),
                                      "buffers": variables["buffers"]})
    want_g.pop("latent_avg")
    jd = _jax_d_r1(cfg, variables, d_params, img, onehot)
    return dict(tree=inputs["tree"], ranks=[r.join() for r in runs],
                jg=({k: float(v) for k, v in jg_metrics.items()}, want_g), jd=jd)


def _check(grid, run, kind, want):
    """Every rank's metrics and world rank 0's parameters against JAX's
    (tests/test_torch_ddp_world2.py's bounds), every rank's weights equal
    to rank 0's."""
    metrics, params = want
    init = (grid["tree"]["d_params"] if kind == "d_r1" else
            {k: torch.as_tensor(np.asarray(v)) for k, v in grid["tree"]["params"].items()})
    for rank, res in enumerate(grid["ranks"][run]):
        got_metrics, got_params, same = res[kind]
        _assert_metrics(got_metrics, metrics)
        assert same, (rank, kind)
        if rank == 0:
            _assert_params(got_params, params, init)


def test_g_step_on_a_1x2_grid_matches_jax(grid):
    _check(grid, 0, "g", grid["jg"])


def test_g_step_with_remat_on_a_1x2_grid_matches_jax(grid):
    """remat re-runs the forward's collectives inside the backward, on
    every rank in the same order."""
    _check(grid, 0, "g_remat", grid["jg"])


def test_d_r1_step_on_a_1x2_grid_matches_jax(grid):
    assert "r1_loss" in grid["jd"][0]
    _check(grid, 0, "d_r1", grid["jd"])


def test_d_r1_step_on_a_2x2_grid_matches_jax(grid):
    """Four ranks: the stddev spans the batch gathered over dp and the rows
    gathered over sp."""
    assert len(grid["ranks"][1]) == 4
    _check(grid, 1, "d_r1", grid["jd"])


@pytest.mark.parametrize("name", WORLD_SPLIT)
def test_ops_split_over_four_ranks(grid, name):
    for rank, res in enumerate(grid["ranks"][1]):
        for part, rel in (("fwd", FWD_REL), ("grad", GRAD_REL), ("params", PARAMS_REL)):
            err, scale = res["world_split"][name][part]
            assert err <= rel * max(scale, 1e-12), (rank, name, part, err, scale)


def test_indivisible_heights_are_refused(grid):
    for res in grid["ranks"][0]:
        rows, scale = res["refused"]
        assert rows is not None and "15" in rows and "sp" in rows
        assert scale is not None and "a height of 1 rows" in scale
