"""`orbax_to_torch.py`, the converter of the JAX package's orbax
directories into the port's torch files, on the CPU: a JAX `save_zoo` of
numpy-seeded RGI and BiSeNet trees becomes `<name>.pt` files equal to the
port's converters of the same trees, which `swap_cli.load_params` reads; a
JAX `Coach.save_checkpoint` after 2 steps becomes a file that the port's
`restore_checkpoint` reads, and the next G step from it matches JAX's
next step from its own restored state (the Adam moments and counts
carry); a Ranger state converts to the port's layout; an unknown zoo name
raises. The trainer is tests/test_torch_coach.py's tiny one (16^2, fast
mode, loss nets off) at B=2.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orbax_to_torch
from e4s2024_tpu.models import Discriminator as JDiscriminator
from e4s2024_tpu.models.bisenet import BiSeNet as JBiSeNet
from e4s2024_tpu.models.rgi import RGINet as JRGINet
from e4s2024_tpu.training import Coach as JCoach
from e4s2024_tpu.training import TrainConfig as JTrainConfig
from e4s2024_tpu.utils.checkpoint import save_zoo as jsave_zoo

from e4s2024_torch import swap_cli
from e4s2024_torch.convert import (bisenet_state_dict_from_jax, discriminator_state_dict_from_jax,
                                   rgi_state_dict_from_jax)
from e4s2024_torch.training.coach import Coach, TrainConfig
from e4s2024_torch.utils.checkpoint import load_pytree
from tests.test_torch_coach import SIZE, TINY, _batches, _nchw, module_threads  # noqa: F401
from tests.test_torch_criterion import two_threads  # noqa: F401  (autouse fixture)
from tests.test_torch_ddp_world2 import _jax_state
from tests.test_torch_models import random_params

CFG = {**TINY, "batch_size": 2, "d_every": 1, "d_reg_every": -1}
LR = JTrainConfig().learning_rate


@pytest.fixture(scope="module")
def weights(module_threads):
    """Numpy-seeded RGI variables and Discriminator params of the tiny
    trainer, as tests/test_torch_coach.py draws them."""
    x, s = jnp.zeros((1, SIZE, SIZE, 3)), jnp.zeros((1, SIZE, SIZE, 12))
    net = JRGINet(num_seg_cls=12, out_size=SIZE, remaining_layer_idx=5, channel_multiplier=1,
                  encoder_input_size=32, encoder_num_units=(1, 1, 1, 1))
    variables = random_params(jax.eval_shape(net.init, jax.random.PRNGKey(0), x, s), 3)
    d_params = random_params(jax.eval_shape(
        JDiscriminator(size=SIZE, channel_multiplier=1).init, jax.random.PRNGKey(1), x), 4)
    return variables, d_params["params"]


def _jax_coach(weights, **kw):
    cfg = JTrainConfig(**{**CFG, **kw})
    coach = JCoach(cfg)
    return coach, _jax_state(coach, *weights, cfg)


def test_zoo_directory_converts_to_the_ports_files(tmp_path, weights):
    variables = weights[0]
    bise = random_params(jax.eval_shape(
        JBiSeNet().init, jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3)))["params"], 12)
    jsave_zoo(str(tmp_path / "orbax"), {"rgi": variables, "bisenet": bise})
    orbax_to_torch.main(["zoo", str(tmp_path / "orbax"), str(tmp_path / "torch")])
    shutil.rmtree(tmp_path / "orbax")  # hundreds of MB: gone as soon as read
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    for name, want in (("rgi", rgi_state_dict_from_jax(to_np(variables))),
                       ("bisenet", bisenet_state_dict_from_jax(to_np(bise)))):
        path = tmp_path / "torch" / f"{name}.pt"
        got = load_pytree(str(path))
        assert set(got) == set(want), name
        for k, w in want.items():
            assert torch.equal(got[k], w), (name, k)
        read = swap_cli.load_params(str(path))
        assert set(read) == set(want) and all(torch.equal(read[k], want[k]) for k in want)
        path.unlink()


def test_unknown_zoo_name_raises(tmp_path):
    jsave_zoo(str(tmp_path / "orbax"), {"mystery": {"w": np.zeros(2, np.float32)}})
    with pytest.raises(ValueError, match="mystery.*known.*bisenet.*rgi"):
        orbax_to_torch.main(["zoo", str(tmp_path / "orbax"), str(tmp_path / "torch")])
    with pytest.raises(ValueError, match="orbax_to_torch.py zoo"):
        swap_cli.load_params(str(tmp_path / "orbax"))


@pytest.fixture(scope="module")
def resumed(tmp_path_factory, weights):
    """JAX's Coach after 2 steps (D then G each), saved, converted and
    restored into the port; then one more G step on each side (JAX's from
    the state it saved, which its orbax round trip restores bit for bit)."""
    tmp = tmp_path_factory.mktemp("coach")
    jcoach, jstate = _jax_coach(weights)
    batches = _batches(3, 3, b=2)
    jstate = jcoach.fit(batches[:2], jstate, 2)
    jcoach.save_checkpoint(str(tmp / "step_2"), jstate)
    orbax_to_torch.main(["coach", str(tmp / "step_2"), str(tmp / "step_2.pt")])
    shutil.rmtree(tmp / "step_2")  # ~1 GB: gone as soon as converted

    g_opt = jax.tree_util.tree_map(np.asarray, jstate.g_opt)
    d_opt = jax.tree_util.tree_map(np.asarray, jstate.d_opt)
    img, onehot = (jnp.asarray(a) for a in batches[2])
    jstate_g, jg = jcoach._g_step(jstate, img, onehot)

    coach = Coach(TrainConfig(**CFG), device="cpu")
    state = coach.restore_checkpoint(str(tmp / "step_2.pt"),
                                     coach.init_state(torch.Generator().manual_seed(0)))
    (tmp / "step_2.pt").unlink()
    assert state.step == 2
    (pimg, ponehot), = _nchw([batches[2]])
    pimg, ponehot = torch.from_numpy(pimg), torch.from_numpy(ponehot)
    before = {k: p.detach().clone() for k, p in state.params.items()}
    restored = {"g_opt": _clone(state.g_opt), "d_opt": _clone(state.d_opt)}
    state, g = coach.g_step(state, pimg, ponehot)
    return dict(g_opt=g_opt, d_opt=d_opt, jstate_g=jstate_g, jg=jg, state=state, g=g,
                before=before, file=restored)


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree


def _assert_step(got, want, init):
    """Every element within 2 learning rates of JAX's (tests/test_torch_coach.py's
    bound: Adam's steps of either sign where a gradient is rounding noise)
    plus 1e-6 for the weights' rounding, and in norm within 1e-2 of JAX's
    move."""
    diff = moved = 0.0
    for k, w in want.items():
        assert float((got[k] - w).abs().max()) <= 2 * LR + 1e-6, k
        diff += float((got[k] - w).square().sum())
        moved += float((w - init[k]).square().sum())
    assert moved > 0 and diff ** 0.5 <= 1e-2 * moved ** 0.5, (diff ** 0.5, moved ** 0.5)


def test_converted_moments_are_jaxs(resumed):
    """The restored Adam states are JAX's: counts, and mu and nu of a
    trainable convolution and a Discriminator weight through the same
    permutation as their parameters; frozen tensors have no state."""
    f = resumed["file"]
    adam, sched = f["g_opt"]
    jadam, jsched = resumed["g_opt"].inner_states[True].inner_state
    assert adam["count"] == int(jadam.count) == 2 and sched["count"] == int(jsched.count) == 2
    name = "G.conv1.conv.weight"
    for key in ("mu", "nu"):
        # the modulated conv's (kh, kw, in, out) -> (1, out, in, kh, kw)
        leaf = np.asarray(getattr(jadam, key)["generator"]["conv1"]["conv"]["weight"])
        want = torch.from_numpy(leaf.transpose(3, 2, 0, 1)[None].copy())
        assert torch.equal(adam[key][name], want) and float(want.abs().max()) > 0
    assert "G.style.1.weight" not in adam["mu"]
    dadam = f["d_opt"][0]
    want = discriminator_state_dict_from_jax(resumed["d_opt"][0].nu)
    assert set(dadam["nu"]) == set(want)
    assert all(torch.equal(dadam["nu"][k], w) for k, w in want.items())


def test_resumed_steps_match_jaxs_resumed_steps(resumed):
    """The G step after the restore: metrics within 1e-4 relative of JAX's
    (tests/test_torch_coach.py's step-0 bound) and the updated weights as
    `_assert_step` holds them (a fresh Adam state's first step would move
    every weight by lr, far from JAX's third step)."""
    got, want = resumed["g"], resumed["jg"]
    assert set(got) == set(want)
    for k, w in want.items():
        assert abs(float(got[k]) - float(w)) <= 1e-4 * max(abs(float(w)), 1e-12), k
    jg = resumed["jstate_g"]
    want = rgi_state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, jg.params),
                                    "buffers": jax.tree_util.tree_map(np.asarray, jg.buffers)})
    want.pop("latent_avg")
    state = resumed["state"]
    _assert_step({k: p.detach() for k, p in state.params.items()}, want, resumed["before"])


def test_ranger_state_converts_to_the_ports_layout(tmp_path):
    """The JAX package's Ranger (lookahead over radam) inside optax's
    trainable mask, after 7 updates (one lookahead sync at 6), saved by
    orbax: its conversion equals the port's masked Ranger state after the
    same 7 updates (counts, gstep, the slow weights, mu and nu within 1e-5
    relative: the two packages' float32 updates round in their own order
    over 7 steps, measured 3.6e-6); the frozen tensor has no state."""
    import optax

    from e4s2024_tpu.training.optim import ranger as jranger
    from e4s2024_tpu.utils.checkpoint import save_pytree as jsave_pytree

    from e4s2024_torch.convert import optimizer_state_from_jax
    from e4s2024_torch.training import optim

    rng = np.random.default_rng(5)
    params = {"dense": {"kernel": rng.standard_normal((3, 2)).astype(np.float32),
                        "bias": rng.standard_normal(2).astype(np.float32)},
              "frozen": {"kernel": rng.standard_normal((2, 2)).astype(np.float32)}}
    grads = [jax.tree_util.tree_map(lambda p: rng.standard_normal(p.shape).astype(np.float32),
                                    params) for _ in range(7)]
    mask = {"dense": {"kernel": True, "bias": True}, "frozen": {"kernel": False}}
    tx = optax.multi_transform({True: jranger(1e-2), False: optax.set_to_zero()}, mask)
    state, p = tx.init(params), jax.tree_util.tree_map(jnp.asarray, params)
    for g in grads:
        updates, state = tx.update(g, state, p)
        p = optax.apply_updates(p, updates)
    jsave_pytree(str(tmp_path / "opt"), state)

    def to_sd(tree):  # the layout a torch Linear keeps
        return {"dense.weight": torch.from_numpy(np.ascontiguousarray(tree["dense"]["kernel"].T)),
                "dense.bias": torch.from_numpy(np.asarray(tree["dense"]["bias"])),
                "frozen.weight": torch.from_numpy(np.ascontiguousarray(
                    tree["frozen"]["kernel"].T))}

    got = optimizer_state_from_jax(orbax_to_torch._restore(str(tmp_path / "opt")), params, to_sd)
    names = {"dense.weight": True, "dense.bias": True, "frozen.weight": False}
    ptx = optim.masked(optim.ranger(1e-2), names)
    pp = to_sd(params)
    want = ptx.init(pp)
    for g in grads:
        updates, want = ptx.update(to_sd(g), want, pp)
        optim.apply_updates(pp, updates)
    assert set(got) == {"inner", "gstep", "slow"} and got["gstep"] == want["gstep"] == 7
    assert [s["count"] for s in got["inner"]] == [s["count"] for s in want["inner"]] == [7, 7]
    for key, a, b in (("mu", got["inner"][0]["mu"], want["inner"][0]["mu"]),
                      ("nu", got["inner"][0]["nu"], want["inner"][0]["nu"]),
                      ("slow", got["slow"], want["slow"])):
        assert set(a) == set(b) == {"dense.weight", "dense.bias"}, key
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=1e-5, atol=1e-7, msg=(key, k))
