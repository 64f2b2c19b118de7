"""The port's Coach on its own, on the CPU, at tests/test_torch_coach.py's
tiny size: the EMA's formula, remat against no remat, `fit`'s periodic
and best-val saves with `validate`, the checkpoint round trip, and a start from reference-style files (the generator's and
the Discriminator's fixed buffers checked and dropped). No JAX runs here:
the starting weights are the port's seeded initialisation.
"""

import pytest
import torch

from e4s2024_torch.training.coach import EMA_ACCUM, Coach, TrainConfig
from tests.test_torch_coach import TINY, _batches, _nchw, module_threads  # noqa: F401
from tests.test_torch_criterion import two_threads  # noqa: F401  (autouse fixture)


def _port(**kw):
    coach = Coach(TrainConfig(**{**TINY, **kw}), device="cpu")
    return coach, coach.init_state(torch.Generator().manual_seed(1))


@pytest.fixture(scope="module")
def trained(module_threads, tmp_path_factory):
    """One step of `fit` (D without R1, then G) with a checkpoint every step
    and validation every step: (coach, state, checkpoint dir, logs,
    validation batches)."""
    ckpt = tmp_path_factory.mktemp("ckpt")
    coach, state = _port(d_every=1, d_reg_every=-1)
    val, logs = _nchw(_batches(8, 1)), []
    state = coach.fit(_nchw(_batches(0, 1)), state, 1, callback=lambda s, m: logs.append(m),
                      ckpt_dir=str(ckpt), save_every=1, val_batches=val, val_every=1,
                      val_steps=1)
    return coach, state, ckpt, logs, val


@pytest.fixture(scope="module")
def g_steps(module_threads):
    """One G step (the adversarial term off: train_D False) from the same
    weights with remat off and on: (EMA before, metrics, parameters, EMA)."""
    (img, onehot), = _nchw(_batches(6, 1))
    out = {}
    for remat in (False, True):
        coach, state = _port(remat=remat, train_D=False)
        ema0 = {k: v.clone() for k, v in state.ema_params.items()}
        state, metrics = coach.g_step(state, *coach._as_device(img, onehot))
        out[remat] = (ema0, {k: float(v) for k, v in metrics.items()},
                      {k: p.detach().clone() for k, p in state.params.items()},
                      state.ema_params)
    return out


def test_ema_follows_its_formula(g_steps):
    """ema' = ema * ACCUM + p' * (1 - ACCUM) for every parameter, frozen
    ones included (within float32 rounding)."""
    ema0, _, params, ema = g_steps[False]
    for k, p in params.items():
        want = ema0[k] * EMA_ACCUM + p * (1 - EMA_ACCUM)
        torch.testing.assert_close(ema[k], want, rtol=1e-6, atol=1e-7, msg=k)


def test_remat_matches_no_remat(g_steps):
    """remat (the G forward recomputed in the backward) changes nothing:
    the same metrics and updated parameters within float32 rounding."""
    _, m0, p0, _ = g_steps[False]
    _, m1, p1, _ = g_steps[True]
    assert m0 == pytest.approx(m1, rel=1e-6)
    for k in p0:
        torch.testing.assert_close(p1[k], p0[k], rtol=1e-6, atol=1e-7, msg=k)


def test_checkpoint_round_trip_validate_and_saves(trained):
    """`fit` with save_every=1 and validation every step wrote
    step_00000001.pt and best.pt, and its val_loss is `validate`'s (the
    criterion's mean loss). The checkpoint restored into a fresh state gives
    the same weights, EMA, optimizer states and step, and the same
    validation loss."""
    coach, state, ckpt, logs, val = trained
    assert (ckpt / "step_00000001.pt").exists() and (ckpt / "best.pt").exists()
    want = coach.validate(val, state, 1)
    assert logs[0]["val_loss"] == pytest.approx(want, rel=1e-6)
    fresh_coach, fresh = _port(d_every=1, d_reg_every=-1)
    fresh = fresh_coach.restore_checkpoint(str(ckpt / "step_00000001.pt"), fresh)
    assert fresh.step == state.step == 1
    for a, b in ((fresh.params, state.params), (fresh.ema_params, state.ema_params),
                 (fresh.d_params, state.d_params)):
        for k in b:
            assert torch.equal(a[k].detach(), b[k].detach()), k
    assert fresh.g_opt[0]["count"] == 1 and fresh.d_opt[1]["count"] == 1
    for k, v in state.g_opt[0]["nu"].items():
        assert torch.equal(fresh.g_opt[0]["nu"][k], v), k
    for k, v in state.d_opt[0]["mu"].items():
        assert torch.equal(fresh.d_opt[0]["mu"][k], v), k
    assert fresh_coach.validate(val, fresh, 1) == want


def test_load_pretrained_from_reference_style_files(trained):
    """A reference E4S state dict with the generator's fixed buffers and a
    reference Discriminator with its Blur buffers start the port's run; the
    EMA restarts from the loaded weights."""
    from e4s2024_torch.ops.upfirdn import make_kernel
    from tests.test_torch_discriminator import reference_discriminator

    state = trained[1]
    params = {k: v.detach() for k, v in state.params.items()}
    rgi = {**params, "latent_avg": state.net.latent_avg,
           "G.convs.0.conv.blur.kernel": make_kernel([1, 3, 3, 1]) * 4,
           "G.noises.noise_0": torch.zeros(1, 1, 4, 4)}
    d_sd = reference_discriminator(2)
    coach = Coach(TrainConfig(**TINY), device="cpu")
    state = coach.load_pretrained(coach.init_state(), {f"module.{k}": v for k, v in rgi.items()},
                                  d_sd)
    for k, v in params.items():
        assert torch.equal(state.params[k].detach(), v) and torch.equal(state.ema_params[k], v)
    assert torch.equal(state.d_params["convs.1.conv2.1.weight"].detach(),
                       d_sd["convs.1.conv2.1.weight"])
