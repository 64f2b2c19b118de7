"""The trainer's optimizers against optax, on the CPU: adam, radam,
lookahead and ranger over 7 steps (one lookahead sync at step 6) inside
the masked transform the Coach builds (optax's `multi_transform` with
`set_to_zero`), the piecewise-constant schedule around its boundary, and
the masked update's bookkeeping.
"""

import numpy as np
import optax
import pytest
import torch

from e4s2024_tpu.training.optim import lookahead as j_lookahead
from e4s2024_tpu.training.optim import ranger as j_ranger

from e4s2024_torch.training import optim
from tests.test_torch_criterion import two_threads  # noqa: F401  (autouse fixture)

SHAPES = {"enc.w": (3, 4), "G.style.1.weight": (5,), "G.convs.0.bias": (2, 2), "MLPs.b": (6,)}
MASK = {"enc.w": True, "G.style.1.weight": False, "G.convs.0.bias": True, "MLPs.b": True}
STEPS = 7
BOUNDARY = 4  # the schedule's x0.1 falls inside the 7 steps


def _problem(seed=0):
    """Parameters and 7 gradients per tensor, of magnitudes from 1e-3 to
    10 (Adam's and RAdam's steps scale differently with them)."""
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.standard_normal(s) * 10 ** rng.uniform(-3, 1)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(STEPS)]
    return params, grads


def _schedules(lr=1e-2):
    return (optax.piecewise_constant_schedule(lr, {BOUNDARY: 0.1}),
            optim.piecewise_constant_schedule(lr, {BOUNDARY: 0.1}))


CASES = {
    "adam": (lambda s: optax.adam(s), lambda s: optim.adam(s)),
    "radam": (lambda s: optax.radam(s), lambda s: optim.radam(s)),
    "lookahead": (lambda s: j_lookahead(optax.adam(s)), lambda s: optim.lookahead(optim.adam(s))),
    "ranger": (lambda s: j_ranger(s), lambda s: optim.ranger(s)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_masked_optimizer_matches_optax(name):
    """Every step's parameters within 1e-6 (float32 rounding of the bias
    corrections' powers, taken by XLA and by torch) of optax's; the frozen
    tensor never moves."""
    params, grads = _problem()
    j_sched, t_sched = _schedules()
    make_j, make_t = CASES[name]
    jtx = optax.multi_transform({True: make_j(j_sched), False: optax.set_to_zero()}, MASK)
    ttx = optim.masked(make_t(t_sched), MASK)
    jp, tp = dict(params), {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jtx.init(jp), ttx.init(tp)
    for g in grads:
        u, js = jtx.update(g, js, jp)
        jp = optax.apply_updates(jp, u)
        tu, ts = ttx.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        optim.apply_updates(tp, tu)
        for k in SHAPES:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-6,
                                       err_msg=k)
    np.testing.assert_array_equal(tp["G.style.1.weight"].numpy(), params["G.style.1.weight"])
    assert all(np.abs(tp[k].numpy() - params[k]).max() > 0 for k in SHAPES if MASK[k])


def test_schedule_around_its_boundary():
    """The rate at lr_decay_step - 1, lr_decay_step and + 1 updates, against
    optax's (float32 there)."""
    step = 100_000
    j_sched = optax.piecewise_constant_schedule(1e-4, {step: 0.1})
    t_sched = optim.piecewise_constant_schedule(1e-4, {step: 0.1})
    for count in (0, step - 1, step, step + 1):
        np.testing.assert_allclose(t_sched(count), float(j_sched(count)), rtol=1e-6)
    assert t_sched(step - 1) == 1e-4 and t_sched(step) == pytest.approx(1e-5)


def test_each_optimizer_counts_its_own_updates():
    """The schedule reads the transform's own update count: an optimizer
    that updated 4 times takes the decayed rate on its 5th update whatever
    the trainer's step (the D updates only every d_every steps)."""
    _, t_sched = _schedules()
    tx = optim.adam(t_sched)
    p = {"w": torch.ones(3)}
    state = tx.init(p)
    rates = []
    for _ in range(6):
        u, state = tx.update({"w": torch.ones(3)}, state, p)
        rates.append(float(-u["w"][0]))  # Adam's step is lr for a constant gradient
    # within the float32 bias corrections' cancellation (1 - 0.999^t)
    np.testing.assert_allclose(rates, [1e-2] * BOUNDARY + [1e-3] * 2, rtol=1e-4)


def test_masked_update_bookkeeping():
    """Frozen tensors get no state and no update; a trainable tensor without
    a gradient gets a zero one (JAX's `grad` gives zeros): no move, moments
    still zero."""
    p = {k: torch.zeros(s) for k, s in SHAPES.items()}
    tx = optim.masked(optim.adam(1e-2), MASK)
    state = tx.init(p)
    adam_state = state[0]
    assert set(adam_state["mu"]) == {k for k, v in MASK.items() if v}
    grads = {"enc.w": torch.ones(3, 4), "G.convs.0.bias": None}
    updates, state = tx.update(grads, state, p)
    assert set(updates) == {k for k, v in MASK.items() if v}
    assert float(updates["G.convs.0.bias"].abs().max()) == 0.0
    assert float(updates["MLPs.b"].abs().max()) == 0.0
    assert float(state[0]["nu"]["MLPs.b"].abs().max()) == 0.0
    assert float(updates["enc.w"].max()) < 0
