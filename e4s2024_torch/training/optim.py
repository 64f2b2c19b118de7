"""Latent refinement: W-space optimisation of the per-region style vectors
(reference optimization.py:321-351 `Optimizer.optim_W_online`; 150-200
steps of Adam at lr 1e-2, options/optim_options.py:37-39).

Counterpart of `e4s2024_tpu/training/optim.py::optimize_style_vectors`,
which scans optax updates in one XLA program; here a plain loop of
autograd steps (on the card the generator's K1-K3 run with their backward
kernels).

The optimizers, those of the refinement and the trainer's
(`e4s2024_tpu/training/coach.py:155-167, 208-210`,
`e4s2024_tpu/training/optim.py:28-82`), are `Transform`s over dicts of
named tensors: optax's gradient transformations written for torch, with
optax's update rules, not torch.optim's. Adam's eps is added to
sqrt(v / (1 - b2^t)) with no eps inside the root (torch.optim.Adam adds it
to sqrt(v) / sqrt(1 - b2^t), the same value rounded in another order) and
both bias corrections are taken in float32, as optax takes them; RAdam
keeps optax's rectification (torch.optim.RAdam's rule differs); SGD with
momentum accumulates t = g + 0.9 t (torch's dampening 0 rule); Adamax
divides the bias-corrected first moment by max(b2 u, |g| + eps) (optax's
infinity moment). `lookahead` keeps the slow weights in the optimizer
state, `ranger` is RAdam inside LookAhead, `piecewise_constant_schedule`
is optax's, and `masked` is optax's `multi_transform` with `set_to_zero`
for the frozen tensors: they get no update and no state. Each transform
counts its own updates.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping

import torch

from e4s2024_torch.models.rgi import RGINet


def optimize_style_vectors(net: RGINet, criterion: Callable, img: torch.Tensor,
                           onehot: torch.Tensor, *, steps: int = 150, lr: float = 1e-2,
                           optimizer: str = "adam",
                           init_style_vectors: torch.Tensor | None = None,
                           regional_mode: str = "exact"):
    """Refine per-region style vectors so that the frozen net reconstructs
    `img`.

    net: the RGI net; criterion: (recon, img) -> (loss, metrics), e.g. a
    `losses.recon.ReconCriterion`; img: (1, 3, S, S) in [-1, 1]; onehot:
    (1, K, Hm, Wm); init_style_vectors: a warm start, by default the
    encoder's (the reference's initialisation, optimization.py:335-338).

    Returns (style vectors (1, K, 1280), the per-step losses (steps,), each
    before its step's update)."""
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"optimizer must be one of {sorted(OPTIMIZERS)}")
    tx = OPTIMIZERS[optimizer](lr)
    with torch.inference_mode(False), torch.enable_grad():
        img, onehot = img.clone(), onehot.clone()
        if init_style_vectors is None:
            with torch.no_grad():
                init_style_vectors, _ = net.get_style_vectors(img, onehot)
        sv = init_style_vectors.detach().clone()
        state = tx.init({"sv": sv})
        losses = []
        for _ in range(steps):
            leaf = sv.requires_grad_(True)
            recon, _, _ = net.gen_img(None, net.cal_style_codes(leaf), onehot,
                                      regional_mode=regional_mode)
            loss, _ = criterion(recon, img)
            (grad,) = torch.autograd.grad(loss, leaf)
            losses.append(loss.detach())
            updates, state = tx.update({"sv": grad}, state, {"sv": leaf.detach()})
            sv = leaf.detach() + updates["sv"]
    return sv, torch.stack(losses)


# ------------------------------------------------------------ the trainer's


@dataclass(frozen=True)
class Transform:
    """An optax-style gradient transformation over {name: tensor} dicts:
    `init(params) -> state`; `update(grads, state, params) -> (updates,
    state)`, the updates to add to the parameters. States are dicts of
    tensors and ints, saved as they are by `torch.save`."""

    init: Callable
    update: Callable


def piecewise_constant_schedule(init_value: float,
                                boundaries_and_scales: Mapping[int, float]) -> Callable:
    """optax's `piecewise_constant_schedule`: the value at update count c
    (0 for the first update) is init_value times every scale whose boundary
    is at or below c."""
    def schedule(count: int) -> float:
        value = init_value
        for boundary, scale in sorted(boundaries_and_scales.items()):
            if count >= boundary:
                value *= scale
        return value
    return schedule


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def _moments(grads: list, mu: list, nu: list, b1: float, b2: float) -> None:
    """optax's `update_moment` and `update_moment_per_elem_norm` in place:
    mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu."""
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
    torch._foreach_mul_(nu, b2)
    torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2))


def _scale_by_adam(b1=0.9, b2=0.999, eps=1e-8, rectify=False, threshold=5.0):
    """optax's `scale_by_adam` (or, with `rectify`, `scale_by_radam`): the
    bias-corrected moments, their power taken in float32 as optax takes it;
    RAdam's rectification in float32 where its ro reaches `threshold`, the
    bias-corrected first moment alone before."""
    ro_inf = 2.0 / (1.0 - b2) - 1.0

    def init(params):
        return {"count": 0, "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(grads, state, params=None):
        names = list(grads)
        g = [grads[k] for k in names]
        mu, nu = [state["mu"][k] for k in names], [state["nu"][k] for k in names]
        _moments(g, mu, nu, b1, b2)
        t = state["count"] + 1
        ref = g[0]
        mu_hat = torch._foreach_div(mu, 1 - _f32(b1, ref) ** t)
        nu_hat = torch._foreach_div(nu, 1 - _f32(b2, ref) ** t)
        denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), eps)
        if not rectify:
            out = torch._foreach_div(mu_hat, denom)
        else:
            b2t = _f32(b2, ref) ** t
            ro = ro_inf - 2 * t * b2t / (1 - b2t)
            if float(ro) >= threshold:
                r = torch.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                               / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
                out = torch._foreach_div(torch._foreach_mul(mu_hat, r), denom)
            else:
                out = mu_hat
        return dict(zip(names, out)), {"count": t, "mu": state["mu"], "nu": state["nu"]}

    return Transform(init, update)


def _scale_by_learning_rate(learning_rate):
    """optax's `scale_by_learning_rate`: updates times -lr, the rate from a
    schedule of this transform's own update count (before the update)."""
    schedule = learning_rate if callable(learning_rate) else (lambda count: learning_rate)

    def init(params):
        return {"count": 0}

    def update(grads, state, params=None):
        lr = schedule(state["count"])
        names = list(grads)
        out = torch._foreach_mul([grads[k] for k in names], -lr)
        return dict(zip(names, out)), {"count": state["count"] + 1}

    return Transform(init, update)


def chain(*transforms: Transform) -> Transform:
    def init(params):
        return [tx.init(params) for tx in transforms]

    def update(grads, state, params=None):
        new = []
        for tx, s in zip(transforms, state):
            grads, s = tx.update(grads, s, params)
            new.append(s)
        return grads, new

    return Transform(init, update)


def adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8) -> Transform:
    """optax.adam: `learning_rate` a float or a schedule of the update count."""
    return chain(_scale_by_adam(b1, b2, eps), _scale_by_learning_rate(learning_rate))


def radam(learning_rate, b1=0.9, b2=0.999, eps=1e-8, threshold=5.0) -> Transform:
    """optax.radam (not torch.optim.RAdam, whose rule differs)."""
    return chain(_scale_by_adam(b1, b2, eps, rectify=True, threshold=threshold),
                 _scale_by_learning_rate(learning_rate))


def _trace(momentum: float) -> Transform:
    """optax's `trace`: t = g + momentum t."""
    def init(params):
        return {"trace": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(grads, state, params=None):
        names = list(grads)
        trace = [state["trace"][k] for k in names]
        torch._foreach_mul_(trace, momentum)
        torch._foreach_add_(trace, [grads[k] for k in names])
        return {k: state["trace"][k] for k in names}, state

    return Transform(init, update)


def sgd(learning_rate, momentum: float | None = None) -> Transform:
    """optax.sgd, with momentum as torch's dampening-0 rule."""
    if momentum is None:
        return _scale_by_learning_rate(learning_rate)
    return chain(_trace(momentum), _scale_by_learning_rate(learning_rate))


def _scale_by_adamax(b1=0.9, b2=0.999, eps=1e-8) -> Transform:
    """optax's `scale_by_adamax`: the bias-corrected first moment over the
    infinity moment max(b2 u, |g| + eps)."""
    def init(params):
        return {"count": 0, "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(grads, state, params=None):
        names = list(grads)
        g = [grads[k] for k in names]
        mu, nu = [state["mu"][k] for k in names], [state["nu"][k] for k in names]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_maximum_(nu, torch._foreach_add(torch._foreach_abs(g), eps))
        t = state["count"] + 1
        mu_hat = torch._foreach_div(mu, 1 - _f32(b1, g[0]) ** t)
        return dict(zip(names, torch._foreach_div(mu_hat, nu))), {**state, "count": t}

    return Transform(init, update)


def adamax(learning_rate, b1=0.9, b2=0.999, eps=1e-8) -> Transform:
    """optax.adamax."""
    return chain(_scale_by_adamax(b1, b2, eps), _scale_by_learning_rate(learning_rate))


OPTIMIZERS = {"adam": adam, "sgd": sgd, "sgdm": lambda lr: sgd(lr, 0.9), "adamax": adamax}


def lookahead(inner: Transform, sync_period: int = 6,
              slow_step_size: float = 0.5) -> Transform:
    """LookAhead with the slow weights in the optimizer state (the JAX
    package's `lookahead`, reference training/ranger.py:140-160): every
    `sync_period` updates the emitted update moves the fast weights to
    slow + slow_step_size (fast - slow), and the slow weights follow."""
    def init(params):
        return {"inner": inner.init(params), "gstep": 0,
                "slow": {k: p.detach().clone() for k, p in params.items()}}

    def update(grads, state, params=None):
        if params is None:
            raise ValueError("lookahead requires params")
        updates, inner_state = inner.update(grads, state["inner"], params)
        gstep = state["gstep"] + 1
        if gstep % sync_period == 0:
            for k, u in updates.items():
                fast = params[k] + u
                slow = state["slow"][k]
                new_slow = slow + slow_step_size * (fast - slow)
                updates[k] = new_slow - params[k]
                slow.copy_(new_slow)
        return updates, {"inner": inner_state, "gstep": gstep, "slow": state["slow"]}

    return Transform(init, update)


def ranger(learning_rate, sync_period: int = 6, slow_step_size: float = 0.5) -> Transform:
    """RAdam inside LookAhead (reference training/ranger.py:163)."""
    return lookahead(radam(learning_rate), sync_period, slow_step_size)


def masked(inner: Transform, mask: Mapping[str, bool]) -> Transform:
    """optax's `multi_transform({True: inner, False: set_to_zero()}, mask)`:
    only the names the mask sets reach `inner` (and have state there); the
    others get no update at all. A trainable tensor without a gradient
    (unused in the loss, e.g. a noise weight when no noise is injected)
    gets a zero gradient, as JAX's `grad` gives it."""
    def init(params):
        return inner.init({k: p for k, p in params.items() if mask[k]})

    def update(grads, state, params):
        live = {k: p for k, p in params.items() if mask[k]}
        g = {k: grads[k] if grads.get(k) is not None else torch.zeros_like(p)
             for k, p in live.items()}
        return inner.update(g, state, live)

    return Transform(init, update)


@torch.no_grad()
def apply_updates(params: Mapping[str, torch.Tensor], updates: Mapping[str, torch.Tensor]) -> None:
    """optax.apply_updates in place: p += u for every name in `updates`."""
    names = list(updates)
    torch._foreach_add_([params[k] for k in names], [updates[k] for k in names])
