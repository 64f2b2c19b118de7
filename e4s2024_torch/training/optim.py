"""Latent refinement: W-space optimisation of the per-region style vectors
(reference optimization.py:321-351 `Optimizer.optim_W_online`; 150-200
steps of Adam at lr 1e-2, options/optim_options.py:37-39).

Counterpart of `e4s2024_tpu/training/optim.py::optimize_style_vectors`,
which scans optax updates in one XLA program; here a plain loop of
autograd steps (on the card the generator's K1-K3 run with their backward
kernels). The optimisers follow optax's update rules, not torch.optim's:
Adam's eps is added to sqrt(v / (1 - b2^t)) with no eps inside the root
(torch.optim.Adam adds it to sqrt(v) / sqrt(1 - b2^t), the same value
rounded in another order) and both bias corrections are taken in float32
(`_bias_correction`), SGD with momentum accumulates t = g + 0.9 t
(torch's dampening 0 rule) and Adamax divides the bias-corrected first
moment by max(b2 u, |g| + eps) (optax's infinity moment). `ranger` and
`lookahead` come with the training port.
"""

from __future__ import annotations

from typing import Callable

import torch

from e4s2024_torch.models.rgi import RGINet


def _bias_correction(decay: float, t: int, like: torch.Tensor) -> torch.Tensor:
    """1 - decay^t in the moment's dtype, as optax computes it (torch.optim
    takes it in float64: at t = 1 and decay 0.999 the two differ by 1.3e-5
    relative in float32)."""
    return 1 - torch.tensor(decay, dtype=like.dtype, device=like.device) ** t


def _adam(lr, b1=0.9, b2=0.999, eps=1e-8):
    def update(g, state, t):
        m = state["m"] = (1 - b1) * g + b1 * state.get("m", torch.zeros_like(g))
        v = state["v"] = (1 - b2) * g * g + b2 * state.get("v", torch.zeros_like(g))
        m_hat, v_hat = m / _bias_correction(b1, t, m), v / _bias_correction(b2, t, v)
        return -lr * (m_hat / (torch.sqrt(v_hat) + eps))
    return update


def _sgd(lr, momentum=None):
    def update(g, state, t):
        if momentum is not None:
            g = state["trace"] = g + momentum * state.get("trace", torch.zeros_like(g))
        return -lr * g
    return update


def _adamax(lr, b1=0.9, b2=0.999, eps=1e-8):
    def update(g, state, t):
        m = state["m"] = (1 - b1) * g + b1 * state.get("m", torch.zeros_like(g))
        u = state["u"] = torch.maximum(g.abs() + eps, b2 * state.get("u", torch.zeros_like(g)))
        return -lr * ((m / _bias_correction(b1, t, m)) / u)
    return update


OPTIMIZERS = {"adam": _adam, "sgd": _sgd, "sgdm": lambda lr: _sgd(lr, 0.9),
              "adamax": _adamax}


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
    update = OPTIMIZERS[optimizer](lr)
    with torch.inference_mode(False), torch.enable_grad():
        img, onehot = img.clone(), onehot.clone()
        if init_style_vectors is None:
            with torch.no_grad():
                init_style_vectors, _ = net.get_style_vectors(img, onehot)
        sv = init_style_vectors.detach().clone()
        state: dict = {}
        losses = []
        for t in range(1, steps + 1):
            leaf = sv.requires_grad_(True)
            recon, _, _ = net.gen_img(None, net.cal_style_codes(leaf), onehot,
                                      regional_mode=regional_mode)
            loss, _ = criterion(recon, img)
            (grad,) = torch.autograd.grad(loss, leaf)
            losses.append(loss.detach())
            sv = leaf.detach() + update(grad, state, t)
    return sv, torch.stack(losses)
