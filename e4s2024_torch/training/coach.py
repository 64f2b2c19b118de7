"""The RGI net's trainer: the Coach, with its G and D steps (counterpart of
`e4s2024_tpu/training/coach.py`; reference training/coach.py:33-631).

- The G objective is the reference's: LPIPS (3 scales) 0.8, ID 0.1, face
  parsing 0.1, L2 1.0 (`losses.recon.ReconCriterion`), plus 0.01 times the
  non-saturating adversarial loss through the Discriminator.
- The D trains every `d_every` steps on softplus losses, with the R1
  penalty every `d_reg_every` steps (-1: never), its double backward
  through kernels K1 and K2 on a card.
- The EMA of every RGI parameter uses ACCUM = 0.5 ** (32 / 100_000).
- The frozen set is Net3's (`_g_trainable_mask`): the StyleGAN mapping MLP
  never trains, nor do the layers at or past remaining_layer_idx. Frozen
  tensors do not require grad and get no optimizer state.
- Adam (or Ranger) with optax's rules, the learning rate x0.1 at
  `lr_decay_step` updates of each optimizer (`training/optim.py`).
- Data parallelism, JAX's `Coach(mesh=make_mesh(w))`: with a process
  group every step takes the global batch, each rank runs its contiguous
  share of the rows (`parallel.ddp.shard_rows`, `P("dp")`), the
  Discriminator's minibatch stddev gathers its features over the group
  (the global batch's stddev, as JAX's), and the gradients are averaged
  over the group before each update; the weights start from rank 0's.
- Checkpoints are torch files with the JAX package's keys (`step`,
  `params`, `buffers`, `ema_params`, `d_params`, `g_opt`, `d_opt`).

The state's modules hold the live weights; `fit` updates them in place.
The loss nets stay frozen and in eval mode, and no module here is switched
to training mode: none has a norm layer with batch statistics.
"""

from __future__ import annotations

import math
import os
import weakref
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Mapping

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from e4s2024_torch import resolve_device
from e4s2024_torch.convert import (as_tensors, drop_discriminator_buffers,
                                   drop_generator_buffers, strip_module_prefix)
from e4s2024_torch.losses.losses import adv_d_loss, adv_g_loss, r1_penalty
from e4s2024_torch.losses.recon import ReconCriterion
from e4s2024_torch.models.rgi import RGINet
from e4s2024_torch.models.stylegan2 import Discriminator
from e4s2024_torch.parallel.ddp import (average_gradients, broadcast_parameters,
                                        mean_over_group, shard_rows)
from e4s2024_torch.training import optim
from e4s2024_torch.utils.checkpoint import load_pytree, save_pytree

EMA_ACCUM = 0.5 ** (32 / (100 * 1000))  # reference coach.py:30


@dataclass(frozen=True)
class TrainConfig:
    """Mirrors reference options/train_options.py defaults."""

    out_size: int = 1024
    num_seg_cls: int = 12
    remaining_layer_idx: int = 13
    channel_multiplier: int = 2
    encoder_input_size: int = 256  # reference fixed at 256 (networks.py:114)
    encoder_num_units: tuple = (3, 4, 14, 3)
    batch_size: int = 2
    learning_rate: float = 1e-4
    optim_name: str = "adam"       # "adam" | "ranger" (reference --optim_name)
    max_steps: int = 200_000
    lr_decay_step: int = 100_000   # x0.1 (coach.py:440-442)
    d_every: int = 15
    d_reg_every: int = -1
    # loss weights (train_options.py:50-59)
    lpips_lambda: float = 0.8
    id_lambda: float = 0.1
    face_parsing_lambda: float = 0.1
    l2_lambda: float = 1.0
    adv_lambda: float = 0.01
    r1_lambda: float = 10.0
    train_G: bool = True
    train_D: bool = True
    # "exact": the reference's per-component conv semantics; "fast": per-pixel
    # regional modulation (e4s2024_torch.ops.modconv)
    regional_mode: str = "exact"
    # recompute the G forward in the G step's backward (torch.utils.checkpoint)
    remat: bool = False
    val_every: int = 5_000
    val_steps: int = 16


def _g_trainable_mask(names: Iterable[str], cfg: TrainConfig) -> dict[str, bool]:
    """Which RGINet parameters train, by state-dict name (the freeze rules
    of Net3, reference networks.py:82-95, as the JAX package applies them):
    the generator's style MLP (`G.style.*`) never trains; with
    remaining_layer_idx != 17 the last 17 - remaining_layer_idx convolutions
    (`G.convs.{i}`) and that many halves plus one of the ToRGBs
    (`G.to_rgbs.{i}`) are frozen; without `train_G` no `G.*` trains. The
    encoder and the per-region `MLPs.*` are in the set (PTI never runs the
    encoder, so it gets no gradient)."""
    n_convs = 2 * (int(math.log2(cfg.out_size)) - 2)
    n_rgbs = n_convs // 2
    frozen = set()
    if cfg.remaining_layer_idx != 17:
        n_frozen = 17 - cfg.remaining_layer_idx
        frozen |= {f"convs.{i}" for i in range(max(n_convs - n_frozen, 0), n_convs)}
        frozen |= {f"to_rgbs.{i}" for i in range(max(n_rgbs - (n_frozen // 2 + 1), 0), n_rgbs)}

    def trainable(name: str) -> bool:
        if not name.startswith("G."):
            return True
        parts = name.split(".")
        if parts[1] == "style" or not cfg.train_G:
            return False
        return ".".join(parts[1:3]) not in frozen

    return {name: trainable(name) for name in names}


@dataclass
class CoachState:
    """The trainer's state: the RGI net and the Discriminator (their
    parameters are the live weights), the EMA of every RGI parameter, the
    optimizer states, and the step (G updates so far)."""

    step: int
    net: RGINet
    ema_params: dict[str, torch.Tensor]
    disc: Discriminator
    g_opt: Any
    d_opt: Any

    @property
    def params(self) -> dict[str, torch.Tensor]:
        return dict(self.net.named_parameters())

    @property
    def buffers(self) -> dict[str, torch.Tensor]:
        return {"latent_avg": self.net.latent_avg}

    @property
    def d_params(self) -> dict[str, torch.Tensor]:
        return dict(self.disc.named_parameters())


class Coach:
    """Builds the nets, the optimizers and the G and D steps.

    `loss_params` may hold "lpips", "arcface" and "parser" entries (the
    port's modules or their state dicts); a missing one disables its term.
    `process_group` (from `parallel.ddp.make_process_group`) runs the steps
    data-parallel over global batches; `device` defaults to CUDA."""

    def __init__(self, cfg: TrainConfig, loss_params: Mapping | None = None, *,
                 process_group=None, device=None):
        if cfg.optim_name not in ("adam", "ranger"):
            raise ValueError(f"optim_name {cfg.optim_name!r}: 'adam' or 'ranger'")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.group = process_group
        self.criterion = ReconCriterion(
            loss_params or {}, lpips_lambda=cfg.lpips_lambda, id_lambda=cfg.id_lambda,
            face_parsing_lambda=cfg.face_parsing_lambda, l2_lambda=cfg.l2_lambda,
            device=self.device)
        sched = optim.piecewise_constant_schedule(cfg.learning_rate, {cfg.lr_decay_step: 0.1})
        make = optim.ranger if cfg.optim_name == "ranger" else optim.adam
        with torch.device("meta"):
            names = [n for n, _ in self._nets()[0].named_parameters()]
        self._mask = _g_trainable_mask(names, cfg)
        self._g_tx = optim.masked(make(sched), self._mask)
        self._d_tx = make(sched)
        # the nets whose weights were made rank 0's since they were last set
        self._synced = weakref.WeakSet()

    def _nets(self) -> tuple[RGINet, Discriminator]:
        cfg = self.cfg
        net = RGINet(num_seg_cls=cfg.num_seg_cls, out_size=cfg.out_size,
                     remaining_layer_idx=cfg.remaining_layer_idx,
                     channel_multiplier=cfg.channel_multiplier,
                     encoder_input_size=cfg.encoder_input_size,
                     encoder_num_units=cfg.encoder_num_units)
        return net, Discriminator(cfg.out_size, cfg.channel_multiplier)

    # ---------------- state ----------------

    def init_state(self, generator: torch.Generator | None = None) -> CoachState:
        """Fresh nets with their modules' default initialisation, drawn from
        `generator` (a CPU torch.Generator; None: a fresh seed-0 one)
        without touching the global RNG."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            net, disc = self._nets()
        net, disc = net.to(self.device), disc.to(self.device)
        for name, p in net.named_parameters():
            p.requires_grad_(self._mask[name])
        params = dict(net.named_parameters())
        return CoachState(step=0, net=net, ema_params=_clone(params), disc=disc,
                          g_opt=self._g_tx.init(params),
                          d_opt=self._d_tx.init(dict(disc.named_parameters())))

    def load_pretrained(self, state: CoachState, rgi_state_dict: Mapping,
                        d_state_dict: Mapping | None = None) -> CoachState:
        """Start from reference weights (reference coach.py:88-173): an RGI
        state dict (the generator's fixed buffers checked and dropped,
        `convert.drop_generator_buffers`; `latent_avg` included) and
        optionally a reference Discriminator's (its Blur buffers checked and
        dropped). The EMA restarts from the loaded weights; the optimizer
        states are kept."""
        sd = as_tensors(drop_generator_buffers(strip_module_prefix(rgi_state_dict)))
        with torch.no_grad():
            state.net.load_state_dict(sd, strict=True)
            if d_state_dict is not None:
                state.disc.load_state_dict(
                    as_tensors(drop_discriminator_buffers(d_state_dict)), strict=True)
        state.ema_params = _clone(state.params)
        self._synced.discard(state.net)
        self._synced.discard(state.disc)
        return state

    def load_tree(self, state: CoachState, tree: Mapping) -> CoachState:
        """Load a tree with the checkpoint's keys into `state`: `params`,
        `buffers`, `ema_params` and `d_params` (reference names), `step`,
        and `g_opt` / `d_opt` where the tree has them (a tree from
        `convert.coach_state_from_jax` has none: the states stay as they
        are, zero for a fresh state)."""
        dev = self.device
        with torch.no_grad():
            state.net.load_state_dict(as_tensors({**tree["params"], **tree["buffers"]}),
                                      strict=True)
            state.disc.load_state_dict(as_tensors(tree["d_params"]), strict=True)
        state.ema_params = {k: torch.as_tensor(v).to(dev, torch.float32).clone()
                            for k, v in tree["ema_params"].items()}
        state.step = int(tree["step"])
        if "g_opt" in tree:
            state.g_opt = _to_device(tree["g_opt"], dev)
            state.d_opt = _to_device(tree["d_opt"], dev)
        self._synced.discard(state.net)
        self._synced.discard(state.disc)
        return state

    # ---------------- steps ----------------

    def _local(self, state: CoachState, *batch: torch.Tensor) -> tuple:
        """This rank's rows of a global batch. Under a group the first step
        after a state's weights were set gives its nets rank 0's weights,
        and the Discriminator joins the group for its minibatch stddev."""
        if self.group is None:
            return batch
        state.disc.process_group = self.group
        for module in (state.net, state.disc):
            if module not in self._synced:
                broadcast_parameters(module, self.group)
                self._synced.add(module)
        return tuple(shard_rows(x, self.group) for x in batch)

    def _recon(self, net: RGINet, img, onehot):
        """The G step's forward, image only; under `remat` the whole forward
        is recomputed in the backward pass."""
        def fwd(img, onehot):
            return net(img, onehot, regional_mode=self.cfg.regional_mode)[0]

        if self.cfg.remat:
            return checkpoint(fwd, img, onehot, use_reentrant=False)
        return fwd(img, onehot)

    def g_step(self, state: CoachState, img: torch.Tensor, onehot: torch.Tensor):
        """One generator update (reference coach.py:453-503) on a global
        batch: the recon criterion plus adv_lambda times the adversarial
        loss, the masked optimizer over the RGI net, the EMA. Returns
        (state, metrics as 0-d tensors, this rank's batch means)."""
        cfg = self.cfg
        img, onehot = self._local(state, img, onehot)
        params = state.params
        d_params = list(state.disc.parameters())
        flags = [p.requires_grad for p in d_params]
        for p in d_params:
            p.requires_grad_(False)
        try:
            recon = self._recon(state.net, img, onehot)
            loss, metrics = self.criterion(recon, img)
            if cfg.adv_lambda > 0 and cfg.train_D:
                adv = adv_g_loss(state.disc(recon))
                loss = loss + cfg.adv_lambda * adv
                metrics["loss_g_adv"] = adv
            metrics["loss"] = loss
            for p in params.values():
                p.grad = None
            loss.backward()
        finally:
            for p, flag in zip(d_params, flags):
                p.requires_grad_(flag)
        average_gradients([p for k, p in params.items() if self._mask[k]], self.group)
        grads = {k: p.grad for k, p in params.items() if self._mask[k]}
        updates, state.g_opt = self._g_tx.update(grads, state.g_opt, params)
        optim.apply_updates(params, updates)
        for p in params.values():
            p.grad = None
        _ema_update(state.ema_params, params)
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    def d_step(self, state: CoachState, img: torch.Tensor, onehot: torch.Tensor,
               with_r1: bool = False):
        """One discriminator update (reference coach.py:321-360) on a global
        batch: softplus losses on the real batch and the (detached)
        reconstruction; with `with_r1`, plus r1_lambda / 2 * R1 *
        max(d_reg_every, 1). Returns (state, metrics as 0-d tensors, this
        rank's batch means)."""
        cfg = self.cfg
        img, onehot = self._local(state, img, onehot)
        with torch.no_grad():
            recon = state.net(img, onehot, regional_mode=cfg.regional_mode)[0]
        disc = state.disc
        fake_pred, real_pred = disc(recon), disc(img)
        loss = adv_d_loss(real_pred, fake_pred)
        metrics = {"d_loss": loss, "real_score": real_pred.mean(),
                   "fake_score": fake_pred.mean()}
        if with_r1:
            r1 = r1_penalty(disc, img)
            loss = loss + cfg.r1_lambda / 2 * r1 * max(cfg.d_reg_every, 1)
            metrics["r1_loss"] = r1
        d_params = state.d_params
        for p in d_params.values():
            p.grad = None
        loss.backward()
        average_gradients(d_params.values(), self.group)
        grads = {k: p.grad for k, p in d_params.items()}
        updates, state.d_opt = self._d_tx.update(grads, state.d_opt, d_params)
        optim.apply_updates(d_params, updates)
        for p in d_params.values():
            p.grad = None
        return state, {k: v.detach() for k, v in metrics.items()}

    # ---------------- host loop ----------------

    def _as_device(self, *arrays) -> tuple:
        return tuple(torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a)
                     .to(self.device, torch.float32) for a in arrays)

    def _host(self, metrics: dict) -> dict[str, float]:
        """Metric tensors -> floats with one copy (the group's mean)."""
        if not metrics:
            return {}
        names = list(metrics)
        values = torch.stack([metrics[k].float() for k in names])
        return dict(zip(names, mean_over_group(values, self.group).cpu().tolist()))

    def fit(self, batches: Iterable, state: CoachState, steps: int,
            callback: Callable[[int, dict], None] | None = None, *,
            ckpt_dir: str | None = None, save_every: int | None = None,
            val_batches: Iterable | None = None, val_every: int | None = None,
            val_steps: int = 4) -> CoachState:
        """Run `steps` iterations over (img, onehot) global batches: img
        (B, 3, S, S) in [-1, 1], onehot (B, K, 512, 512), numpy or tensors;
        under a group every rank is given the same batches.

        D before G when step % d_every == 0, with R1 when d_reg_every != -1
        and step % d_reg_every == 0; `callback(step, metrics)` with float
        metrics. With `ckpt_dir`: a checkpoint every `save_every` steps
        (`<ckpt_dir>/step_XXXXXXXX.pt`) and, with `val_batches` and
        `val_every`, the mean validation loss over `val_steps` batches, the
        best state saved to `<ckpt_dir>/best.pt` (reference coach.py:544-631)."""
        cfg = self.cfg
        it = iter(batches)
        best_val = float("inf")
        for _ in range(steps):
            img, onehot = self._as_device(*next(it))
            step = state.step
            metrics = {}
            if cfg.train_D and step % cfg.d_every == 0:
                with_r1 = cfg.d_reg_every != -1 and step % cfg.d_reg_every == 0
                state, d_metrics = self.d_step(state, img, onehot, with_r1)
                metrics.update(d_metrics)
            if cfg.train_G:
                state, g_metrics = self.g_step(state, img, onehot)
                metrics.update(g_metrics)
            metrics = self._host(metrics)
            done = state.step
            if ckpt_dir and save_every and done % save_every == 0:
                self.save_checkpoint(os.path.join(ckpt_dir, f"step_{done:08d}.pt"), state)
            if val_batches is not None and val_every and done % val_every == 0:
                metrics["val_loss"] = self.validate(val_batches, state, val_steps)
                if ckpt_dir and metrics["val_loss"] < best_val:
                    best_val = metrics["val_loss"]
                    self.save_checkpoint(os.path.join(ckpt_dir, "best.pt"), state)
            if callback is not None:
                callback(step, metrics)
        return state

    def validate(self, batches: Iterable, state: CoachState, steps: int = 4) -> float:
        """Mean reconstruction loss over `steps` validation batches (global
        batches, as `fit` takes them), no update (reference Coach.validate,
        coach.py:570-622). Pass the same iterator again to continue it."""
        it = iter(batches)
        losses = []
        with torch.no_grad():
            for _ in range(steps):
                img, onehot = self._local(state, *self._as_device(*next(it)))
                recon = state.net(img, onehot, regional_mode=self.cfg.regional_mode)[0]
                losses.append(self.criterion(recon, img)[0])
        return float(mean_over_group(torch.stack(losses).mean().reshape(1), self.group))

    # ---------------- checkpointing ----------------

    def save_checkpoint(self, path: str, state: CoachState) -> None:
        """The state as one torch file (`utils.checkpoint.save_pytree`); on
        rank 0 only under a process group."""
        if self.group is not None and torch.distributed.get_rank(self.group) != 0:
            return
        net = state.net.state_dict()
        save_pytree(path, {
            "step": state.step,
            "params": {k: net[k] for k in state.params},
            "buffers": {"latent_avg": net["latent_avg"]},
            "ema_params": state.ema_params, "d_params": state.disc.state_dict(),
            "g_opt": state.g_opt, "d_opt": state.d_opt})

    def restore_checkpoint(self, path: str, state: CoachState) -> CoachState:
        return self.load_tree(state, load_pytree(path))


def _clone(tensors: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in tensors.items()}


def _to_device(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree


@torch.no_grad()
def _ema_update(ema: dict[str, torch.Tensor], params: Mapping[str, torch.Tensor]) -> None:
    """ema = ema * EMA_ACCUM + p * (1 - EMA_ACCUM), every RGI parameter."""
    names = list(ema)
    e = [ema[k] for k in names]
    torch._foreach_mul_(e, EMA_ACCUM)
    torch._foreach_add_(e, torch._foreach_mul([params[k].detach() for k in names],
                                              1.0 - EMA_ACCUM))
