"""Training configuration and the generator's trainable set, in part
(`e4s2024_tpu/training/coach.py:51-125`); the G and D steps wait for the
training slice."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterable


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
    regional_mode: str = "exact"
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
