"""Training CLI, `python -m e4s2024_torch.train` (counterpart of
`e4s2024_tpu/train.py`; reference train.py:16-30).

Parses the TrainConfig flags (`config.E4SConfig.from_args`), writes
`opt.json` into `--exp_dir`, joins the process group when the world has
more than one rank, and runs the Coach over the dataset's train split with
logging every 50 steps, a checkpoint every 10,000 steps and the best
validation state (`best.pt`). Flags of the port's own, read before the
TrainConfig flags:

  --device cuda|cpu      where the nets run (CUDA by default)
  --data_root PATH       the CelebA-HQ / FFHQ tree ({train,test}/{images,labels});
                         default: the DataConfig root of --dataset_name
  --world_size N --rank R --init_method URL
                         data parallelism over N processes, one card each
                         (NCCL; gloo on the CPU); every rank reads the same
                         global batches of --batch_size and trains on its
                         contiguous share of their rows

The train split is read as celebahq19 labels, as the JAX package reads it.
"""

from __future__ import annotations

import argparse
import os
import sys


def _own_flags(argv):
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--data_root", default=None)
    parser.add_argument("--world_size", type=int, default=1)
    parser.add_argument("--rank", type=int, default=0)
    parser.add_argument("--init_method", default=None)
    return parser.parse_known_args(argv)


def main(argv=None):
    import torch

    from e4s2024_torch.config import E4SConfig, load_all_loss_params
    from e4s2024_torch.data.datasets import FaceMaskDataset
    from e4s2024_torch.parallel.ddp import make_process_group
    from e4s2024_torch.training.coach import Coach

    own, rest = _own_flags(argv)
    cfg = E4SConfig.from_args(rest, section="train")
    os.makedirs(cfg.exp_dir, exist_ok=True)
    with open(os.path.join(cfg.exp_dir, "opt.json"), "w") as f:
        f.write(cfg.to_json())

    world, rank = own.world_size, own.rank
    group = None
    if world > 1:
        group = make_process_group(world, rank, device=own.device,
                                   init_method=own.init_method)
    device = f"cuda:{rank}" if own.device == "cuda" and world > 1 else own.device
    if cfg.train.batch_size % world:
        raise ValueError(f"batch_size {cfg.train.batch_size} is not a multiple of "
                         f"the world size {world}")
    coach = Coach(cfg.train, loss_params=load_all_loss_params(cfg.checkpoints),
                  process_group=group, device=device)
    state = coach.init_state(torch.Generator().manual_seed(0))

    root = own.data_root or (cfg.data.celeba_root if cfg.data.dataset_name == "celeba"
                             else cfg.data.ffhq_root)
    ds = FaceMaskDataset(root, mode="train", fraction=cfg.data.ds_frac, flip_p=cfg.data.flip_p)
    batches = ds.batches(cfg.train.batch_size)

    def log(step, metrics):
        if step % 50 == 0 and rank == 0:
            msg = " ".join(f"{k}={v:.4f}" for k, v in metrics.items())
            print(f"[step {step}] {msg}", flush=True)

    # the validation stream for the best-model save (reference
    # coach.py:570-631): global batches of the test split, and a split too
    # small for one batch turns validation off (an empty stream would never
    # end)
    val_batches = None
    if cfg.train.val_every:
        val_ds = FaceMaskDataset(root, mode="test", fraction=cfg.data.ds_frac, flip_p=0.0)
        if len(val_ds) >= cfg.train.batch_size:
            val_batches = val_ds.batches(cfg.train.batch_size)
        elif rank == 0:
            print(f"[train] test split has {len(val_ds)} images "
                  f"(< batch_size {cfg.train.batch_size}); validation off", flush=True)

    try:
        coach.fit(batches, state, steps=cfg.train.max_steps, callback=log,
                  ckpt_dir=cfg.exp_dir, save_every=10_000, val_batches=val_batches,
                  val_every=cfg.train.val_every or None, val_steps=cfg.train.val_steps)
    finally:
        if group is not None:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
