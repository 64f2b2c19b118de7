#!/usr/bin/env python3
"""Convert the JAX package's orbax checkpoint directories into the PyTorch
port's torch files.

The JAX package (`e4s2024_tpu`) stores its weights as orbax checkpoint
directories: a model zoo written by `utils/checkpoint.save_zoo` (one
directory per model name) and the trainer's state written by
`Coach.save_checkpoint`. The port (`e4s2024_torch`) reads torch files
only, and the machines it runs on need neither JAX nor orbax. Run this
script once where JAX and orbax are installed:

    python orbax_to_torch.py zoo <orbax_root> <out_dir>
        every named directory under <orbax_root> -> <out_dir>/<name>.pt,
        through the port's `save_zoo` (state dicts in the reference's
        names, which the port's modules and `swap_cli` load)

    python orbax_to_torch.py coach <orbax_step_dir> <out.pt>
        a `Coach.save_checkpoint` directory -> the file that the port's
        `Coach.restore_checkpoint` reads: weights, EMA, step and the Adam
        (or Ranger) states of both optimizers

A zoo name without a converter raises and lists the names known. Neither
package imports this script.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))


def _params(tree):
    """The params of a {"params": ...} variables tree; the tree itself
    otherwise."""
    if isinstance(tree, dict) and set(tree) <= {"params", "batch_stats"} and "params" in tree:
        return tree["params"]
    return tree


def _zoo_converters() -> dict:
    from e4s2024_torch import convert as c

    def params(fn):
        return lambda tree: fn(_params(tree))

    return {
        "rgi": c.rgi_state_dict_from_jax,
        "bisenet": params(c.bisenet_state_dict_from_jax),
        "arcface": params(c.arcface_state_dict_from_jax),
        "lpips": params(c.lpips_state_dict_from_jax),
        "parser": params(c.parsing_unet_state_dict_from_jax),
        "discriminator": params(c.discriminator_state_dict_from_jax),
        "swinir": params(c.swinir_state_dict_from_jax),
        "gpen": params(c.gpen_state_dict_from_jax),
        "realesrgan": params(c.rrdbnet_state_dict_from_jax),
        "blender": params(c.blender_state_dict_from_jax),
        "gcfsr": params(c.gcfsr_state_dict_from_jax),
        "codeformer": params(c.codeformer_state_dict_from_jax),
        "gfpgan": params(c.gfpgan_state_dict_from_jax),
        "misf": params(c.misf_state_dict_from_jax),
        "hopenet": params(c.hopenet_state_dict_from_jax),
        "fan": params(c.fan_state_dict_from_jax),
        "facevid2vid": params(c.facevid2vid_state_dicts_from_jax),
        "tpsmm": params(c.tpsmm_state_dicts_from_jax),
        "dagan": params(c.dagan_state_dicts_from_jax),
        "lia": params(c.lia_state_dict_from_jax),
    }


def _restore(path: str):
    """The raw tree of an orbax checkpoint directory (numpy leaves, dicts
    and lists), restored without a template."""
    import orbax.checkpoint as ocp

    return ocp.StandardCheckpointer().restore(os.path.abspath(path))


def convert_zoo(root: str, out_dir: str) -> list[str]:
    """Every checkpoint directory under `root` -> `<out_dir>/<name>.pt`.
    Returns the names written."""
    from e4s2024_torch.utils.checkpoint import save_zoo

    table = _zoo_converters()
    names = sorted(n for n in os.listdir(root) if os.path.isdir(os.path.join(root, n)))
    unknown = [n for n in names if n not in table]
    if unknown:
        raise ValueError(f"no converter for zoo name(s) {unknown}; known: {sorted(table)}")
    for name in names:
        save_zoo(out_dir, {name: table[name](_restore(os.path.join(root, name)))})
    return names


def convert_coach(step_dir: str, out_path: str) -> None:
    """A JAX `Coach.save_checkpoint` directory -> the port's checkpoint file."""
    from e4s2024_torch.convert import coach_state_from_jax
    from e4s2024_torch.utils.checkpoint import save_pytree

    raw = _restore(step_dir)
    save_pytree(out_path, coach_state_from_jax(
        raw["params"], raw["buffers"], raw["ema_params"], raw["d_params"], raw["step"],
        g_opt=raw["g_opt"], d_opt=raw["d_opt"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    z = sub.add_parser("zoo", help="a save_zoo directory -> <out_dir>/<name>.pt files")
    z.add_argument("orbax_root")
    z.add_argument("out_dir")
    k = sub.add_parser("coach", help="a Coach.save_checkpoint directory -> one .pt file")
    k.add_argument("orbax_step_dir")
    k.add_argument("out_path")
    args = ap.parse_args(argv)
    if args.cmd == "zoo":
        for name in convert_zoo(args.orbax_root, args.out_dir):
            print(f"wrote {os.path.join(args.out_dir, name + '.pt')}")
    else:
        convert_coach(args.orbax_step_dir, args.out_path)
        print(f"wrote {args.out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
