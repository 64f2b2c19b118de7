"""Checkpoint IO over torch files: one save/load pair for every tree of
tensors (counterpart of `e4s2024_tpu/utils/checkpoint.py`).

A tree is nested dicts and lists of tensors and Python numbers (a state
dict, the trainer's state). `save_pytree` writes one tree to one file with
its tensors on the CPU; a zoo directory holds one `<name>.pt` file per
model. The JAX package's orbax directories are not read here (that needs
orbax and tensorstore).
"""

from __future__ import annotations

import os
from typing import Any

import torch


def _abspath(path: str) -> str:
    return os.path.abspath(os.path.expanduser(path))


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_pytree(path: str, tree: Any) -> None:
    """Write a tree to the torch file `path` (its directory is made), its
    tensors on the CPU. The file is replaced as a whole: written beside it,
    then renamed."""
    path = _abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(_to_cpu(tree), tmp)
    os.replace(tmp, path)


def load_pytree(path: str) -> Any:
    """Read a tree written by `save_pytree`, its tensors on the CPU
    (tensors and numbers only: `weights_only` loading)."""
    return torch.load(_abspath(path), map_location="cpu", weights_only=True)


def save_zoo(root: str, zoo: dict) -> None:
    """Save {"rgi": state dict, "bisenet": state dict, ...} as root/<name>.pt."""
    for name, tree in zoo.items():
        save_pytree(os.path.join(root, f"{name}.pt"), tree)


def load_zoo(root: str) -> dict:
    """Every `<name>.pt` under `root`, by name."""
    root = _abspath(root)
    return {name[:-3]: load_pytree(os.path.join(root, name))
            for name in sorted(os.listdir(root)) if name.endswith(".pt")}
