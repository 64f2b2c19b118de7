"""Data-parallel training over a process group, the counterpart of the JAX
package's 1-D `dp` mesh (`e4s2024_tpu/parallel/mesh.py`).

The JAX package shards the batch over a device mesh and lets XLA insert
the gradient all-reduce. Here each process drives one device, takes its
`(rank, world)` shard of the batches, and the trained modules are wrapped
in `DistributedDataParallel`, which averages the gradients over the group:
with equal local batches that is the gradient of the global-batch mean
loss. Parameters start equal on every rank (DDP broadcasts rank 0's).

Nothing on the host tells a process about the others: the caller gives the
world size, the rank and a rendezvous (a `tcp://` or `file://` address or
a `torch.distributed.Store`). The JAX package's 2-D `(dp, sp)` mesh, which
also shards image height with GSPMD's halo exchange, has no counterpart.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from e4s2024_torch import resolve_device


def make_process_group(world_size: int = 1, rank: int = 0, *, device=None,
                       init_method: str | None = None, store: dist.Store | None = None):
    """Join (or start) the default process group: NCCL for a CUDA device,
    gloo for the CPU. On CUDA, rank r drives card r of this host, and fewer
    visible cards than `world_size` raise, as `make_mesh` raises for too few
    devices: a multi-card run must not shrink to one card unnoticed.
    Returns the group."""
    device = resolve_device(device)
    if world_size < 1 or not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} of a world of {world_size}")
    if device.type == "cuda":
        visible = torch.cuda.device_count()
        if visible < world_size:
            raise RuntimeError(f"requested a {world_size}-device group but only {visible} "
                               "CUDA device(s) are visible")
        torch.cuda.set_device(rank)
    if (init_method is None) == (store is None):
        raise ValueError("give exactly one of init_method and store")
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method=init_method, store=store,
                                world_size=world_size, rank=rank)
    return dist.group.WORLD


def data_parallel(module: nn.Module, group, find_unused_parameters: bool = False) -> nn.Module:
    """`module` in DistributedDataParallel over `group`, on the device of its
    parameters. `find_unused_parameters` for a module whose
    step leaves trainable parameters without a gradient (the generator's
    noise weights, with no noise injected)."""
    device = next(module.parameters()).device
    return DistributedDataParallel(
        module, device_ids=[device.index] if device.type == "cuda" else None,
        process_group=group, find_unused_parameters=find_unused_parameters)


def mean_over_group(values: torch.Tensor, group) -> torch.Tensor:
    """The mean of `values` over the group's ranks (for metrics)."""
    if group is None or dist.get_world_size(group) == 1:
        return values
    out = values.clone()
    dist.all_reduce(out, group=group)
    return out / dist.get_world_size(group)
