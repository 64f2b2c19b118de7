"""Data parallelism over a process group, the counterpart of the JAX
package's 1-D meshes (`e4s2024_tpu/parallel/mesh.py`): the trainer's `dp`
axis, the tuning coaches' frame axis `fr` and sharded serving.

The JAX package runs one program over a device mesh: a batch placed with
`P("dp")` (or `P("fr")`) is split into contiguous row blocks, one a device,
parameters are replicated, and XLA inserts the gradient all-reduce of the
global-batch mean. Here each process drives one device and holds the
whole global batch, as JAX's one controller does:

- `shard_rows` takes this rank's contiguous block, rank r rows
  [r B / w, (r + 1) B / w), as `P("dp")` places them; an indivisible batch
  raises;
- `gather_rows` concatenates every rank's block in rank order (the
  replicated output of a sharded program);
- `average_gradients` all-reduces the gradients to their mean over the
  group, JAX's psum of the global-batch mean when the local batches are
  equal (flattened into buckets of at most 256 MB, so that the transient
  copy stays small);
- `broadcast_parameters` makes every rank start from rank 0's weights.

A computation that couples the rows of a batch (the Discriminator's
minibatch stddev) gathers them itself, through `gather_rows_autograd`, so
that its gradients reach every rank's rows.

Nothing on the host tells a process about the others: the caller gives the
world size, the rank and a rendezvous (a `tcp://` or `file://` address or
a `torch.distributed.Store`).

The JAX package's 2-D `(dp, sp)` mesh (`make_mesh_2d`) splits the batch
over `dp` and image height over `sp`; its counterpart is
`make_process_grid(dp, sp)`, a `ProcessGrid` of the world's ranks (rank
d sp + s at row d, column s, JAX's `devs.reshape(dp, sp)`) with a group
for each axis, and `shard_rows_spatial` places a global batch as
`P("dp", "sp")` does. `as_process_grid` reads a plain group of W ranks as
the (W, 1) grid. The height split itself is `parallel/spatial.py`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable

import torch
import torch.distributed as dist
from torch import nn

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


@dataclass(frozen=True)
class ProcessGrid:
    """A `(dp, sp)` grid of the world's ranks: this rank's row `dp_index`
    and column `sp_index`, the group of its row (the ranks that split its
    rows of the batch by height: `sp_group`), of its column (the ranks
    that hold the other rows of the batch at the same height: `dp_group`)
    and of the whole world."""

    dp: int
    sp: int
    dp_index: int
    sp_index: int
    dp_group: Any
    sp_group: Any
    world: Any

    @property
    def split(self):
        """The height split (`parallel.spatial.RowSplit`) of this rank."""
        from e4s2024_torch.parallel.spatial import RowSplit

        return RowSplit(self.sp_group, self.sp, self.sp_index)


def make_process_grid(dp: int, sp: int) -> ProcessGrid:
    """The `(dp, sp)` grid over the default process group (from
    `make_process_group`), the counterpart of `make_mesh_2d(dp, sp)`:
    rank d * sp + s sits at row d, column s. Every rank must call it, in
    the same order as any other group it makes. A world of other than
    dp * sp ranks raises, as `make_mesh_2d` raises for too few devices."""
    if dp < 1 or sp < 1:
        raise ValueError(f"a grid of {dp} x {sp}")
    world = dist.get_world_size()
    if world != dp * sp:
        raise RuntimeError(f"requested a {dp}x{sp} grid but the world has {world} rank(s)")
    rank = dist.get_rank()
    rows = [dist.new_group([d * sp + s for s in range(sp)]) for d in range(dp)]
    cols = [dist.new_group([d * sp + s for d in range(dp)]) for s in range(sp)]
    d, s = divmod(rank, sp)
    return ProcessGrid(dp, sp, d, s, dp_group=cols[s], sp_group=rows[d],
                       world=dist.group.WORLD)


def as_process_grid(group) -> ProcessGrid:
    """`group` as a grid: a `ProcessGrid` as it is, and a plain group of W
    ranks (None: one rank) as the (W, 1) grid, data parallelism alone."""
    if isinstance(group, ProcessGrid):
        return group
    rank, world = rank_and_world(group)
    return ProcessGrid(world, 1, rank, 0, dp_group=group, sp_group=None, world=group)


def shard_rows_spatial(x: torch.Tensor, grid: ProcessGrid,
                       heights: Iterable[int] = ()) -> torch.Tensor:
    """This rank's block of a global (B, C, H, W) batch, as `P("dp", "sp")`
    places it: rows [d B / dp, (d + 1) B / dp) of the batch and rows
    [s H / sp, (s + 1) H / sp) of the height. An indivisible B, or an H
    (or any of `heights`, the smaller scales that the nets reach) that sp
    does not divide, raises ValueError."""
    b, h = x.shape[0], x.shape[2]
    if b % grid.dp:
        raise ValueError(f"a batch of {b} rows does not split over {grid.dp} dp ranks")
    for height in (h, *heights):
        if height % grid.sp:
            raise ValueError(f"a height of {height} rows does not split over {grid.sp} "
                             "sp ranks")
    nb, nh = b // grid.dp, h // grid.sp
    return x[grid.dp_index * nb:(grid.dp_index + 1) * nb, :,
             grid.sp_index * nh:(grid.sp_index + 1) * nh]


def rank_and_world(group) -> tuple[int, int]:
    """(rank, world size) in `group`; (0, 1) without one."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def shard_rows(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's contiguous block of the leading axis: rows
    [r B / w, (r + 1) B / w), as `P("dp")` places them. The whole tensor
    without a group; a B that w does not divide raises ValueError."""
    rank, world = rank_and_world(group)
    b = x.shape[0]
    if b % world:
        raise ValueError(f"a batch of {b} rows does not split over a world of {world}")
    n = b // world
    return x[rank * n:(rank + 1) * n]


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's block of rows, concatenated in rank order (no gradient;
    equal blocks on every rank). `x` itself without a group."""
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def gather_rows_autograd(x: torch.Tensor, group) -> torch.Tensor:
    """`gather_rows` through autograd: the gradient of each block returns to
    its rank, summed over the ranks' losses, and it is itself
    differentiable (R1's double backward). Every rank must take part in
    each backward. Built on the differentiable all-reduce of
    `parallel.spatial` (each rank's block in its slot of a zero buffer,
    summed): gloo carries it on CUDA tensors, and it serves a subgroup
    (the `dp` axis of a grid), where the backward of
    `torch.distributed.nn.functional.all_gather` names global rank 0."""
    from e4s2024_torch.parallel.spatial import all_reduce_group

    rank, world = rank_and_world(group)
    if world == 1:
        return x
    b = x.shape[0]
    slots = torch.cat([x.new_zeros((rank * b, *x.shape[1:])), x,
                       x.new_zeros(((world - rank - 1) * b, *x.shape[1:]))])
    return all_reduce_group(slots, group)


# the largest flat buffer a collective over many tensors builds, in
# elements (256 MB of float32): bounds the transient copy on the device
BUCKET_ELEMENTS = 2 ** 26


def _buckets(tensors: list[torch.Tensor]):
    """`tensors` in runs of one dtype whose total size stays within
    BUCKET_ELEMENTS (a larger tensor alone)."""
    run, size = [], 0
    for t in tensors:
        if run and (t.dtype != run[0].dtype or size + t.numel() > BUCKET_ELEMENTS):
            yield run
            run, size = [], 0
        run.append(t)
        size += t.numel()
    if run:
        yield run


def _flat_collective(tensors: list[torch.Tensor], op) -> None:
    """op(flat) on each bucket of `tensors` flattened, the result copied
    back into them."""
    for run in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in run])
        op(flat)
        torch._foreach_copy_(run, [x.view_as(t) for x, t in
                                   zip(flat.split([t.numel() for t in run]), run)])


@torch.no_grad()
def average_gradients(params: Iterable[torch.Tensor], group, divisor: int | None = None
                      ) -> None:
    """Replace each parameter's `.grad` by its sum over the group divided by
    `divisor` (default the group's size: the mean), one all-reduce a
    bucket; over a `(dp, sp)` grid's world with divisor dp, the sum over
    the height split of the mean over dp. Parameters without a gradient
    are skipped: every rank runs the same graph, so they are the same on
    every rank."""
    if group is None:
        return
    world = dist.get_world_size(group) if divisor is None else divisor

    def mean(flat):
        dist.all_reduce(flat, group=group)
        if world != 1:
            flat /= world

    _flat_collective([p.grad for p in params if p.grad is not None], mean)


@torch.no_grad()
def broadcast_parameters(module: nn.Module, group) -> None:
    """Every rank takes rank 0's parameters and buffers."""
    if group is None:
        return
    src = dist.get_global_rank(group, 0)
    _flat_collective([*module.parameters(), *module.buffers()],
                     lambda flat: dist.broadcast(flat, src, group=group))


def mean_over_group(values: torch.Tensor, group) -> torch.Tensor:
    """The mean of `values` over the group's ranks (for metrics)."""
    if group is None or dist.get_world_size(group) == 1:
        return values
    out = values.clone()
    dist.all_reduce(out, group=group)
    return out / dist.get_world_size(group)
