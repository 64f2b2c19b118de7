"""Image height split over ranks: the `sp` axis of the JAX package's
`(dp, sp)` mesh (`e4s2024_tpu/parallel/mesh.py::make_mesh_2d`), where GSPMD
partitions the step and inserts the halo exchanges. Here the nets call the
split-aware ops of this module (and the ops that use them) instead.

The split is ambient: `row_split(split)` makes it active for the code it
wraps, forward and backward alike (a module global, not a thread-local:
autograd runs a CUDA backward on a thread of its own). While it is active
every 4-D activation is a slab of rows: rank s of the split holds rows
[s H / n, (s + 1) H / n) of a height H that n divides, the whole width,
and only those rows. `suspended()` runs ops on a whole tensor (a window
that already carries its halo, or a gathered tensor).

The primitives are built on one collective, a differentiable all-reduce
(sum) over the split's group: gloo carries it on CUDA tensors as well as
NCCL does.

- `fetch(x, windows, extents)`: rows [lo, hi) of the global tensor, this
  rank's own rows taken locally, the rest from the ranks that own them
  (any of them, not only the neighbours), zeros outside [0, H). A halo
  exchange is a fetch of a few rows past each end of the slab.
- `all_reduce`: the sum over the split, for means and norms over H.
- `gather_rows`: the whole tensor on every rank.

**Loss convention.** Every loss and metric is the replicated whole: each
rank computes the same value from all-reduced sums or gathered tensors.
Each rank then runs its backward from 1/n of it (`share`). The
all-reduce's backward is the all-reduce of the incoming gradients, so a
replicated value's gradient summed over the n ranks comes back whole, and
each rank's parameter gradients are its rows' share: the trainer sums
them over the split (and averages over `dp`). Without the 1/n a gradient
through a replicated value is counted n times.

Every rank must run the same ops in the same order, since each fetch or
sum is a collective: the windows are computed from the split's shapes
alone, so a rank at the image's edge exchanges zeros rather than skipping
the call, and the autograd graphs of the ranks have one shape.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

Extents = Sequence[tuple[int, int]]


@dataclass(frozen=True)
class RowSplit:
    """This rank's place on the split: its group, the number of slabs and
    its index (the rank's position in the group)."""

    group: Any
    size: int
    index: int


_ACTIVE: RowSplit | None = None


@contextlib.contextmanager
def row_split(split: RowSplit | None):
    """Make `split` the active split for the enclosed code (a split of one
    slab, or None, makes none active)."""
    global _ACTIVE
    previous = _ACTIVE
    _ACTIVE = split if split is not None and split.size > 1 else None
    try:
        yield
    finally:
        _ACTIVE = previous


def suspended():
    """Run the enclosed ops on whole tensors, as without a split."""
    return row_split(None)


def active() -> RowSplit | None:
    return _ACTIVE


def parts() -> int:
    """The number of slabs of the active split; 1 without one."""
    return 1 if _ACTIVE is None else _ACTIVE.size


def local_rows(height: int) -> int:
    """This rank's rows of a global `height` (for callers that name a
    global size)."""
    n = parts()
    if height % n:
        raise ValueError(f"a height of {height} rows does not split over {n} ranks")
    return height // n


def even_extents(rows: int, n: int | None = None) -> list[tuple[int, int]]:
    """Every rank's rows [r0, r1) of an evenly split tensor whose slabs
    hold `rows` rows."""
    n = parts() if n is None else n
    return [(s * rows, (s + 1) * rows) for s in range(n)]


def share(loss: torch.Tensor) -> torch.Tensor:
    """This rank's share of a replicated loss: the value to run the
    backward from (see the module docstring)."""
    n = parts()
    return loss if n == 1 else loss / n


# ---------------------------------------------------------------- collectives


class _AllReduce(torch.autograd.Function):
    """The sum over a group; its gradient is the sum over the group of the
    incoming gradients, itself through this Function, so it is
    differentiable to any order (R1's double backward)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduce.apply(grad, ctx.group), None


def all_reduce(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the ranks of the active split, on every rank;
    differentiable (its backward sums the ranks' gradients). `x` itself
    without a split."""
    return x if _ACTIVE is None else _AllReduce.apply(x, _ACTIVE.group)


def all_reduce_group(x: torch.Tensor, group) -> torch.Tensor:
    """`all_reduce` over any process group (the `dp` axis, say)."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _AllReduce.apply(x, group)


def mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of every element of a split tensor (replicated)."""
    n = parts()
    if n == 1:
        return x.mean()
    return all_reduce(x.sum()) / (x.numel() * n)


def fetch(x: torch.Tensor, windows: Sequence[tuple[int, int]], extents: Extents
          ) -> torch.Tensor:
    """Rows [lo, hi) of the global tensor, on each rank its own window
    (`windows[s]` for rank s; every rank is given all of them), along the
    second-last axis: x holds rows `extents[s]` of it. Rows outside every
    extent (past either end) are zeros. The rows a window takes from other
    ranks travel in one all-reduce, skipped when no window leaves its own
    extent. Differentiable: a fetched row's gradient returns to its
    owner."""
    split = _ACTIVE
    s = split.index
    r0, r1 = extents[s]
    # every requester's rows above and below its own extent
    needs = [[(lo, min(e0, hi)), (max(e1, lo), hi)]
             for (lo, hi), (e0, e1) in zip(windows, extents)]
    lo, hi = windows[s]
    own = x.narrow(-2, min(max(lo, r0), r1) - r0,
                   max(min(hi, r1) - max(lo, r0), 0))
    if all(b <= a for pair in needs for a, b in pair):
        return own.contiguous()
    pieces, mine = [], []
    for req, pair in enumerate(needs):
        for a, b in pair:
            if b <= a:
                continue
            c, d = max(a, r0), min(b, r1)
            if d > c:
                piece = x.narrow(-2, c - r0, d - c)
                top, bottom = c - a, b - d
            else:
                piece = x.narrow(-2, 0, 0)
                top, bottom = b - a, 0
            if req == s:
                mine.append((sum(p.shape[-2] for p in pieces), b - a))
            pieces.append(F.pad(piece, (0, 0, top, bottom)))
    buf = all_reduce(torch.cat(pieces, dim=-2))
    above, below = needs[s]
    # a rank that takes no row keeps an empty slice of the sum, so that its
    # graph reaches the all-reduce and its backward joins the others'
    out = [] if mine else [buf.narrow(-2, 0, 0)]
    slots = iter(mine)
    if above[1] > above[0]:
        off, n = next(slots)
        out.append(buf.narrow(-2, off, n))
    out.append(own)
    if below[1] > below[0]:
        off, n = next(slots)
        out.append(buf.narrow(-2, off, n))
    return torch.cat(out, dim=-2)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The whole tensor on every rank (evenly split slabs), differentiable:
    each rank's rows get the sum of the ranks' gradients. `x` itself
    without a split."""
    split = _ACTIVE
    if split is None:
        return x
    ext = even_extents(x.shape[-2], split.size)
    whole = (0, ext[-1][1])
    return fetch(x, [whole] * split.size, ext)


def own_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's slab of a whole (replicated) tensor."""
    split = _ACTIVE
    if split is None:
        return x
    h = local_rows(x.shape[-2])
    return x.narrow(-2, split.index * h, h)


# ---------------------------------------------------------------- row windows


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _owned(extents: Extents, out_rows: int, stride: int) -> list[tuple[int, int]]:
    """The output rows each rank owns: output row o belongs to the rank
    whose input extent holds row o * stride (the first and last rank take
    any rows past the ends)."""
    n = len(extents)
    owned = []
    for s, (r0, r1) in enumerate(extents):
        o0 = 0 if s == 0 else min(_ceil_div(r0, stride), out_rows)
        o1 = out_rows if s == n - 1 else min(_ceil_div(r1, stride), out_rows)
        owned.append((o0, max(o1, o0)))
    return owned


def window_op(x: torch.Tensor, fn: Callable[[torch.Tensor], torch.Tensor], kernel: int,
              stride: int, pad: tuple[int, int], extents: Extents | None = None):
    """A windowed op along rows (a convolution or pool with `kernel` rows,
    `stride` and row pads `pad`) on a split tensor: each rank fetches the
    input rows its output rows read and runs `fn` on them with no row
    padding (`fn` pads only the columns). Returns the output slab; with
    explicit `extents` (uneven slabs) returns (slab, output extents), else
    an output that does not split evenly raises. A rank that owns no
    output row runs `fn` on one row's window and keeps none of it, so that
    the ranks' graphs match."""
    split = _ACTIVE
    even = extents is None
    if even:
        extents = even_extents(x.shape[-2], split.size)
    height = extents[-1][1]
    out_rows = (height + pad[0] + pad[1] - kernel) // stride + 1
    owned = _owned(extents, out_rows, stride)
    windows = [(o0 * stride - pad[0], (max(o1, o0 + 1) - 1) * stride - pad[0] + kernel)
               for o0, o1 in owned]
    xw = fetch(x, windows, extents)
    with suspended():
        y = fn(xw)
    o0, o1 = owned[split.index]
    y = y.narrow(-2, 0, o1 - o0)
    if not even:
        return y, owned
    if any(b - a != o1 - o0 for a, b in owned):
        raise ValueError(f"{out_rows} output rows do not split over {split.size} ranks")
    return y


def halo_op(x: torch.Tensor, fn: Callable[[torch.Tensor], torch.Tensor],
            span: Callable[[int, int], tuple[int, int, int]], out_rows: int) -> torch.Tensor:
    """An op whose output slab reads a window of input rows that
    `span(R0, R1)` names for output rows [R0, R1): (lo, hi, start), the
    window [lo, hi) and the first kept row of fn(window). The output of
    `out_rows` global rows splits evenly; each rank keeps its rows."""
    split = _ACTIVE
    n = split.size
    if out_rows % n:
        raise ValueError(f"{out_rows} output rows do not split over {n} ranks")
    per = out_rows // n
    spans = [span(s * per, (s + 1) * per) for s in range(n)]
    xw = fetch(x, [(lo, hi) for lo, hi, _ in spans], even_extents(x.shape[-2], n))
    with suspended():
        y = fn(xw)
    return y.narrow(-2, spans[split.index][2], per)


# ---------------------------------------------------------------- split-aware ops


def _pair(v) -> int:
    if isinstance(v, (tuple, list)):
        if v[0] != v[-1]:
            raise ValueError(f"rows and columns take one value here, got {tuple(v)}")
        return int(v[0])
    return int(v)


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
           stride=1, padding=0) -> torch.Tensor:
    """`F.conv2d` (zero padding) on a split tensor: the halo rows its
    kernel reads come from the neighbours (none for a 1x1 kernel at stride
    1). `F.conv2d` itself without a split."""
    s, p, k = _pair(stride), _pair(padding), weight.shape[-2]
    if _ACTIVE is None or (k == 1 and s == 1 and p == 0):
        return F.conv2d(x, weight, bias, stride=stride, padding=padding)
    return window_op(x, lambda w: F.conv2d(w, weight, bias, stride=s, padding=(0, p)),
                     k, s, (p, p))


def conv2d_rows(x, weight, bias, stride, padding, extents: Extents):
    """`conv2d` on uneven slabs: returns (slab, output extents)."""
    s, p, k = _pair(stride), _pair(padding), weight.shape[-2]
    return window_op(x, lambda w: F.conv2d(w, weight, bias, stride=s, padding=(0, p)),
                     k, s, (p, p), extents)


def max_pool2d(x: torch.Tensor, kernel: int, stride: int | None = None,
               extents: Extents | None = None):
    """`F.max_pool2d` without padding on a split tensor (with `extents`:
    uneven slabs, returns (slab, output extents))."""
    stride = kernel if stride is None else stride
    if _ACTIVE is None:
        return F.max_pool2d(x, kernel, stride)
    return window_op(x, lambda w: F.max_pool2d(w, kernel, stride), kernel, stride, (0, 0),
                     extents)


def upfirdn_rows(x: torch.Tensor, fn: Callable[[torch.Tensor], torch.Tensor], taps: int,
                 up: int, down: int, pad: tuple[int, int]) -> torch.Tensor:
    """upfirdn2d (`fn` of a window, with its own pads on both axes) on a
    split tensor. Output row J reads zero-stuffed rows J down - pad0 + t;
    each rank fetches the input rows its output rows read, runs `fn` on
    that window (its row pads land on rows the window already holds, or
    on the outer zeros) and keeps its rows."""
    h = x.shape[-2]
    height = h * _ACTIVE.size
    out_rows = (height * up + pad[0] + pad[1] - taps) // down + 1

    def span(r0, r1):
        lo = (r0 * down - pad[0]) // up
        if (lo * up) % down:
            lo -= 1
        hi = ((r1 - 1) * down - pad[0] + taps - 1) // up + 1
        start = r0 - lo * up // down
        while ((hi - lo) * up + pad[0] + pad[1] - taps) // down + 1 < start + r1 - r0:
            hi += 1
        return lo, hi, start

    return halo_op(x, fn, span, out_rows)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm (no affine) of a split tensor: the mean, then the
    variance about it, each a sum over the split (two passes, as exact as
    the whole tensor's)."""
    count = x.shape[-2] * x.shape[-1] * parts()
    mu = all_reduce(x.sum(dim=(2, 3), keepdim=True)) / count
    centred = x - mu
    var = all_reduce(centred.square().sum(dim=(2, 3), keepdim=True)) / count
    return centred * torch.rsqrt(var + eps)


def spatial_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over H and W of a split NCHW tensor, (N, C, 1, 1)."""
    n = parts()
    if n == 1:
        return x.mean(dim=(2, 3), keepdim=True)
    return all_reduce(x.sum(dim=(2, 3), keepdim=True)) / (x.shape[-2] * x.shape[-1] * n)


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` (zero padding) that runs `conv2d` under a split."""

    def forward(self, x):
        if _ACTIVE is None:
            return super().forward(x)
        return conv2d(x, self.weight, self.bias, self.stride, self.padding)


class MaxPool2d(nn.MaxPool2d):
    """`nn.MaxPool2d` without padding that runs `max_pool2d` under a split."""

    def forward(self, x):
        if _ACTIVE is None:
            return super().forward(x)
        if _pair(self.padding) or _pair(self.dilation) != 1 or self.ceil_mode:
            raise NotImplementedError("a split max pool takes no padding, dilation or ceil mode")
        return max_pool2d(x, _pair(self.kernel_size), _pair(self.stride))
