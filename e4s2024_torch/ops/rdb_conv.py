"""A 3 x 3 float32 convolution into a channel slice of an NHWC buffer, with
its epilogue fused, over kernel K7 (`kernels/csrc/rdb_conv.cu`).

One call computes

    v = conv3x3(x[..., :cin] (nearest x2 upsampled if fold == 2), weight) + bias
    v = leaky_relu(v, 0.2)          if act
    v = res1[..., :n] + s1 * v      if res1 is given
    v = res2[..., :n] + s2 * v      if res2 is given
    out[..., out_off:out_off + n] = v

with x, out and the residuals (B, H, W, C) float32 (out and the residuals
at fold x x's height and width), stride 1, padding 1. RRDBNet's dense blocks
(`models/rrdb.py`) run on it: conv i of a block reads the first channels of
the block's buffer and writes its new ones beside them, so the block makes
no `torch.cat`. The JAX package has no such kernel (XLA runs RealESRGAN's
convolutions), so the plain version here is the oracle: `F.conv2d` in full
float32 and the same epilogue in the same order.

The kernel does its products as error-compensated tf32 (3xTF32). The
weights' halves are split once, on the host: `pack_weights` rounds each
weight to tf32 (hi) and the rest to tf32 (lo), and lays both out as the
kernel streams them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from e4s2024_torch import kernels
from e4s2024_torch.kernels.build import library
from e4s2024_torch.ops.resize import resize_nearest

CHUNK = 32          # input channels of one weight slab of the kernel
OUTPUTS = (32, 64)  # the output widths the kernel has instances for
TF32_DROP = 13      # float32 mantissa bits that tf32 does not keep


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 `t` rounded to tf32 (10 mantissa bits), to nearest with ties
    to even, still as float32 (for finite values below 2^127)."""
    bits = t.float().contiguous().view(torch.int32)
    keep = (bits >> TF32_DROP) & 1
    rounded = (bits + ((1 << (TF32_DROP - 1)) - 1) + keep) & -(1 << TF32_DROP)
    return rounded.view(torch.float32)


def split_tf32(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) with hi = tf32(w) and lo = tf32(w - hi): hi + lo is within
    2^-22 of |w|, and the tensor cores read both without loss."""
    hi = round_tf32(w)
    return hi, round_tf32(w.float() - hi)


def k_order() -> torch.Tensor:
    """The input channel at each of a chunk's 32 k positions, as the kernel
    reads them: position 8 ks + j of k step ks holds channel
    8 (j % 4) + 2 ks + j // 4, so that one 16-byte load of a thread feeds
    two k steps."""
    kk = torch.arange(CHUNK)
    ks, j = kk // 8, kk % 8
    return 8 * (j % 4) + 2 * ks + j // 4


def pack_weights(weight: torch.Tensor) -> torch.Tensor:
    """(n, cin, 3, 3) float32 -> (cin / 32 * 9, 2, n / 8, 8, 8, 4): one slab
    per (chunk of 32 input channels, tap dy * 3 + dx) in the order the
    kernel consumes them; in each slab the hi and then the lo half, each in
    the 8 x 16-byte core matrices wgmma reads (output group n // 8, k core
    of 4 positions, output n % 8, position % 4), positions in `k_order`."""
    n, cin = weight.shape[:2]
    if weight.shape[2:] != (3, 3) or n not in OUTPUTS or cin % CHUNK:
        raise ValueError(f"pack_weights: needs (n, cin, 3, 3) with n in {OUTPUTS} and cin "
                         f"a multiple of {CHUNK}, got {tuple(weight.shape)}")
    order = k_order().to(weight.device)
    halves = []
    for half in split_tf32(weight):
        t = half.reshape(n, cin // CHUNK, CHUNK, 9).permute(1, 3, 0, 2)[..., order]
        t = t.reshape(cin // CHUNK, 9, n // 8, 8, CHUNK // 4, 4).permute(0, 1, 2, 4, 3, 5)
        halves.append(t)
    return torch.stack(halves, 2).reshape(cin // CHUNK * 9, 2, n // 8, 8, 8, 4).contiguous()


def rdb_conv_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   out: torch.Tensor, out_off: int = 0, *, fold: int = 1, act: bool = False,
                   res1: torch.Tensor | None = None, s1: float = 1.0,
                   res2: torch.Tensor | None = None, s2: float = 1.0) -> torch.Tensor:
    """One K7 launch as plain tensor operations (see the module's note);
    writes out's channel slice and returns out."""
    n, cin = weight.shape[:2]
    xin = x[..., :cin].permute(0, 3, 1, 2)
    if fold == 2:
        xin = resize_nearest(xin, (2 * xin.shape[2], 2 * xin.shape[3]))
    v = F.conv2d(xin, weight, bias, padding=1).permute(0, 2, 3, 1)
    if act:
        v = F.leaky_relu(v, 0.2)
    if res1 is not None:
        v = res1[..., :n] + s1 * v
    if res2 is not None:
        v = res2[..., :n] + s2 * v
    out[..., out_off:out_off + n] = v
    return out


@kernels.counted("rdb_conv")
def rdb_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, out: torch.Tensor,
             out_off: int = 0, *, packed: torch.Tensor | None = None, fold: int = 1,
             act: bool = False, res1: torch.Tensor | None = None, s1: float = 1.0,
             res2: torch.Tensor | None = None, s2: float = 1.0) -> torch.Tensor:
    """`rdb_conv_plain` on the CPU, kernel K7 on a CUDA device, where
    `packed` must be `pack_weights(weight)` on x's device. The output slice
    may lie in x's own buffer beside the channels read; res2 may be out
    itself (each pixel is read before it is written)."""
    if kernels.use_plain(x):
        return rdb_conv_plain(x, weight, bias, out, out_off, fold=fold, act=act, res1=res1,
                              s1=s1, res2=res2, s2=s2)
    name = "rdb_conv"
    n, cin = weight.shape[:2]
    if x.ndim != 4 or out.ndim != 4 or fold not in (1, 2):
        raise ValueError(f"{name}: x and out must be (B, H, W, C) and fold 1 or 2")
    b, h, w, c_in = x.shape
    big = (b, fold * h, fold * w)
    if out.shape[:3] != big or not 0 <= out_off <= out.shape[3] - n or out_off % 2 \
            or out.shape[3] % 2 or c_in % 4 or cin > c_in:
        raise ValueError(f"{name}: x {tuple(x.shape)} and out {tuple(out.shape)} at offset "
                         f"{out_off} do not fit a conv of {cin} -> {n} channels at fold {fold}")
    if out.data_ptr() == x.data_ptr() and out_off < cin:
        raise ValueError(f"{name}: the output slice overlaps the channels read")
    for arg, t in (("x", x), ("out", out), ("bias", bias), ("packed", packed),
                   ("res1", res1), ("res2", res2)):
        if t is None and arg in ("x", "out", "bias", "packed"):
            raise ValueError(f"{name}: on a card `packed` must hold pack_weights(weight)")
        if t is None:
            continue
        kernels.check_input(name, arg, t, dtype=torch.float32)
        if t.device != x.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, x on {x.device}")
    if packed.shape != (cin // CHUNK * 9, 2, n // 8, 8, 8, 4) or bias.shape != (n,):
        raise ValueError(f"{name}: packed {tuple(packed.shape)} / bias {tuple(bias.shape)} "
                         f"were not made for {cin} -> {n} channels")
    for arg, t in (("res1", res1), ("res2", res2)):
        if t is not None and (t.shape[:3] != big or t.shape[3] < n or t.shape[3] % 2):
            raise ValueError(f"{name}: {arg} {tuple(t.shape)} does not fit out")
    status = library().e4s_rdb_conv(
        x.data_ptr(), packed.data_ptr(), bias.data_ptr(), out.data_ptr(),
        None if res1 is None else res1.data_ptr(), None if res2 is None else res2.data_ptr(),
        b, h, w, c_in, cin, n, fold, out.shape[3], out_off, int(act),
        0 if res1 is None else res1.shape[3], s1, 0 if res2 is None else res2.shape[3], s2,
        x.device.index, kernels.stream_of(x))
    kernels.check_status(name, status)
    rdb_conv.launches += 1
    return out
