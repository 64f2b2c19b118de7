"""Shifted-window attention (SwinIR), over kernels K4 and K6.

Counterpart of `e4s2024_tpu/ops/window_attention.py`. Both kernels live in
`kernels/csrc/window_attention.cu` and share one attention core:

- K6, `fused_window_attention`, replaces the Pallas kernel of the same name:
  q, k, v already partitioned into windows, (BW, heads, n, hd).
- K4, `swin_attention_nhwc`, replaces `swin_attention_nhwc`: it reads the
  fused qkv projection in its own (B, H, W, 3C) layout and finds each
  window's tokens itself, so no partitioned copy is made.

Semantics of both (the JAX kernels'): `q * hd^-1/2` rounded to q's dtype,
scores accumulated in float32, plus the float32 relative-position bias,
minus 100 where two tokens' window-region labels differ, softmax in
float32, rounded to q's dtype before the product with v.
"""

from __future__ import annotations

import torch

from e4s2024_torch import kernels
from e4s2024_torch.kernels.build import library


def scale_for(head_dim: int, dtype: torch.dtype) -> float:
    """hd^-1/2 rounded to `dtype`, as the JAX kernels round it."""
    return float(torch.tensor(head_dim ** -0.5, dtype=dtype))


def window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor,
                           labels: torch.Tensor | None = None) -> torch.Tensor:
    """softmax(q * scale @ k^T + bias [- 100 where labels differ]) @ v.

    q, k, v: (BW, heads, n, hd); bias: (heads, n, n); labels: (BW, n) int
    or None. Returns (BW, heads, n, hd) in q's dtype (the counterpart of
    `reference_window_attention`, with the kernels' float32 accumulation)."""
    scale = scale_for(q.shape[-1], q.dtype)
    att = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    att = att + bias.float()[None]
    if labels is not None:
        neq = labels[:, :, None] != labels[:, None, :]
        att = torch.where(neq[:, None], att - 100.0, att)
    att = torch.softmax(att, dim=-1).to(q.dtype)
    return torch.matmul(att.float(), v.float()).to(q.dtype)


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, w^2, C), windows in row-major order."""
    b, h, ww, c = x.shape
    x = x.reshape(b, h // w, w, ww // w, w, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, c)


def window_reverse(x: torch.Tensor, w: int, h: int, ww: int) -> torch.Tensor:
    """(B * nW, w^2, C) -> (B, H, W, C)."""
    b = x.shape[0] // ((h // w) * (ww // w))
    x = x.reshape(b, h // w, ww // w, w, w, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, ww, -1)


def partition_qkv(qkv: torch.Tensor, window: int, heads: int):
    """(B, H, W, 3C) with channels [q|k|v] x head x hd -> q, k, v, each
    (B * nW, heads, window^2, hd) contiguous."""
    wins = window_partition(qkv, window)
    bw, n, c3 = wins.shape
    x = wins.reshape(bw, n, 3, heads, c3 // (3 * heads)).permute(2, 0, 3, 1, 4)
    return x[0].contiguous(), x[1].contiguous(), x[2].contiguous()


def merge_windows(out: torch.Tensor, batch: int, height: int, width: int,
                  window: int) -> torch.Tensor:
    """(B * nW, heads, window^2, hd) -> (B, H, W, heads * hd)."""
    bw, heads, n, hd = out.shape
    return window_reverse(out.transpose(1, 2).reshape(bw, n, heads * hd), window, height, width)


def tile_labels(labels: torch.Tensor, batch: int) -> torch.Tensor:
    """Window labels (nWy, nWx, n) or (nW, n) -> (B * nW, n) for B images."""
    flat = labels.reshape(-1, labels.shape[-1])
    return flat.repeat(batch, 1)


def swin_attention_nhwc_plain(qkv: torch.Tensor, bias: torch.Tensor,
                              labels: torch.Tensor | None = None, *, window: int,
                              heads: int) -> torch.Tensor:
    """Window attention over qkv (B, H, W, 3C) in place of the kernel's
    in-kernel partition: partition, attend, merge. labels: (H/w, W/w, n)
    or None. Returns (B, H, W, C)."""
    b, h, w, _ = qkv.shape
    q, k, v = partition_qkv(qkv, window, heads)
    lab = None if labels is None else tile_labels(labels, b)
    return merge_windows(window_attention_plain(q, k, v, bias, lab), b, h, w, window)


def _check_bias_labels(name: str, bias: torch.Tensor, labels, heads: int, n: int,
                       windows: int, device) -> None:
    if bias.shape != (heads, n, n) or bias.dtype != torch.float32 \
            or not bias.is_contiguous() or bias.device != device:
        raise ValueError(f"{name}: bias must be contiguous float32 ({heads}, {n}, {n}) "
                         f"on {device}, got {bias.dtype} {tuple(bias.shape)} on {bias.device}")
    if labels is not None and (labels.dtype != torch.int32 or not labels.is_contiguous()
                               or labels.numel() != windows * n or labels.device != device):
        raise ValueError(f"{name}: labels must be contiguous int32 with {windows} x {n} "
                         f"entries on {device}, got {labels.dtype} {tuple(labels.shape)}")


@kernels.counted("fused_window_attention")
def fused_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor,
                           labels: torch.Tensor | None = None) -> torch.Tensor:
    """Window attention over partitioned q, k, v (BW, heads, n, hd): the plain
    version on the CPU, kernel K6 on a CUDA device (q, k, v float32 or
    bfloat16; bias float32; labels (BW, n) int32 or None; n a multiple of 4
    up to 64; hd <= 64)."""
    if kernels.use_plain(q):
        return window_attention_plain(q, k, v, bias, labels)
    name = "fused_window_attention"
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q, k, v must be one (BW, heads, n, hd) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    bw, heads, n, hd = q.shape
    if not (4 <= n <= 64 and n % 4 == 0 and 1 <= hd <= 64):
        raise ValueError(f"{name}: needs n a multiple of 4 up to 64 and hd <= 64, "
                         f"got n={n}, hd={hd}")
    for arg, t in (("q", q), ("k", k), ("v", v)):
        kernels.check_input(name, arg, t, dtype=q.dtype)
    _check_bias_labels(name, bias, labels, heads, n, bw, q.device)
    out = torch.empty_like(q)
    status = library().e4s_window_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        None if labels is None else labels.data_ptr(), out.data_ptr(),
        kernels.DTYPE_CODES[q.dtype], bw, heads, n, hd, scale_for(hd, q.dtype),
        q.device.index, kernels.stream_of(q))
    kernels.check_status(name, status)
    fused_window_attention.launches += 1
    return out


@kernels.counted("swin_attention_nhwc")
def swin_attention_nhwc(qkv: torch.Tensor, bias: torch.Tensor,
                        labels: torch.Tensor | None = None, *, window: int,
                        heads: int) -> torch.Tensor:
    """Window attention over qkv in its (B, H, W, 3C) layout, channels
    [q|k|v] x head x hd: the plain version on the CPU, kernel K4 on a CUDA
    device. bias (heads, n, n) float32; labels (H/w, W/w, n) int32 of the
    (already rolled) image, or None. Returns (B, H, W, C)."""
    if kernels.use_plain(qkv):
        return swin_attention_nhwc_plain(qkv, bias, labels, window=window, heads=heads)
    name = "swin_attention_nhwc"
    if qkv.ndim != 4 or qkv.shape[3] % (3 * heads):
        raise ValueError(f"{name}: qkv must be (B, H, W, 3C) with C a multiple of "
                         f"heads={heads}, got {tuple(qkv.shape)}")
    b, h, w, c3 = qkv.shape
    c, n = c3 // 3, window * window
    if h % window or w % window or not (4 <= n <= 64 and n % 4 == 0) or c // heads > 64:
        raise ValueError(f"{name}: needs H, W multiples of window={window}, window^2 a "
                         f"multiple of 4 up to 64 and hd <= 64, got {tuple(qkv.shape)}")
    kernels.check_input(name, "qkv", qkv)
    _check_bias_labels(name, bias, labels, heads, n, (h // window) * (w // window), qkv.device)
    out = torch.empty((b, h, w, c), dtype=qkv.dtype, device=qkv.device)
    status = library().e4s_swin_attention_nhwc(
        qkv.data_ptr(), bias.data_ptr(), None if labels is None else labels.data_ptr(),
        out.data_ptr(), kernels.DTYPE_CODES[qkv.dtype], b, h, w, c, heads, window,
        scale_for(c // heads, qkv.dtype), qkv.device.index, kernels.stream_of(qkv))
    kernels.check_status(name, status)
    swin_attention_nhwc.launches += 1
    return out
