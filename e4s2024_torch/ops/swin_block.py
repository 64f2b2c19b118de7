"""One whole Swin transformer block, over kernel K5.

Counterpart of `e4s2024_tpu/ops/swin_block.py`; the kernel
(`kernels/csrc/swin_block.cu`) replaces its Pallas `fused_swin_block`:
LN1 -> qkv -> shifted-window attention -> proj -> residual -> LN2 -> fc1 ->
erf-GELU -> fc2 -> residual over (B, H, W, C), with the JAX kernel's
rounding (LN statistics in float32 in one pass, E[x^2] - mu^2 with eps
1e-5; every product accumulated in float32 and rounded to x's dtype before
its bias is added; softmax in float32).

Callers roll x by -shift before a shifted block and +shift after it, and
pass the shifted image's window-region labels: the shift commutes with every
per-token step, so only the attention mask differs.

The weights are a dict with the JAX function's keys and layouts
(`block_weights` builds it once per block): ln1_scale, ln1_bias, ln2_scale,
ln2_bias (C,) and bias_hnn (heads, n, n) in float32; qkv_w (C, 3C) with
columns [q|k|v] x head x hd, qkv_b (3C,), proj_w (C, C), proj_b (C,),
fc1_w (C, Cm), fc1_b (Cm,), fc2_w (Cm, C), fc2_b (C,) in x's dtype.
"""

from __future__ import annotations

import torch

from e4s2024_torch import kernels
from e4s2024_torch.kernels.build import library
from e4s2024_torch.ops.window_attention import scale_for, swin_attention_nhwc_plain

EPS = 1e-5
F32_KEYS = ("ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias", "bias_hnn")
ORDER = ("ln1_scale", "ln1_bias", "qkv_w", "qkv_b", "proj_w", "proj_b", "bias_hnn",
         "ln2_scale", "ln2_bias", "fc1_w", "fc1_b", "fc2_w", "fc2_b")


def block_weights(ln1: torch.nn.LayerNorm, qkv: torch.nn.Linear, proj: torch.nn.Linear,
                  bias_hnn: torch.Tensor, ln2: torch.nn.LayerNorm, fc1: torch.nn.Linear,
                  fc2: torch.nn.Linear, dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """The weight dict K5 takes, from a block's modules (the counterpart of
    `_block_weights`): Linear weights transposed to (in, out), everything
    contiguous, in the types the kernel reads."""
    def lin(m):
        return (m.weight.detach().t().to(dtype).contiguous(),
                m.bias.detach().to(dtype).contiguous())

    def f32(t):
        return t.detach().float().contiguous()

    wts = {"ln1_scale": f32(ln1.weight), "ln1_bias": f32(ln1.bias),
           "ln2_scale": f32(ln2.weight), "ln2_bias": f32(ln2.bias),
           "bias_hnn": f32(bias_hnn)}
    for key, m in (("qkv", qkv), ("proj", proj), ("fc1", fc1), ("fc2", fc2)):
        wts[f"{key}_w"], wts[f"{key}_b"] = lin(m)
    return wts


def _layer_norm(v: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    vf = v.float()
    mu = vf.mean(-1, keepdim=True)
    var = (vf * vf).mean(-1, keepdim=True) - mu * mu
    return ((vf - mu) * torch.rsqrt(var + EPS) * scale.float() + shift.float()).to(v.dtype)


def _dense(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """v @ w accumulated in float32, rounded to v's dtype."""
    return torch.matmul(v.float(), w.float()).to(v.dtype)


def fused_swin_block_plain(x: torch.Tensor, wts: dict, labels: torch.Tensor | None = None,
                           *, window: int, heads: int) -> torch.Tensor:
    """The whole block as plain tensor operations with K5's rounding.
    x: (B, H, W, C); labels: (H/w, W/w, n) or None."""
    cd = x.dtype
    qkv = _dense(_layer_norm(x, wts["ln1_scale"], wts["ln1_bias"]), wts["qkv_w"])
    qkv = qkv + wts["qkv_b"].to(cd)
    attn = swin_attention_nhwc_plain(qkv, wts["bias_hnn"], labels, window=window, heads=heads)
    y = x + _dense(attn, wts["proj_w"]) + wts["proj_b"].to(cd)
    h1 = torch.matmul(_layer_norm(y, wts["ln2_scale"], wts["ln2_bias"]).float(),
                      wts["fc1_w"].float())
    h1 = torch.nn.functional.gelu(h1 + wts["fc1_b"].to(cd).float()).to(cd)
    return y + _dense(h1, wts["fc2_w"]) + wts["fc2_b"].to(cd)


def widths_ok(channels: int, heads: int, window: int) -> bool:
    """Whether K5's tiles cover these widths (swin_block.cu widths_ok): with
    8 x 8 windows, C <= 192."""
    n = window * window
    wide, narrow = -(-channels // 12), -(-3 * (channels // heads) // 6)
    return (n // 4) * wide <= 512 and wide * 12 <= 192 and (n // 4) * narrow <= 512 \
        and narrow * 6 <= 192


@kernels.counted("fused_swin_block")
def fused_swin_block(x: torch.Tensor, wts: dict, labels: torch.Tensor | None = None,
                     *, window: int, heads: int) -> torch.Tensor:
    """One whole Swin block over x (B, H, W, C): the plain version on the CPU,
    kernel K5 on a CUDA device. `wts` as `block_weights` makes it for x's
    dtype; labels (H/w, W/w, n) int32 or None. Returns (B, H, W, C)."""
    if kernels.use_plain(x):
        return fused_swin_block_plain(x, wts, labels, window=window, heads=heads)
    name = "fused_swin_block"
    if x.ndim != 4:
        raise ValueError(f"{name}: x must be (B, H, W, C), got {tuple(x.shape)}")
    b, h, w, c = x.shape
    n = window * window
    hidden = wts["fc1_w"].shape[-1]
    if c % heads or h % window or w % window or not (4 <= n <= 64 and n % 4 == 0) \
            or not widths_ok(c, heads, window):
        raise ValueError(f"{name}: needs C a multiple of heads={heads}, H, W multiples of "
                         f"window={window}, window^2 a multiple of 4 up to 64, hd <= 64 and "
                         f"with 8 x 8 windows C <= 192; got {tuple(x.shape)}")
    shapes = {"ln1_scale": (c,), "ln1_bias": (c,), "qkv_w": (c, 3 * c), "qkv_b": (3 * c,),
              "proj_w": (c, c), "proj_b": (c,), "bias_hnn": (heads, n, n),
              "ln2_scale": (c,), "ln2_bias": (c,), "fc1_w": (c, hidden), "fc1_b": (hidden,),
              "fc2_w": (hidden, c), "fc2_b": (c,)}
    kernels.check_input(name, "x", x)
    for key in ORDER:
        t = wts[key]
        kernels.check_input(name, key, t, dtype=torch.float32 if key in F32_KEYS else x.dtype)
        if t.shape != shapes[key] or t.device != x.device:
            raise ValueError(f"{name}: {key} must be {shapes[key]} on {x.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    if labels is not None and (labels.dtype != torch.int32 or not labels.is_contiguous()
                               or labels.numel() != (h // window) * (w // window) * n
                               or labels.device != x.device):
        raise ValueError(f"{name}: labels must be contiguous int32 "
                         f"({h // window}, {w // window}, {n}) on {x.device}")
    out = torch.empty_like(x)
    status = library().e4s_swin_block(
        x.data_ptr(), *(wts[key].data_ptr() for key in ORDER[:7]),
        None if labels is None else labels.data_ptr(),
        *(wts[key].data_ptr() for key in ORDER[7:]), out.data_ptr(),
        kernels.DTYPE_CODES[x.dtype], b, h, w, c, heads, hidden, window,
        scale_for(c // heads, x.dtype), EPS, x.device.index, kernels.stream_of(x))
    kernels.check_status(name, status)
    fused_swin_block.launches += 1
    return out
