"""One whole Swin transformer block, over kernel K5.

Counterpart of `e4s2024_tpu/ops/swin_block.py`; the kernel
(`kernels/csrc/swin_block.cu`) replaces its Pallas `fused_swin_block`:
LN1 -> qkv -> shifted-window attention -> proj -> residual -> LN2 -> fc1 ->
erf-GELU -> fc2 -> residual over (B, H, W, C), with the JAX kernel's
rounding (LN statistics in float32 in one pass, E[x^2] - mu^2 with eps
1e-5; every product accumulated in float32 and rounded to x's dtype before
its bias is added; softmax in float32).

A shifted block passes the shifted image's window-region labels and either
rolls x by -shift before and +shift after the call, as the JAX callers do,
or hands `shift` to the function, which then does both rolls itself (the
kernel in its addressing): the shift commutes with every per-token step, so
only the attention mask differs.

The weights are a dict with the JAX function's keys and layouts
(`block_weights` builds it once per block): ln1_scale, ln1_bias, ln2_scale,
ln2_bias (C,) and bias_hnn (heads, n, n) in float32; qkv_w (C, 3C) with
columns [q|k|v] x head x hd, qkv_b (3C,), proj_w (C, C), proj_b (C,),
fc1_w (C, Cm), fc1_b (Cm,), fc2_w (Cm, C), fc2_b (C,) in x's dtype. The
kernel reads them in the layout of `pack_block_weights`, whose result the
caller keeps in the dict under "packed" (`SwinIR.fused_weights` does so once
per block); the wrapper packs nothing and refuses a dict without it on a card.
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
                           *, window: int, heads: int, shift: int = 0) -> torch.Tensor:
    """The whole block as plain tensor operations with K5's rounding.
    x: (B, H, W, C); labels: (H/w, W/w, n) or None; with `shift`, x is rolled
    by -shift before the block and the result by +shift after it."""
    if shift:
        rolled = torch.roll(x, (-shift, -shift), dims=(1, 2))
        out = fused_swin_block_plain(rolled, wts, labels, window=window, heads=heads)
        return torch.roll(out, (shift, shift), dims=(1, 2))
    cd = x.dtype
    qkv = _dense(_layer_norm(x, wts["ln1_scale"], wts["ln1_bias"]), wts["qkv_w"])
    qkv = qkv + wts["qkv_b"].to(cd)
    attn = swin_attention_nhwc_plain(qkv, wts["bias_hnn"], labels, window=window, heads=heads)
    y = x + _dense(attn, wts["proj_w"]) + wts["proj_b"].to(cd)
    h1 = torch.matmul(_layer_norm(y, wts["ln2_scale"], wts["ln2_bias"]).float(),
                      wts["fc1_w"].float())
    h1 = torch.nn.functional.gelu(h1 + wts["fc1_b"].to(cd).float()).to(cd)
    return y + _dense(h1, wts["fc2_w"]) + wts["fc2_b"].to(cd)


TILE = 192      # output columns of every product of the kernel
HEAD_DIM = 32   # a head's q, k and v are padded to this


SLAB_BYTES = 64  # bytes of k in one row of a slab of the kernel's weight stream
CORE_BYTES = 16  # bytes of k in one row of the 8-row core matrices wgmma reads


def slab_depth(dtype: torch.dtype) -> int:
    """k per slab of the kernel's weight stream: 32 in bfloat16, 16 in float32."""
    return SLAB_BYTES // torch.empty((), dtype=dtype).element_size()


def widths_ok(channels: int, heads: int, hidden: int, window: int) -> bool:
    """Whether K5's 64 x 192 tiles cover these widths (the checks of
    swin_block.cu's e4s_swin_block): a window of at most 64 tokens,
    C <= 192, head_dim <= 32, hidden <= 384."""
    return (1 <= window * window <= 64 and 0 < channels <= TILE and channels % heads == 0
            and channels // heads <= HEAD_DIM and 0 < hidden <= 2 * TILE)


def _slabs(wt: torch.Tensor, depth: int) -> torch.Tensor:
    """(TILE, K) with K a multiple of `depth` -> (K / depth, TILE * depth):
    each slab as the tensor cores read it from shared memory, in core
    matrices of 8 columns by 16 bytes of k, those next to each other along k
    and then along the 24 groups of 8 columns."""
    core = CORE_BYTES // wt.element_size()
    cut = wt.reshape(TILE // 8, 8, -1, depth // core, core)  # (group, row, slab, kg, k)
    return cut.permute(2, 0, 3, 1, 4).reshape(-1, TILE * depth)


def pack_block_weights(wts: dict, heads: int) -> dict:
    """The block's weights as kernel K5 streams them.

    Every product of the kernel is 64 x 192 x K, with its weights stored
    (192 output columns, K) and cut along K into slabs of `slab_depth`
    columns (each laid out as `_slabs` says), zero-padded: q, k and v of each pair of heads (column
    head * 96 + part * 32 + d, head_dim padded to 32, a missing second head
    zero), proj, each 192 hidden units of fc1, and fc2 (K = hidden). "slabs"
    is their concatenation in the order the kernel consumes them, in the
    weights' dtype; "vec" holds, in float32 and each padded to 192, the LN
    scales and biases, proj_b, fc2_b, then each pair's qkv bias in the same
    column order and each 192 units of fc1_b."""
    qkv_w = wts["qkv_w"]
    dtype, dev = qkv_w.dtype, qkv_w.device
    c, hidden = wts["fc1_w"].shape
    hd, depth = c // heads, slab_depth(dtype)
    if not widths_ok(c, heads, hidden, 1):
        raise ValueError(f"pack_block_weights: needs C <= {TILE}, head_dim <= {HEAD_DIM} and "
                         f"hidden <= {2 * TILE}, got C={c}, heads={heads}, hidden={hidden}")
    pairs, chunks = -(-heads // 2), -(-hidden // TILE)
    kc, kf = -(-c // depth) * depth, -(-hidden // depth) * depth

    def padded(src: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
        out = torch.zeros(rows, cols, dtype=src.dtype, device=dev)
        out[:src.shape[0], :src.shape[1]] = src
        return out

    def by_pairs(t: torch.Tensor) -> torch.Tensor:
        """(3, heads, hd, ...) -> (pairs, 2 * 3 * HEAD_DIM, ...), zero-padded."""
        full = torch.zeros(3, 2 * pairs, HEAD_DIM, *t.shape[3:], dtype=t.dtype, device=dev)
        full[:, :heads, :hd] = t
        full = full.reshape(3, pairs, 2, HEAD_DIM, *t.shape[3:])
        return full.transpose(0, 1).transpose(1, 2).reshape(pairs, TILE, *t.shape[3:])

    qkv = by_pairs(padded(qkv_w.t(), 3 * c, kc).reshape(3, heads, hd, kc))
    mats = [*qkv, padded(wts["proj_w"].t(), TILE, kc),
            *padded(wts["fc1_w"].t(), chunks * TILE, kc).reshape(chunks, TILE, kc),
            padded(wts["fc2_w"].t(), TILE, kf)]
    slabs = torch.cat([_slabs(m, depth) for m in mats]).contiguous()

    def vec(t: torch.Tensor, n: int = TILE) -> torch.Tensor:
        return padded(t.float()[None], 1, n)[0]

    vecs = [vec(wts[k]) for k in ("ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias", "proj_b",
                                  "fc2_b")]
    vecs += [by_pairs(wts["qkv_b"].float().reshape(3, heads, hd)).reshape(-1),
             vec(wts["fc1_b"], chunks * TILE)]
    return {"slabs": slabs, "vec": torch.cat(vecs).contiguous(),
            "bias_hnn": wts["bias_hnn"], "dims": (c, heads, hidden)}


@kernels.counted("fused_swin_block")
def fused_swin_block(x: torch.Tensor, wts: dict, labels: torch.Tensor | None = None,
                     *, window: int, heads: int, shift: int = 0) -> torch.Tensor:
    """One whole Swin block over x (B, H, W, C): the plain version on the CPU,
    kernel K5 on a CUDA device. `wts` as `block_weights` makes it for x's
    dtype, on a card with `pack_block_weights(wts, heads)` under "packed";
    labels (H/w, W/w, n) int32 or None. With `shift` in [0, min(H, W)) token
    (y, x) of a window is pixel ((y + shift) mod H, (x + shift) mod W): the
    roll by -shift before the block and by +shift after it. Returns
    (B, H, W, C)."""
    if kernels.use_plain(x):
        return fused_swin_block_plain(x, wts, labels, window=window, heads=heads, shift=shift)
    name = "fused_swin_block"
    if x.ndim != 4:
        raise ValueError(f"{name}: x must be (B, H, W, C), got {tuple(x.shape)}")
    b, h, w, c = x.shape
    n = window * window
    hidden = wts["fc1_w"].shape[-1]
    if h % window or w % window or not widths_ok(c, heads, hidden, window) \
            or not 0 <= shift < max(min(h, w), 1):
        raise ValueError(f"{name}: needs H, W multiples of window={window}, window^2 <= 64, "
                         f"C <= {TILE} and a multiple of heads={heads}, head_dim <= {HEAD_DIM}, "
                         f"hidden <= {2 * TILE} and 0 <= shift < min(H, W); got "
                         f"{tuple(x.shape)}, hidden={hidden}, shift={shift}")
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
    packed = wts.get("packed")
    if packed is None:
        raise ValueError(f"{name}: on a card wts[\"packed\"] must hold "
                         f"pack_block_weights(wts, heads)")
    if packed["dims"] != (c, heads, hidden) or packed["slabs"].dtype != x.dtype \
            or packed["slabs"].device != x.device:
        raise ValueError(f"{name}: the packed weights were made for {packed['dims']} "
                         f"{packed['slabs'].dtype} on {packed['slabs'].device}")
    out = torch.empty_like(x)
    status = library().e4s_swin_block(
        x.data_ptr(), packed["slabs"].data_ptr(), packed["vec"].data_ptr(),
        wts["bias_hnn"].data_ptr(), None if labels is None else labels.data_ptr(),
        out.data_ptr(), kernels.DTYPE_CODES[x.dtype], b, h, w, c, heads, hidden, window, shift,
        scale_for(c // heads, x.dtype), EPS, x.device.index, kernels.stream_of(x))
    kernels.check_status(name, status)
    fused_swin_block.launches += 1
    return out
