"""upfirdn2d: upsample / FIR filter / downsample, over kernel K2.

Counterpart of `e4s2024_tpu/ops/upfirdn.py`. The kernel
(`kernels/csrc/upfirdn2d.cu`) replaces
`e4s2024_tpu/ops/pallas/kernels.py::blur3x3_tpu`, generalised to every case
the generator runs: the x4-gain blur after each transposed convolution, the
up-2 FIR upsample of each ToRGB skip, and down-2 resampling.

Semantics (the original StyleGAN2 `upfirdn2d_native`):
  1. zero-stuff the input by `up` (up - 1 zeros after each sample),
  2. pad with (pad0 before, pad1 after) on both axes (negative pads crop),
  3. convolve with the 2-D FIR kernel (a true convolution: flipped),
  4. keep every `down`-th sample starting at 0.

Layout: NCHW. The FIR kernel is a small (kh, kw) CPU tensor shared by all
channels; its taps travel to the card by value with each launch. A rank-1
kernel (the generator's outer([1,3,3,1]) x gain) at up 1 / down 1 goes to
the kernel as its two 1-D factors, which it applies as a horizontal then a
vertical pass.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from e4s2024_torch import kernels
from e4s2024_torch.kernels.build import library


def make_kernel(k) -> torch.Tensor:
    """Normalised 2-D FIR kernel from a 1-D or 2-D tap list (reference
    model.py:23): the outer product of a 1-D list with itself, summing to 1."""
    k = np.asarray(k, dtype=np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    return torch.from_numpy(k / k.sum())


def out_size(size: int, kernel_size: int, up: int, down: int,
             pad: tuple[int, int]) -> int:
    return (size * up + pad[0] + pad[1] - kernel_size) // down + 1


def upfirdn2d_plain(x: torch.Tensor, kernel: torch.Tensor, up: int = 1,
                    down: int = 1, pad: tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Zero-stuff, `F.pad`, then one depthwise `F.conv2d` with the flipped
    kernel. x: (N, C, H, W); kernel: (kh, kw)."""
    n, c, h, w = x.shape
    if up > 1:
        stuffed = x.new_zeros(n, c, h * up, w * up)
        stuffed[:, :, ::up, ::up] = x
        x = stuffed
    p0, p1 = pad
    x = F.pad(x, [p0, p1, p0, p1])
    k = torch.flip(kernel, (0, 1)).to(device=x.device, dtype=x.dtype)
    k = k[None, None].expand(c, 1, *k.shape)
    return F.conv2d(x, k, stride=down, groups=c)


def rank1_taps(kernel) -> tuple[np.ndarray, np.ndarray] | None:
    """(u, v) with kernel == outer(u, v) to within 1e-7 of its largest tap,
    or None for a kernel that is not rank-1. kernel: (kh, kw). The factors
    share the largest tap's magnitude evenly, so that the generator's
    outer([1,3,3,1]) / 64 x gain (gain 1 or 4) splits into exact binary
    fractions, ([1,3,3,1] / 8 or / 4 on both sides)."""
    k = np.asarray(kernel, dtype=np.float64)
    i, j = np.unravel_index(np.argmax(np.abs(k)), k.shape)
    pivot = k[i, j]
    if pivot == 0:
        return None
    root = np.sqrt(abs(pivot))
    u, v = k[:, j] / root, k[i, :] / (root * np.sign(pivot))
    if np.abs(np.outer(u, v) - k).max() > 1e-7 * abs(pivot):
        return None
    return u.astype(np.float32), v.astype(np.float32)


_TAPS: dict = {}


def _launch_taps(kernel: torch.Tensor, separable: bool) -> tuple[int, ctypes.Array]:
    """(rank1, taps) for the C entry point, cached by the kernel's values:
    the two flipped 1-D factors where the kernel is rank-1 and `separable`,
    else the flipped kernel row-major."""
    key = (tuple(kernel.shape), tuple(kernel.detach().reshape(-1).tolist()), separable)
    hit = _TAPS.get(key)
    if hit is None:
        k = kernel.detach().float().numpy()
        factors = rank1_taps(k) if separable else None
        if factors is None:
            flat = np.flip(k, (0, 1)).ravel()
        else:
            flat = np.concatenate([factors[0][::-1], factors[1][::-1]])
        if len(_TAPS) >= 64:
            _TAPS.clear()
        hit = _TAPS[key] = (int(factors is not None),
                            (ctypes.c_float * flat.size)(*flat.tolist()))
    return hit


@kernels.counted("upfirdn2d")
def upfirdn2d(x: torch.Tensor, kernel: torch.Tensor, up: int = 1, down: int = 1,
              pad: tuple[int, int] = (0, 0)) -> torch.Tensor:
    """upfirdn2d of an NCHW tensor: the plain version on the CPU, kernel K2
    on a CUDA device (float32 or bfloat16, float32 arithmetic; kernel taps at
    most 4 x 4, up and down 1 or 2).

    Returns (N, C, H', W') with H' = (H * up + pad0 + pad1 - kh) // down + 1.
    """
    if kernels.use_plain(x):
        return upfirdn2d_plain(x, kernel, up, down, pad)
    name = "upfirdn2d"
    if x.ndim != 4:
        raise ValueError(f"{name}: x must be (N, C, H, W), got {tuple(x.shape)}")
    kernels.check_input(name, "x", x)
    if kernel.device.type != "cpu":
        raise ValueError(f"{name}: the FIR kernel must be a CPU tensor")
    kh, kw = kernel.shape
    if not (1 <= kh <= 4 and 1 <= kw <= 4 and up in (1, 2) and down in (1, 2)):
        raise ValueError(f"{name}: unsupported kernel {kh}x{kw}, up {up}, down {down}")
    n, c, h, w = x.shape
    oh = out_size(h, kh, up, down, pad)
    ow = out_size(w, kw, up, down, pad)
    if oh <= 0 or ow <= 0:
        raise ValueError(f"{name}: empty output for input {h}x{w} and pad {pad}")
    rank1, taps = _launch_taps(kernel, up == 1 and down == 1)
    out = x.new_empty(n, c, oh, ow)
    status = library().e4s_upfirdn2d(
        x.data_ptr(), out.data_ptr(), kernels.DTYPE_CODES[x.dtype], n * c,
        h, w, oh, ow, up, down, pad[0], taps, kh, kw, rank1,
        x.device.index, kernels.stream_of(x))
    kernels.check_status(name, status)
    upfirdn2d.launches += 1
    return out


def _resample_pads(kernel_size: int, factor: int, up: bool) -> tuple[int, int]:
    p = kernel_size - factor
    if up:
        return (p + 1) // 2 + factor - 1, p // 2
    return (p + 1) // 2, p // 2


def upsample_2x(x: torch.Tensor, kernel: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """FIR-interpolated upsample (reference model.py:34 `Upsample`)."""
    pad = _resample_pads(kernel.shape[0], factor, up=True)
    return upfirdn2d(x, kernel * (factor ** 2), up=factor, down=1, pad=pad)


def downsample_2x(x: torch.Tensor, kernel: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Anti-aliased downsample (reference model.py:56 `Downsample`)."""
    pad = _resample_pads(kernel.shape[0], factor, up=False)
    return upfirdn2d(x, kernel, up=1, down=factor, pad=pad)


def blur(x: torch.Tensor, kernel: torch.Tensor, pad: tuple[int, int],
         upsample_factor: int = 1) -> torch.Tensor:
    """Plain FIR blur with explicit pads (reference model.py:78 `Blur`)."""
    if upsample_factor > 1:
        kernel = kernel * (upsample_factor ** 2)
    return upfirdn2d(x, kernel, up=1, down=1, pad=pad)
