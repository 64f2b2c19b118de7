"""E4S regional-GAN-inversion face swapping in PyTorch, for NVIDIA Hopper.

The PyTorch counterpart of the JAX package `e4s2024_tpu`, which stays the
reference it is tested against. Layout inside the package is NCHW, module
and parameter names are the original reference's state-dict names, and the
StyleGAN2 hot ops run as hand-written CUDA kernels (`kernels/csrc/`).

Entry points run on the CUDA device unless the caller passes
`device="cpu"`; without a card they raise instead of falling back.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA by default. Raises when CUDA
    is asked for (or left as the default) and no card is present."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device
