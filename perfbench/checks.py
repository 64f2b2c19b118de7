"""The numbers that decide `correct`: gaps between what a call of the
program produced and what the plain reference computes from the same
inputs; the drivers take the worst call's."""

from __future__ import annotations

import torch


def per_image_mad(image: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Each image's mean |difference| of (B, H, W, 3) uint8 images, in
    levels, as a (B,) float tensor."""
    diff = (image.to(torch.int16) - ref.to(image.device, torch.int16)).abs().float()
    return diff.flatten(1).mean(1)


def image_mad(image: torch.Tensor, ref: torch.Tensor) -> float:
    """The mean |difference| of a call's uint8 images, in levels."""
    return per_image_mad(image, ref).mean().item()


def image_mad_median(image: torch.Tensor, ref: torch.Tensor) -> float:
    """The median over a batch's images of each image's mean |difference|
    of uint8 images, in levels (the mean of the two middle ones for an even
    batch). It stays at rounding's level while fewer than half of the
    images carry a parse label flipped at a near-tie, which moves one
    image's region far more than rounding does (PERF.md)."""
    per_image = per_image_mad(image, ref).sort().values
    n = per_image.numel()
    return (0.5 * (per_image[(n - 1) // 2] + per_image[n // 2])).item()


def image_mad_worst(image: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst image's mean |difference| of a batch of uint8 images, in
    levels: what one image swapped wrong (a pair mixed up, a swap left
    undone) reads while the rest of its batch is sound."""
    return per_image_mad(image, ref).max().item()


def mismatch_share(labels: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst item's share of positions where two label maps differ."""
    return (labels != ref.to(labels.device)).float().flatten(1).mean(1).max().item()


def rel_gap(x: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst item's largest |difference| over its reference's largest
    |value|."""
    ref = ref.to(x.device, torch.float32).flatten(1)
    gap = (x.float().flatten(1) - ref).abs().max(1).values
    return (gap / ref.abs().max(1).values.clamp_min(1e-30)).max().item()
