"""The benchmark's traffic generator: seeded inputs from a traffic file.

A traffic file (`perfbench/traffic/<name>.json`) holds parameters only; the
generator it names (`"generator"`) is a function of this module. Every seed
gives the same sizes and the same number of inputs; the seed changes only
their content.
"""

from __future__ import annotations

import numpy as np
import torch


def _gen(seed: int, salt: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 2_654_435_761 + salt) % (2 ** 63))
    return g


def smooth_images(n: int, size: int, seed: int, device, *, block: int = 40,
                  base: float = 200.0, noise: float = 55.0, salt: int = 0) -> torch.Tensor:
    """(n, size, size, 3) uint8 images on `device`: coarse `block`-pixel
    squares of level up to `base` plus up to `noise` of fine noise, drawn
    from `seed` on the device (the scene of the port's `profile_swap`
    `raw_frames` and `video_clip`)."""
    g = _gen(seed, salt, device)
    cells = -(-size // block)
    coarse = torch.rand(n, cells, cells, 3, generator=g, device=device) * base
    img = coarse.repeat_interleave(block, 1).repeat_interleave(block, 2)[:, :size, :size]
    img = img + torch.rand(n, size, size, 3, generator=g, device=device) * noise
    return img.to(torch.uint8)


def aligned_pairs(params: dict, size: int, seed: int, device) -> list:
    """The pool of calls of an aligned swap: `params["pool"]` distinct
    (driven, target) pairs of `size`^2 crops, batched `params["batch"]` to
    a call; each call's driven and target are (B, size, size, 3) uint8
    numpy arrays on the host, as a caller hands them over. The pool holds
    pool / batch calls, which the window cycles through."""
    pool, batch = int(params["pool"]), int(params["batch"])
    if pool % batch:
        raise ValueError(f"a pool of {pool} pairs does not split into batches of {batch}")
    imgs = smooth_images(2 * pool, size, seed, device, block=params["block"],
                         base=params["base"], noise=params["noise"]).cpu().numpy()
    driven, target = imgs[:pool], imgs[pool:]
    return [(np.ascontiguousarray(driven[i:i + batch]), np.ascontiguousarray(target[i:i + batch]))
            for i in range(0, pool, batch)]


GENERATORS = {"aligned_pairs": aligned_pairs}


def make(params: dict, size: int, seed: int, device):
    """The inputs of a traffic file's parameters."""
    return GENERATORS[params["generator"]](params, size, seed, device)
