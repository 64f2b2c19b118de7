"""Swapped segmentation and style-vector mixing, batched.

`swap_head_mask` and `swap_comp_style_vector` (reference
swap_face_fine/swap_face_mask.py:93-438). The JAX package maps the mask
merge over the batch; here every reduction runs per sample directly.

Class ids: 0 bg, 1 lip, 2 eyebrow, 3 eye, 4 hair, 5 nose, 6 skin, 7 ear,
8 neck, 9 tooth, 10 eyeglass, 11 earring.

A frozen copy of `e4s2024_torch/pipelines/mask_merge.py` for the benchmark's plain
reference: no kernel, no split, no process group; it imports nothing of
the port.
"""

from __future__ import annotations

import torch

_BG_CLASSES = (0, 4, 7, 8, 11)  # bg, hair, ear, neck, earring


def _is_bg(mask: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(mask, dtype=torch.bool)
    for c in _BG_CLASSES:
        out |= mask == c
    return out


def swap_head_mask(source: torch.Tensor, target: torch.Tensor) -> dict:
    """Merge the source inner face onto the target's background.

    source, target: (B, H, W) integer 12-class maps of aligned crops.
    Returns a dict of mask (B, H, W), hole_mask (B, H, W) bool (target-face
    pixels the source face does not cover, below the source eye line),
    hole_map (holes marked 17) and nose_line (B,), with the semantics of
    reference swap_face_mask.py:194-333 ("hole first")."""
    b, h, w = target.shape
    rows = torch.arange(h, device=target.device)[None, :, None]

    source_face = ~_is_bg(source)
    target_face = ~_is_bg(target)
    hole_mask = (source_face & target_face) ^ target_face

    def per_sample(t):
        return t.reshape(b, -1)

    def lowest_row(cond, default):
        val = per_sample(torch.where(cond, rows, -1)).amax(dim=1)
        return torch.where(per_sample(cond).any(dim=1), val, default)

    has_eye = per_sample(source == 3).any(dim=1)
    eye_line = torch.where(has_eye, lowest_row(source == 3, 2 * h // 5),
                           lowest_row(source == 2, 2 * h // 5))
    nose_line = lowest_row(source == 5, 3 * h // 5)
    hole_mask = hole_mask & (rows >= eye_line[:, None, None])

    # painter's algorithm: later paints overwrite earlier ones
    paints = [(target == 0, 99), (target == 8, 8), (target == 7, 7), (target == 11, 11)]
    paints += [(source == c, c) for c in (1, 2)]
    paints += [((source == 4) & (target == 2), 2)]  # source hair over target brow
    paints += [(source == c, c) for c in (3, 5, 6, 9)]
    # hat-occlusion fix (reference :278-301): target-bg pixels at or above the
    # highest target-skin row of their column become foreground
    skin_highest = torch.where(target == 6, rows, h).amin(dim=1, keepdim=True)  # (B, 1, W)
    tgt_fg = (target == 0) & (rows <= skin_highest) & (skin_highest != h)
    paints += [(tgt_fg, 98), (target == 4, 4), (target == 10, 10)]

    res = torch.zeros_like(target)
    for cond, val in paints:
        res = torch.where(cond, val, res)
    res = torch.where(res == 0, 6, res)   # fill remaining holes with skin
    res = torch.where(res == 99, 0, res)  # restore background
    res = torch.where(res == 98, 0, res)  # extra foreground back to background
    return {
        "mask": res,
        "hole_mask": hole_mask,
        "hole_map": torch.where(hole_mask, 17, res),
        "nose_line": nose_line,
    }


def swap_comp_style_vector(target_sv: torch.Tensor, source_sv: torch.Tensor,
                           comp_indices, belowface_interpolation: bool = False
                           ) -> torch.Tensor:
    """Mix per-component style vectors (reference :336-367).

    target_sv, source_sv: (B, 12, D); comp_indices: components taken from the
    source. Ears are averaged, earrings come from the target, teeth fall back
    to the target where the source has none, the neck is optionally averaged.
    """
    k = target_sv.shape[1]
    take_src = torch.zeros(k, dtype=torch.bool, device=target_sv.device)
    take_src[torch.as_tensor(comp_indices, device=target_sv.device)] = True
    sv = torch.where(take_src[None, :, None], source_sv, target_sv)
    sv[:, 7] = (target_sv[:, 7] + source_sv[:, 7]) / 2  # ears
    sv[:, 11] = target_sv[:, 11]  # earrings from the target
    if belowface_interpolation:
        sv[:, 8] = (target_sv[:, 8] + source_sv[:, 8]) / 2
    src_has_teeth = source_sv[:, 9].sum(dim=-1, keepdim=True) != 0
    sv[:, 9] = torch.where(src_has_teeth, sv[:, 9], target_sv[:, 9])
    return sv
