"""Image and label conversion and visualisation helpers, numpy only (a copy
of `e4s2024_tpu/utils/image.py`).

HWC counterparts of the reference's utils/torch_utils.py converters
(tensor2im/im2tensor :passim, get_colors :126, tensor2map, vis_faces :150),
without matplotlib.
"""

from __future__ import annotations

import numpy as np


def to_pm1(img_uint8: np.ndarray) -> np.ndarray:
    """uint8 [0,255] -> float32 [-1,1] (the TO_TENSOR+NORMALIZE transform,
    reference datasets/dataset.py:32-45)."""
    return img_uint8.astype(np.float32) / 127.5 - 1.0


def from_pm1(img: np.ndarray) -> np.ndarray:
    """float [-1,1] -> uint8 [0,255] (reference torch_utils.tensor2im)."""
    return np.clip((np.asarray(img) + 1.0) * 127.5, 0, 255).astype(np.uint8)


def label_colors(n: int = 19) -> np.ndarray:
    """Color LUT for label visualization (reference torch_utils.get_colors:126
    uses a fixed palette; we use a deterministic distinct palette)."""
    base = np.array([
        [0, 0, 0], [255, 85, 0], [255, 170, 0], [255, 0, 85], [255, 0, 170],
        [0, 255, 0], [85, 255, 0], [170, 255, 0], [0, 255, 85], [0, 255, 170],
        [0, 0, 255], [85, 0, 255], [170, 0, 255], [0, 85, 255], [0, 170, 255],
        [255, 255, 0], [255, 255, 85], [255, 255, 170], [255, 0, 255],
    ], dtype=np.uint8)
    if n <= len(base):
        return base[:n]
    rng = np.random.default_rng(0)
    extra = rng.integers(0, 256, size=(n - len(base), 3), dtype=np.uint8)
    return np.concatenate([base, extra], axis=0)


def colorize_label_map(label: np.ndarray, n: int = 19) -> np.ndarray:
    """(H, W) int map -> (H, W, 3) uint8 color visualization."""
    return label_colors(n)[np.asarray(label, dtype=np.int64)]


def vis_faces_grid(rows: list[list[np.ndarray]]) -> np.ndarray:
    """Stack a grid of same-size uint8 images: rows of columns -> one image
    (replaces the reference's matplotlib vis_faces, torch_utils.py:150)."""
    return np.concatenate(
        [np.concatenate(r, axis=1) for r in rows], axis=0)
