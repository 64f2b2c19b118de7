"""Image and label conversion and visualisation helpers, numpy only (a copy
of `e4s2024_tpu/utils/image.py`), and a PNG writer that needs no PIL.

HWC counterparts of the reference's utils/torch_utils.py converters
(tensor2im/im2tensor :passim, get_colors :126, tensor2map, vis_faces :150),
without matplotlib.
"""

from __future__ import annotations

import struct
import zlib

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


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def save_png(path, img: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 image as an 8-bit RGB PNG (an (H, W) one as
    8-bit grayscale), with zlib and struct only: the port's hosts need not
    have PIL. Rows are stored unfiltered."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"save_png takes (H, W, 3) or (H, W) uint8, got {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    color_type = 2 if img.ndim == 3 else 0
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)], axis=1)
    png = (b"\x89PNG\r\n\x1a\n"
           + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
           + _png_chunk(b"IDAT", zlib.compress(rows.tobytes()))
           + _png_chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)
