"""FFHQ-style face alignment: quad computation, crop, perspective paste-back.

Counterpart of `e4s2024_tpu/pipelines/alignment.py` (the reference's
STIT-derived alignment, utils/alignment.py:150-284). The quad math stays
numpy in float64 (a few scalars a face); the resampling, which the
reference does through PIL on the CPU, is a bilinear gather on the device
with PIL's half-pixel and per-tap zero-fill semantics. Positions are
computed in float32 in the JAX package's order of operations.

Landmark detection is pluggable: any (68, 2) landmark array works.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.ndimage import gaussian_filter1d


def compute_transform_from_landmarks(lm: np.ndarray, scale: float = 1.0):
    """FFHQ crop frame (c, x, y) from 68-point landmarks (reference
    alignment.py:191-222). Raises ValueError on degenerate landmarks
    (coincident points, NaNs)."""
    lm = np.asarray(lm, dtype=np.float64)
    eye_left = lm[36:42].mean(axis=0)
    eye_right = lm[42:48].mean(axis=0)
    eye_avg = (eye_left + eye_right) * 0.5
    eye_to_eye = eye_right - eye_left
    mouth_avg = (lm[48] + lm[54]) * 0.5
    eye_to_mouth = mouth_avg - eye_avg

    x = eye_to_eye - np.flipud(eye_to_mouth) * [-1, 1]
    norm = np.hypot(*x)
    if not np.isfinite(lm).all() or norm < 1e-8:
        raise ValueError("degenerate 68-pt landmarks: cannot derive an FFHQ crop frame")
    x /= norm
    x *= max(np.hypot(*eye_to_eye) * 2.0, np.hypot(*eye_to_mouth) * 1.8)
    x *= scale
    y = np.flipud(x) * [-1, 1]
    c = eye_avg + eye_to_mouth * 0.1
    return c, x, y


def quad_from_cxy(c: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Quad corners (NW, SW, SE, NE) from the crop frame (alignment.py:94)."""
    return np.stack([c - x - y, c - x + y, c + x + y, c + x - y])


def smooth_video_quads(cs, xs, ys, center_sigma=1.0, xy_sigma=3.0):
    """Temporal gaussian smoothing of per-frame crop frames (alignment.py:246-251)."""
    cs, xs, ys = np.stack(cs), np.stack(xs), np.stack(ys)
    if center_sigma:
        cs = gaussian_filter1d(cs, sigma=center_sigma, axis=0)
    if xy_sigma:
        xs = gaussian_filter1d(xs, sigma=xy_sigma, axis=0)
        ys = gaussian_filter1d(ys, sigma=xy_sigma, axis=0)
    return [quad_from_cxy(c, x, y) for c, x, y in zip(cs, xs, ys)]


def perspective_coefficients(pa, pb) -> np.ndarray:
    """The 8 coefficients that map points pa of the OUTPUT to points pb of
    the INPUT (PIL convention; reference alignment.py:273-284
    `calc_alignment_coefficients`)."""
    matrix = []
    for p1, p2 in zip(pa, pb):
        matrix.append([p1[0], p1[1], 1, 0, 0, 0, -p2[0] * p1[0], -p2[0] * p1[1]])
        matrix.append([0, 0, 0, p1[0], p1[1], 1, -p2[1] * p1[0], -p2[1] * p1[1]])
    a = np.asarray(matrix, dtype=np.float64)
    b = np.asarray(pb, dtype=np.float64).reshape(8)
    return np.linalg.solve(a.T @ a, a.T @ b)


def paste_back_coefficients(quad: np.ndarray, crop_size: int) -> np.ndarray:
    """Coefficients for pasting a crop back into the frame, frame pixel ->
    crop pixel (reference Face_swap_with_two_imgs.py:97, from quad + 0.5)."""
    corners = [(0, 0), (0, crop_size), (crop_size, crop_size), (crop_size, 0)]
    return perspective_coefficients(np.asarray(quad) + 0.5, corners)


def as_f32(a, device) -> torch.Tensor:
    """A float64 host array as the float32 tensor the JAX package makes of
    it (x64 off), on `device`."""
    return torch.as_tensor(np.asarray(a, np.float64), dtype=torch.float32, device=device)


def _bilinear_gather(img: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Sample img (H, W, C), or (B, H, W, C) with xs, ys of leading dim B,
    at float positions in pixel-index space; each tap outside the image
    reads 0 (PIL). Taps are read in the image's dtype and computed in
    float32. Returns xs.shape + (C,)."""
    h, w, c = img.shape[-3:]
    x0, y0 = torch.floor(xs), torch.floor(ys)
    tx, ty = (xs - x0)[..., None], (ys - y0)[..., None]
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
    flat = img.reshape(-1, c)
    base = 0
    if img.ndim == 4:
        base = (torch.arange(img.shape[0], device=img.device) * (h * w)).view(
            -1, *([1] * (xs.ndim - 1)))

    def tap(yi, xi):
        valid = ((xi >= 0) & (xi < w) & (yi >= 0) & (yi < h))[..., None]
        v = flat[base + torch.clamp(yi, 0, h - 1) * w + torch.clamp(xi, 0, w - 1)].float()
        return torch.where(valid, v, 0.0)

    top = tap(y0i, x0i) * (1 - tx) + tap(y0i, x0i + 1) * tx
    bot = tap(y0i + 1, x0i) * (1 - tx) + tap(y0i + 1, x0i + 1) * tx
    return top * (1 - ty) + bot * ty


def _quad_positions(quad: torch.Tensor, out_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Source positions (x, y), each (..., S, S), of a PIL QUAD transform
    for float32 quads (..., 4, 2) (NW, SW, SE, NE): evaluated at output
    pixel centres, shifted by -0.5 into array-index space."""
    s = out_size
    ar = torch.arange(s, dtype=torch.float32, device=quad.device) + 0.5
    u = (ar / s)[None, :].expand(s, s)
    v = (ar / s)[:, None].expand(s, s)
    q = quad[..., None, None, :, :]  # (..., 1, 1, 4, 2)
    nw, sw, se, ne = q[..., 0, :], q[..., 1, :], q[..., 2, :], q[..., 3, :]
    pos = (nw + u[..., None] * (ne - nw) + v[..., None] * (sw - nw)
           + (u * v)[..., None] * (se - sw - ne + nw))
    return pos[..., 0] - 0.5, pos[..., 1] - 0.5


def crop_quad(img: torch.Tensor, quad: torch.Tensor, out_size: int) -> torch.Tensor:
    """Bilinear quad crop with PIL Image.transform(QUAD) semantics
    (reference alignment.py:144 passes quad + 0.5, which cancels PIL's
    half-pixel offset; pass that here as a float32 tensor).

    img: (H, W, C); quad: (4, 2) or (F, 4, 2) in (x, y) order. Returns
    (S, S, C) or (F, S, S, C) float32. With img (B, H, W, C), quad is
    (B, 4, 2): one quad a frame."""
    xs, ys = _quad_positions(quad, out_size)
    return _bilinear_gather(img, xs, ys)


def warp_perspective(img: torch.Tensor, coeffs: torch.Tensor,
                     out_hw: tuple[int, int]) -> torch.Tensor:
    """PIL Image.transform(PERSPECTIVE) semantics: output pixel (x, y) reads
    the input at ((a x + b y + c) / (g x + h y + 1), (d x + e y + f) / (...)),
    at pixel centres. img (H, W, C) with coeffs (8,), or img (B, H, W, C)
    with coeffs (B, 8), float32. Used to paste the swapped crop back into
    the frame (reference Face_swap_with_two_imgs.py:264-279)."""
    oh, ow = out_hw
    a, b, c, d, e, f, g, h = coeffs[..., None, None].unbind(-3)
    dev = img.device
    xx = (torch.arange(ow, dtype=torch.float32, device=dev) + 0.5)[None, :].expand(oh, ow)
    yy = (torch.arange(oh, dtype=torch.float32, device=dev) + 0.5)[:, None].expand(oh, ow)
    den = g * xx + h * yy + 1.0
    xs = (a * xx + b * yy + c) / den - 0.5
    ys = (d * xx + e * yy + f) / den - 0.5
    return _bilinear_gather(img, xs, ys)
