"""ArcFace 5-point similarity alignment (reference /alignment.py:24-150).

Counterpart of `e4s2024_tpu/pipelines/arcface_align.py`: an Umeyama
similarity fit of five facial landmarks to the arcface / ffhq / set1
template (numpy, float64), and cv2.warpAffine's bilinear sampling as a
gather on the device, in float32 like the JAX package. Images are
(H, W, C) tensors.
"""

from __future__ import annotations

import numpy as np
import torch

TEMPLATES = {
    "arcface": np.array([
        [38.2946, 51.6963], [73.5318, 51.5014], [56.0252, 71.7366],
        [41.5493, 92.3655], [70.7299, 92.2041]], np.float32),
    "set1": np.array([
        [41.125, 50.75], [71.75, 49.4375], [49.875, 73.0625],
        [45.9375, 87.9375], [70.4375, 87.9375]], np.float32),
    "ffhq": np.array([
        [192.98138, 239.94708], [318.90277, 240.1936], [256.63416, 314.01935],
        [201.26117, 371.41043], [313.08905, 371.15118]], np.float32),
}


def umeyama_similarity(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """2x3 similarity transform mapping src points to dst (Umeyama 1991)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    n = src.shape[0]
    mu_s, mu_d = src.mean(0), dst.mean(0)
    ss, dd = src - mu_s, dst - mu_d
    cov = dd.T @ ss / n
    u, s, vt = np.linalg.svd(cov)
    d = np.ones(2)
    if np.linalg.det(cov) < 0:
        d[-1] = -1
    r = u @ np.diag(d) @ vt
    scale = (s * d).sum() / ((ss ** 2).sum() / n)
    m = np.zeros((2, 3))
    m[:, :2] = scale * r
    m[:, 2] = mu_d - scale * r @ mu_s
    return m


def estimate_norm(landmark5: np.ndarray, image_size: int = 112,
                  mode: str = "arcface") -> np.ndarray:
    """2x3 warp from 5 landmarks to the template, scaled from its base size
    (512 for ffhq, 112 for arcface and set1) to `image_size`."""
    base = 512.0 if mode == "ffhq" else 112.0
    tmpl = TEMPLATES[mode] * (image_size / base)
    return umeyama_similarity(np.asarray(landmark5, np.float64), tmpl)


def invert_affine(m: np.ndarray) -> np.ndarray:
    """The inverse of a 2x3 affine (crop -> frame for the paste-back)."""
    a = np.vstack([np.asarray(m, np.float64), [0.0, 0.0, 1.0]])
    return np.linalg.inv(a)[:2]


def warp_affine_hw(img: torch.Tensor, m, out_hw: tuple[int, int]) -> torch.Tensor:
    """cv2.warpAffine: output pixel (x, y) samples img bilinearly at
    M^-1 (x, y), zero outside. img: (H, W, C); m: (2, 3), inverted in
    float32 on img's device as the JAX package does."""
    dev = img.device
    a = torch.cat([torch.as_tensor(np.asarray(m, np.float32), device=dev),
                   torch.tensor([[0.0, 0.0, 1.0]], device=dev)])
    inv = torch.linalg.inv(a)
    oh, ow = out_hw
    xx = torch.arange(ow, dtype=torch.float32, device=dev)[None, :].expand(oh, ow)
    yy = torch.arange(oh, dtype=torch.float32, device=dev)[:, None].expand(oh, ow)
    xs = inv[0, 0] * xx + inv[0, 1] * yy + inv[0, 2]
    ys = inv[1, 0] * xx + inv[1, 1] * yy + inv[1, 2]
    h, w = img.shape[:2]
    x0 = torch.floor(xs).to(torch.int64)
    y0 = torch.floor(ys).to(torch.int64)
    tx, ty = (xs - x0)[..., None], (ys - y0)[..., None]
    img = img.float()

    def tap(yi, xi):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        v = img[yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        return torch.where(valid[..., None], v, 0.0)

    top = tap(y0, x0) * (1 - tx) + tap(y0, x0 + 1) * tx
    bot = tap(y0 + 1, x0) * (1 - tx) + tap(y0 + 1, x0 + 1) * tx
    return top * (1 - ty) + bot * ty


def warp_affine(img: torch.Tensor, m, out_size: int) -> torch.Tensor:
    """`warp_affine_hw` to a square (out_size, out_size, C) crop."""
    return warp_affine_hw(img, m, (out_size, out_size))


def norm_crop(img, landmark5: np.ndarray, image_size: int = 112, mode: str = "arcface",
              device=None):
    """The aligned crop (numpy float32) and its warp matrix."""
    m = estimate_norm(landmark5, image_size, mode)
    img = torch.as_tensor(np.asarray(img, np.float32) if not isinstance(img, torch.Tensor)
                          else img, device=device)
    return warp_affine(img, m, image_size).cpu().numpy(), m
