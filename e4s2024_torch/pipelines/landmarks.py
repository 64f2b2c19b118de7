"""Landmark track smoothing and moving-least-squares image deformation.

Counterpart of `e4s2024_tpu/pipelines/landmarks.py` (the reference's video
helpers):
- Kalman and Savitzky-Golay smoothing of per-frame landmark tracks
  (reference swap_face_fine/landmark_smooth.py:6-104), numpy on the host;
- `image_deformation(image, landmarks, ref_landmarks)`: rigid MLS warping
  of a face towards reference landmarks (reference
  swap_face_fine/deformation_demo.py:450-600, Schaefer et al. 2006), as an
  inverse-warp grid and a bilinear gather on the device.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.signal import savgol_filter

from e4s2024_torch import resolve_device


def kalman_smooth_landmarks(tracks: np.ndarray, process_noise: float = 1e-3,
                            measurement_noise: float = 1e-2) -> np.ndarray:
    """Constant-position Kalman smoothing per coordinate. tracks: (F, P, 2)
    landmark tracks. Returns the same shape."""
    f, p, d = tracks.shape
    x = tracks.reshape(f, p * d).astype(np.float64)
    est = np.empty_like(x)
    est[0] = x[0]
    var = np.ones(p * d)
    for t in range(1, f):
        var = var + process_noise
        k = var / (var + measurement_noise)
        est[t] = est[t - 1] + k * (x[t] - est[t - 1])
        var = (1 - k) * var
    return est.reshape(f, p, d).astype(tracks.dtype)


def savgol_smooth_landmarks(tracks: np.ndarray, window: int = 7, order: int = 2) -> np.ndarray:
    """Savitzky-Golay smoothing along the frame axis (landmark_smooth.py:84)."""
    f = tracks.shape[0]
    window = min(window, f if f % 2 == 1 else f - 1)
    if window <= order:
        return tracks
    return savgol_filter(tracks, window, order, axis=0).astype(tracks.dtype)


def mls_rigid_deformation_grid(src_pts: torch.Tensor, dst_pts: torch.Tensor, height: int,
                               width: int, alpha: float = 1.0) -> torch.Tensor:
    """Rigid MLS inverse-warp grid (Schaefer 2006, section 2.3): for each
    OUTPUT pixel, where to sample the source, with control points `dst_pts`
    (in the output) mapped to `src_pts` (in the source), both (K, 2).
    Returns (H, W, 2) sample positions (x, y), float32."""
    dev = src_pts.device
    yy, xx = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=dev),
                            torch.arange(width, dtype=torch.float32, device=dev), indexing="ij")
    v = torch.stack([xx, yy], -1).reshape(-1, 2)          # (N, 2)
    p = dst_pts.float()                                    # (K, 2) in the output
    q = src_pts.float()                                    # (K, 2) in the source

    d2 = torch.sum(torch.square(v[:, None] - p[None]), -1)  # (N, K)
    w = 1.0 / torch.clamp(d2, min=1e-8) ** alpha
    wsum = torch.sum(w, -1, keepdim=True)
    p_star = (w @ p) / wsum                                # (N, 2)
    q_star = (w @ q) / wsum
    ph = p[None] - p_star[:, None]                         # (N, K, 2)
    qh = q[None] - q_star[:, None]

    def perp(a):
        return torch.stack([-a[..., 1], a[..., 0]], -1)

    # rigid MLS: a similarity transform without scaling
    vp = v - p_star
    a1 = torch.sum(w * torch.sum(qh * ph, -1), -1)        # (N,)
    a2 = torch.sum(w * torch.sum(qh * perp(ph), -1), -1)
    mu = torch.sqrt(a1 ** 2 + a2 ** 2) + 1e-8
    r1 = torch.stack([a1, -a2], -1) / mu[:, None]
    r2 = torch.stack([a2, a1], -1) / mu[:, None]
    fx = vp[:, 0] * r1[:, 0] + vp[:, 1] * r2[:, 0]
    fy = vp[:, 0] * r1[:, 1] + vp[:, 1] * r2[:, 1]
    return (torch.stack([fx, fy], -1) + q_star).reshape(height, width, 2)


def warp_with_grid(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear-sample img (H, W, C) at grid (H', W', 2) (x, y) positions,
    clamped to the image (edge replication). Returns float32."""
    h, w, _ = img.shape
    img = img.float()
    xs = torch.clamp(grid[..., 0], 0.0, w - 1.0)
    ys = torch.clamp(grid[..., 1], 0.0, h - 1.0)
    x0 = torch.floor(xs).to(torch.int64)
    y0 = torch.floor(ys).to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    tx = (xs - x0)[..., None]
    ty = (ys - y0)[..., None]
    top = img[y0, x0] * (1 - tx) + img[y0, x1] * tx
    bot = img[y1, x0] * (1 - tx) + img[y1, x1] * tx
    return top * (1 - ty) + bot * ty


def image_deformation(image: np.ndarray, landmarks: np.ndarray, ref_landmarks: np.ndarray,
                      *, device=None) -> np.ndarray:
    """Warp `image` (H, W, C) so that its landmarks move towards
    `ref_landmarks` (rigid MLS, the reference's image_deformation
    mode='rigid'), on the card unless `device` says otherwise. Returns
    float32 numpy."""
    device = resolve_device(device)
    h, w = image.shape[:2]
    grid = mls_rigid_deformation_grid(
        torch.as_tensor(np.asarray(landmarks, np.float32), device=device),
        torch.as_tensor(np.asarray(ref_landmarks, np.float32), device=device), h, w)
    return warp_with_grid(torch.as_tensor(np.asarray(image), device=device), grid).cpu().numpy()
