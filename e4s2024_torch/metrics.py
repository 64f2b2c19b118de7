"""Evaluation metrics: SSIM, PSNR and RMSE for reconstructions, and ArcFace
identity retrieval.

Counterpart of `e4s2024_tpu/metrics.py` (reference metric/metric_utils.py:22-67:
skimage's compare_ssim with gaussian_weights=True and
use_sample_covariance=False, the SEAN issue-#5 protocol;
metric/face_recognition/find_faces.py: cosine retrieval). SSIM is Wang et
al. 2004 with an 11x11 Gaussian window of sigma 1.5, filtered separably
and 'valid' per channel. The functions take NCHW tensors;
`reconstruction_metrics` takes uint8 NHWC numpy batches, as the JAX
package's does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from e4s2024_torch import resolve_device


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    half = size // 2
    x = np.arange(-half, half + 1, dtype=np.float64)
    g = np.exp(-0.5 * (x / sigma) ** 2)
    return (g / g.sum()).astype(np.float32)


def _filter2(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Separable 'valid' filtering of each channel of (B, C, H, W)."""
    c, k = x.shape[1], taps.numel()
    x = F.conv2d(x, taps.view(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    return F.conv2d(x, taps.view(1, 1, 1, k).expand(c, 1, 1, k), groups=c)


def ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """Mean SSIM over channels and pixels, Gaussian-weighted windows and
    population covariance (the protocol of reference metric_utils.py:51).
    a, b: (B, C, H, W) float. Returns (B,)."""
    a, b = a.float(), b.float()
    taps = torch.from_numpy(_gaussian_kernel()).to(a.device)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a, mu_b = _filter2(a, taps), _filter2(b, taps)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    var_a = _filter2(a * a, taps) - mu_aa
    var_b = _filter2(b * b, taps) - mu_bb
    cov = _filter2(a * b, taps) - mu_ab
    s = ((2 * mu_ab + c1) * (2 * cov + c2)) / ((mu_aa + mu_bb + c1) * (var_a + var_b + c2))
    return s.mean(dim=(1, 2, 3))


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 255.0) -> torch.Tensor:
    """(B,) peak signal-to-noise ratio."""
    mse = (a.float() - b.float()).square().mean(dim=(1, 2, 3))
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(mse, min=1e-12))


def rmse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B,) root-mean-square error (on [0, 1] images in the reference
    protocol)."""
    return (a.float() - b.float()).square().mean(dim=(1, 2, 3)).sqrt()


def reconstruction_metrics(recons: np.ndarray, gts: np.ndarray, device=None) -> dict:
    """Batch eval after reference metric_utils.calculate_metrics: SSIM on
    [0, 1], PSNR on [0, 255], RMSE on [0, 1]. Inputs uint8 (or float in
    [0, 255]) NHWC; computed on `device` (CUDA unless "cpu" is given)."""
    dev = resolve_device(device)
    r, g = (torch.as_tensor(np.asarray(x, np.float32), device=dev).permute(0, 3, 1, 2)
            for x in (recons, gts))
    return {
        "ssim": float(ssim(g / 255.0, r / 255.0).mean()),
        "psnr": float(psnr(g, r, data_range=255.0).mean()),
        "rmse": float(rmse(g / 255.0, r / 255.0).mean()),
    }


def id_retrieval(query_embeddings: torch.Tensor, gallery_embeddings: torch.Tensor,
                 true_indices) -> float:
    """Top-1 ArcFace retrieval accuracy (reference
    metric/face_recognition/find_faces.py): the cosine similarity of
    L2-normalised embeddings; the share of queries whose nearest gallery
    item is the true one."""
    q, g = torch.as_tensor(query_embeddings), torch.as_tensor(gallery_embeddings)
    pred = torch.argmax(q @ g.to(q.device).T, dim=1)
    truth = torch.as_tensor(np.asarray(true_indices), device=pred.device)
    return float((pred == truth).float().mean())
