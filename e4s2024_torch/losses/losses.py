"""Training losses (reference criteria/), counterpart of
`e4s2024_tpu/losses/losses.py` in NCHW.

Adversarial softplus losses (adv_loss.py:8-25), the R1 gradient penalty
(adv_loss.py:29-40), the W-norm (w_norm.py), the path-length penalty, and
the multiscale feature-cosine loss shared by IDLoss (id_loss.py:31-57) and
FaceParsingLoss (face_parsing_loss.py:53-78).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from e4s2024_torch.ops.pool import adaptive_avg_pool2d


def adv_g_loss(fake_pred: torch.Tensor) -> torch.Tensor:
    """Non-saturating generator loss (reference adv_loss.py:13)."""
    return F.softplus(-fake_pred).mean()


def adv_d_loss(real_pred: torch.Tensor, fake_pred: torch.Tensor) -> torch.Tensor:
    """Discriminator loss (reference adv_loss.py:22)."""
    return F.softplus(-real_pred).mean() + F.softplus(fake_pred).mean()


def r1_penalty(d_apply: Callable[[torch.Tensor], torch.Tensor],
               real_img: torch.Tensor) -> torch.Tensor:
    """R1 gradient penalty, E[||grad_x D(x)||^2] (reference adv_loss.py:29),
    differentiable through `torch.autograd.grad(create_graph=True)`.

    On a card the double backward runs through the kernels: K1's and K2's
    backwards are differentiable, their gradients launching the same
    kernels again (`fused_leaky_relu_double_backward`,
    `upfirdn2d_double_backward`). K3's is once-differentiable, so a
    `d_apply` that runs K3 raises here; the Discriminator runs none."""
    x = real_img.detach().requires_grad_(True)
    (grad,) = torch.autograd.grad(d_apply(x).sum(), x, create_graph=True)
    return grad.square().reshape(grad.shape[0], -1).sum(dim=1).mean()


def w_norm_loss(latent: torch.Tensor, latent_avg: torch.Tensor | None = None,
                start_from_latent_avg: bool = True) -> torch.Tensor:
    """||w - w_avg||_2 over (layer, dim), averaged over (batch, component)
    (reference w_norm.py:11). latent: (B, K, n_latent, 512)."""
    if start_from_latent_avg and latent_avg is not None:
        latent = latent - latent_avg
    norms = torch.sqrt(latent.square().sum(dim=(2, 3)))
    return norms.sum() / (latent.shape[0] * latent.shape[1])


def feature_cosine_loss(feats_pred: Sequence[torch.Tensor],
                        feats_target: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum over scales of mean_i (1 - <f(y_hat)_i, f(y)_i>); the targets are
    detached (reference id_loss.py:40-56). The extractors L2-normalise. The
    dot products accumulate in float64 (features of up to 4M elements)."""
    total = 0.0
    for fp, ft in zip(feats_pred, feats_target):
        sim = (fp * ft.detach()).sum(dim=-1, dtype=torch.float64)
        total = total + (1.0 - sim).mean().to(fp.dtype)
    return total


def id_loss_crop(x: torch.Tensor) -> torch.Tensor:
    """The IDLoss input pipeline (reference id_loss.py:24-28): adaptive pool
    to 256, rows 35:223 and columns 32:220, adaptive pool to 112. NCHW."""
    if x.shape[2] != 256:
        x = adaptive_avg_pool2d(x, (256, 256))
    return adaptive_avg_pool2d(x[:, :, 35:223, 32:220], (112, 112))


def multiscale_lpips(lpips_apply: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                     y_hat: torch.Tensor, y: torch.Tensor, n_scales: int = 3,
                     min_size: int = 31) -> torch.Tensor:
    """LPIPS summed over an adaptive-average-pool pyramid (full, /2, /4),
    as reference training/coach.py:476-487; scales under `min_size` px,
    where AlexNet's pools leave no pixel, are skipped (the JAX package's
    extension for tiny configurations)."""
    total = 0.0
    size = y_hat.shape[2]
    for i in range(n_scales):
        s = size // 2 ** i
        if s < min_size:
            break
        total = total + lpips_apply(adaptive_avg_pool2d(y_hat, (s, s)),
                                    adaptive_avg_pool2d(y, (s, s)))
    return total


def g_path_lengths_penalty(grads: torch.Tensor, mean_path_length: torch.Tensor,
                           decay: float = 0.01):
    """StyleGAN2 path-length regulariser (reference adv_loss.py:43-59). grads:
    d<fake, noise>/d latents, (B, n_latent, 512). Returns (penalty, the
    updated mean path length, detached, path lengths)."""
    path_lengths = torch.sqrt(grads.square().sum(dim=2).mean(dim=1))
    path_mean = mean_path_length + decay * (path_lengths.mean() - mean_path_length)
    penalty = (path_lengths - path_mean).square().mean()
    return penalty, path_mean.detach(), path_lengths
