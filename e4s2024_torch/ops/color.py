"""Skin colour transfer: the classical modes of the reference's `ct_mode`
(reference swap_face_fine/color_transfer.py:164-530).

Counterpart of `e4s2024_tpu/ops/color.py`. The linear modes (lct: PCA,
rct: Reinhard LAB statistics, mkl: Monge-Kantorovich) and sot (sliced
optimal transport) run in torch on the images' device; idt (iterative
distribution transfer), hist (per-channel histogram matching) and mix (mkl,
then hist) are data-dependent resampling and run in numpy on the host, as
in the JAX package. Images are (H, W, 3) float RGB in [0, 1].
"""

from __future__ import annotations

import numpy as np
import torch

_XYZ = ((0.412453, 0.357580, 0.180423),
        (0.212671, 0.715160, 0.072169),
        (0.019334, 0.119193, 0.950227))
_XYZ_INV = ((3.240479, -1.537150, -0.498535),
            (-0.969256, 1.875992, 0.041556),
            (0.055648, -0.204043, 1.057311))
_WHITE = (0.950456, 1.0, 1.088754)


def _const(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=like.dtype, device=like.device)


def _srgb_to_linear(c):
    return torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _linear_to_srgb(c):
    c = torch.clamp(c, min=0.0)
    return torch.where(c <= 0.0031308, c * 12.92, 1.055 * c ** (1 / 2.4) - 0.055)


def _cbrt(t):
    return torch.sign(t) * t.abs() ** (1.0 / 3.0)


def _rgb_to_lab(rgb):
    """CIELAB (D65), cv2's float convention (sRGB gamma applied): L in [0, 100]."""
    xyz = _srgb_to_linear(rgb) @ _const(_XYZ, rgb).T / _const(_WHITE, rgb)

    def f(t):
        return torch.where(t > 0.008856, _cbrt(t), 7.787 * t + 16.0 / 116.0)

    fx, fy, fz = f(xyz[..., 0]), f(xyz[..., 1]), f(xyz[..., 2])
    y = xyz[..., 1]
    lum = torch.where(y > 0.008856, 116.0 * _cbrt(y) - 16.0, 903.3 * y)
    return torch.stack([lum, 500.0 * (fx - fy), 200.0 * (fy - fz)], dim=-1)


def _lab_to_rgb(lab):
    fy = (lab[..., 0] + 16.0) / 116.0
    fx = fy + lab[..., 1] / 500.0
    fz = fy - lab[..., 2] / 200.0

    def finv(t):
        t3 = t ** 3
        return torch.where(t3 > 0.008856, t3, (t - 16.0 / 116.0) / 7.787)

    xyz = torch.stack([finv(fx), finv(fy), finv(fz)], dim=-1) * _const(_WHITE, lab)
    return _linear_to_srgb(xyz @ _const(_XYZ_INV, lab).T)


def _masked_stats(x, w):
    n = torch.clamp(w.sum(), min=1.0)
    mean = (x * w[:, None]).sum(0) / n
    var = ((x - mean) ** 2 * w[:, None]).sum(0) / n
    return mean, torch.sqrt(var + 1e-8)


def reinhard_color_transfer(target: torch.Tensor, source: torch.Tensor,
                            target_mask: torch.Tensor | None = None,
                            source_mask: torch.Tensor | None = None) -> torch.Tensor:
    """rct: the target's per-channel LAB mean and std matched to the
    source's (reference color_transfer.py:294; Reinhard et al. 2001), over
    the pixels whose mask is >= 0.5 where masks are given."""
    t_lab = _rgb_to_lab(target).reshape(-1, 3)
    s_lab = _rgb_to_lab(source).reshape(-1, 3)

    def weights(m, n, like):
        return (torch.ones(n, dtype=like.dtype, device=like.device) if m is None
                else (m.reshape(-1) >= 0.5).to(like.dtype))

    t_mean, t_std = _masked_stats(t_lab, weights(target_mask, t_lab.shape[0], t_lab))
    s_mean, s_std = _masked_stats(s_lab, weights(source_mask, s_lab.shape[0], s_lab))
    out = ((t_lab - t_mean) * (s_std / t_std) + s_mean).reshape(target.shape)
    return torch.clamp(_lab_to_rgb(out), 0.0, 1.0)


def _cov(x):
    mean = x.mean(0)
    xc = x - mean
    return xc.T @ xc / (x.shape[0] - 1), mean


def linear_color_transfer(target: torch.Tensor, source: torch.Tensor,
                          eps: float = 1e-5) -> torch.Tensor:
    """lct, PCA mode: whiten the target's colour covariance and colour it
    with the source's (reference color_transfer.py:345)."""
    t, s = target.reshape(-1, 3), source.reshape(-1, 3)
    ct, mt = _cov(t)
    cs, ms = _cov(s)
    eye = torch.eye(3, dtype=t.dtype, device=t.device)
    dt, ut = torch.linalg.eigh(ct + eps * eye)
    ds, us = torch.linalg.eigh(cs + eps * eye)
    qt = ut @ torch.diag(torch.sqrt(torch.clamp(dt, min=eps))) @ ut.T
    qs = us @ torch.diag(torch.sqrt(torch.clamp(ds, min=eps))) @ us.T
    m = qs @ torch.linalg.inv(qt)
    return torch.clamp(((t - mt) @ m.T + ms).reshape(target.shape), 0.0, 1.0)


def color_transfer_mkl(x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """Monge-Kantorovich linear transfer of x0's colours toward x1's
    (reference color_transfer.py:218; Pitie and Kokaram 2007)."""
    eps = 1e-12
    a_flat, b_flat = x0.reshape(-1, 3), x1.reshape(-1, 3)
    a, ma = _cov(a_flat)
    b, mb = _cov(b_flat)
    da2, ua = torch.linalg.eigh(a)
    da = torch.sqrt(torch.clamp(da2, min=eps))
    c = (da[:, None] * (ua.T @ b @ ua)) * da[None, :]
    dc2, uc = torch.linalg.eigh(c)
    dc = torch.sqrt(torch.clamp(dc2, min=eps))
    da_inv = 1.0 / da
    t = (ua * da_inv[None, :]) @ (uc * dc[None, :]) @ uc.T @ (da_inv[:, None] * ua.T)
    return torch.clamp(((a_flat - ma) @ t + mb).reshape(x0.shape), 0.0, 1.0)


def sot_directions(steps: int = 10, batch_size: int = 5, channels: int = 3,
                   generator: torch.Generator | None = None, device=None) -> torch.Tensor:
    """(steps, batch_size, channels) standard-normal projection directions
    for `color_transfer_sot`, drawn from `generator` (a fresh one seeded 0
    when none is given)."""
    if generator is None:
        generator = torch.Generator(device=device or "cpu").manual_seed(0)
    return torch.randn(steps, batch_size, channels, generator=generator,
                       device=generator.device)


def color_transfer_sot(src: torch.Tensor, trg: torch.Tensor, *, steps: int = 10,
                       batch_size: int = 5, directions: torch.Tensor | None = None,
                       generator: torch.Generator | None = None) -> torch.Tensor:
    """Sliced optimal transport (reference color_transfer.py:164): per step,
    src's colours advance along `batch_size` 1-D projections by the sort
    matching of their projections onto trg's, averaged over the projections.
    `directions` (steps, batch_size, 3), unnormalised, or drawn by
    `sot_directions` from `generator`. The sorts are stable, as jnp.argsort
    is."""
    h, w, c = src.shape
    x, y = src.reshape(-1, c), trg.reshape(-1, c)
    if directions is None:
        directions = sot_directions(steps, batch_size, c, generator, src.device)
    directions = directions.to(device=src.device, dtype=src.dtype)
    for step in range(directions.shape[0]):
        adv = torch.zeros_like(x)
        for d in directions[step]:
            d = d / torch.linalg.vector_norm(d)
            px, py = x @ d, y @ d
            ix = torch.argsort(px, stable=True)
            iy = torch.argsort(py, stable=True)
            adv.index_add_(0, ix, (py[iy] - px[ix])[:, None] * d[None, :])
        x = x + adv / directions.shape[1]
    return torch.clamp(x.reshape(h, w, c), 0.0, 1.0)


def channel_hist_match(source: np.ndarray, template: np.ndarray) -> np.ndarray:
    """One channel's histogram matched to a template's (reference
    color_transfer.py:409)."""
    s = source.ravel()
    s_values, bin_idx, s_counts = np.unique(s, return_inverse=True, return_counts=True)
    t_values, t_counts = np.unique(template.ravel(), return_counts=True)
    s_quantiles = np.cumsum(s_counts).astype(np.float64) / s.size
    t_quantiles = np.cumsum(t_counts).astype(np.float64) / template.size
    return np.interp(s_quantiles, t_quantiles, t_values)[bin_idx].reshape(source.shape)


def color_hist_match(src: np.ndarray, trg: np.ndarray) -> np.ndarray:
    """Per-channel histogram matching (reference color_transfer.py:437)."""
    out = np.stack([channel_hist_match(src[..., i], trg[..., i])
                    for i in range(src.shape[-1])], axis=-1)
    return np.clip(out, 0.0, 1.0).astype(src.dtype)


def color_transfer_idt(i0: np.ndarray, i1: np.ndarray, bins: int = 256, n_rot: int = 20,
                       seed: int = 0) -> np.ndarray:
    """Iterative distribution transfer (reference color_transfer.py:249):
    histogram matching along `n_rot` random rotations."""
    from scipy.stats import special_ortho_group

    rng = np.random.default_rng(seed)
    h, w, c = i0.shape
    d0 = i0.reshape(-1, c).T.astype(np.float64)
    d1 = i1.reshape(-1, c).T.astype(np.float64)
    relaxation = 1.0 / n_rot
    for _ in range(n_rot):
        r = special_ortho_group.rvs(c, random_state=rng)
        d0r, d1r = r @ d0, r @ d1
        d_r = np.empty_like(d0r)
        for j in range(c):
            lo = min(d0r[j].min(), d1r[j].min())
            hi = max(d0r[j].max(), d1r[j].max())
            p0r, edges = np.histogram(d0r[j], bins=bins, range=(lo, hi))
            p1r, _ = np.histogram(d1r[j], bins=bins, range=(lo, hi))
            cp0r = p0r.cumsum().astype(np.float64)
            cp0r /= max(cp0r[-1], 1)
            cp1r = p1r.cumsum().astype(np.float64)
            cp1r /= max(cp1r[-1], 1)
            f = np.interp(cp0r, cp1r, edges[1:])
            d_r[j] = np.interp(d0r[j], edges[1:], f, left=0, right=bins)
        d0 = relaxation * np.linalg.solve(r, d_r - d0r) + d0
    return np.clip(d0.T.reshape(h, w, c), 0.0, 1.0).astype(i0.dtype)


def color_transfer_mix(src: np.ndarray, trg: np.ndarray) -> np.ndarray:
    """mkl, then per-channel histogram matching (reference
    color_transfer.py:451). numpy in and out; mkl runs in torch on the CPU
    in float32."""
    stage1 = color_transfer_mkl(torch.from_numpy(np.asarray(src, np.float32)),
                                torch.from_numpy(np.asarray(trg, np.float32))).numpy()
    return color_hist_match(stage1, trg)


DEVICE_MODES = ("lct", "rct", "mkl", "sot")
HOST_MODES = ("idt", "hist", "mix", "adaptive")


def skin_color_transfer(img, ref, mode: str = "rct",
                        generator: torch.Generator | None = None):
    """The reference's ct_mode switch (color_transfer.py:477+). img, ref:
    (H, W, 3) float RGB in [0, 1]; tensors for the device modes (lct, rct,
    mkl, sot; the result is a tensor on img's device), numpy for the host
    modes (idt, hist, mix or adaptive; numpy out). `generator` draws sot's
    directions."""
    if mode == "lct":
        return linear_color_transfer(img, ref)
    if mode == "rct":
        return reinhard_color_transfer(img, ref)
    if mode == "mkl":
        return color_transfer_mkl(img, ref)
    if mode == "sot":
        return color_transfer_sot(img, ref, generator=generator)
    if mode == "idt":
        return color_transfer_idt(img, ref)
    if mode == "hist":
        return color_hist_match(img, ref)
    if mode in ("mix", "adaptive"):
        return color_transfer_mix(img, ref)
    raise ValueError(f"unknown color transfer mode {mode!r}")
