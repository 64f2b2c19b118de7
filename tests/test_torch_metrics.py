"""The port's evaluation metrics (e4s2024_torch.metrics) against the JAX
package's (e4s2024_tpu.metrics), on the CPU, on the same seeded arrays."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from e4s2024_tpu import metrics as jmetrics

from e4s2024_torch import metrics
from tests.test_torch_criterion import nchw, two_threads  # noqa: F401


def _pair(seed, shape=(2, 40, 48, 3)):
    rng = np.random.default_rng(seed)
    a = rng.random(shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("data_range", [1.0, 255.0])
def test_ssim_psnr_rmse_match_jax(data_range):
    """Per-image SSIM (Gaussian 11x11, sigma 1.5, population covariance,
    'valid' filtering), PSNR and RMSE within 1e-5 relative of JAX's."""
    a, b = _pair(0)
    a, b = a * data_range, b * data_range
    np.testing.assert_allclose(
        metrics.ssim(nchw(a), nchw(b), data_range=data_range).numpy(),
        np.asarray(jmetrics.ssim(jnp.asarray(a), jnp.asarray(b), data_range=data_range)),
        rtol=1e-5)
    np.testing.assert_allclose(
        metrics.psnr(nchw(a), nchw(b), data_range=data_range).numpy(),
        np.asarray(jmetrics.psnr(jnp.asarray(a), jnp.asarray(b), data_range=data_range)),
        rtol=1e-5)
    np.testing.assert_allclose(metrics.rmse(nchw(a), nchw(b)).numpy(),
                               np.asarray(jmetrics.rmse(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-5)


def test_ssim_of_an_image_with_itself_is_one():
    a, _ = _pair(1)
    np.testing.assert_allclose(metrics.ssim(nchw(a), nchw(a)).numpy(), 1.0, atol=1e-6)
    assert float(metrics.psnr(nchw(a), nchw(a), data_range=1.0)[0]) > 100


def test_reconstruction_metrics_match_jax():
    """uint8 NHWC batches in, JAX's dict out: each value within 1e-5
    relative."""
    rng = np.random.default_rng(2)
    gts = (rng.random((3, 32, 32, 3)) * 255).astype(np.uint8)
    recons = np.clip(gts.astype(np.int16) + rng.integers(-20, 21, gts.shape), 0, 255)
    recons = recons.astype(np.uint8)
    got = metrics.reconstruction_metrics(recons, gts, device="cpu")
    want = jmetrics.reconstruction_metrics(recons, gts)
    assert set(got) == set(want) == {"ssim", "psnr", "rmse"}
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5), k


def test_id_retrieval_matches_jax():
    """Top-1 cosine retrieval: the same accuracy as JAX's, with some queries
    matched to the wrong gallery item."""
    rng = np.random.default_rng(3)
    gallery = rng.standard_normal((8, 16)).astype(np.float32)
    gallery /= np.linalg.norm(gallery, axis=1, keepdims=True)
    query = gallery[[3, 1, 7, 0, 5]] + 0.9 * rng.standard_normal((5, 16)).astype(np.float32)
    query /= np.linalg.norm(query, axis=1, keepdims=True)
    truth = np.array([3, 1, 7, 0, 5])
    got = metrics.id_retrieval(torch.from_numpy(query), torch.from_numpy(gallery), truth)
    want = jmetrics.id_retrieval(jnp.asarray(query), jnp.asarray(gallery), truth)
    assert got == pytest.approx(want)
    assert metrics.id_retrieval(torch.from_numpy(gallery), torch.from_numpy(gallery),
                                np.arange(8)) == 1.0
