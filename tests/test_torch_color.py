"""The port's classical colour transfer (e4s2024_torch.ops.color) against
the JAX package's `skin_color_transfer`, every mode, on the CPU.

Outputs are compared, not eigenvectors: `eigh`'s signs may differ between
the two, and lct and mkl do not depend on them. sot is fed the projection
directions that JAX's PRNGKey(0) draws.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from e4s2024_tpu.ops import color as jcolor

from e4s2024_torch.ops import color
from tests.test_torch_criterion import two_threads  # noqa: F401  (autouse fixture)


def _images(seed, shape=(24, 32, 3)):
    """A smooth colour field plus noise, in [0, 1]: continuous values, so
    that sorts and histograms have no ties."""
    rng = np.random.default_rng(seed)
    coarse = rng.random((4, 4, 3))
    img = np.kron(coarse, np.ones((shape[0] // 4, shape[1] // 4, 1))) * 0.8
    return (img + rng.random(shape) * 0.2).astype(np.float32)


def jax_sot_directions(seed=0, steps=10, batch_size=5, c=3):
    """The directions color_transfer_sot draws from PRNGKey(seed)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), steps)
    return np.stack([np.stack([np.asarray(jax.random.normal(k, (c,)))
                               for k in jax.random.split(key, batch_size)])
                     for key in keys])


@pytest.mark.parametrize("mode", ["lct", "rct", "mkl"])
def test_device_modes_match_jax(mode):
    img, ref = _images(1), _images(2)
    want = np.asarray(jcolor.skin_color_transfer(img, ref, mode))
    got = color.skin_color_transfer(torch.from_numpy(img), torch.from_numpy(ref), mode).numpy()
    assert got.shape == img.shape and got.dtype == np.float32
    # float32 statistics of 768 pixels, 3x3 eigen-decompositions and (rct)
    # LAB round trips through cube roots and powers, in other orders
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.abs(got - img).mean() > 1e-3  # the transfer moved the colours


def test_sot_matches_jax():
    img, ref = _images(3), _images(4)
    dirs = jax_sot_directions()
    want = np.asarray(jcolor.skin_color_transfer(img, ref, "sot"))
    got = color.color_transfer_sot(torch.from_numpy(img), torch.from_numpy(ref),
                                   directions=torch.from_numpy(dirs)).numpy()
    # 50 sort matchings; a projection one ulp apart in the two may swap two
    # neighbours' ranks and so their targets, a step of one sorted gap
    # (measured: 1.2e-7, no swap)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.abs(got - img).mean() > 1e-3


def test_sot_directions_from_a_generator():
    gen = torch.Generator().manual_seed(5)
    d = color.sot_directions(generator=gen)
    assert d.shape == (10, 5, 3)
    img, ref = torch.from_numpy(_images(6)), torch.from_numpy(_images(7))
    a = color.color_transfer_sot(img, ref, generator=torch.Generator().manual_seed(5))
    b = color.color_transfer_sot(img, ref, directions=d)
    assert torch.equal(a, b)
    np.testing.assert_array_equal(
        color.skin_color_transfer(img, ref, "sot").numpy(),
        color.color_transfer_sot(img, ref, directions=color.sot_directions()).numpy())


@pytest.mark.parametrize("mode", ["idt", "hist", "mix"])
def test_host_modes_match_jax(mode):
    """numpy on the host on both sides, the image float32 and the reference
    float64 as the pipelines pass them."""
    img, ref = _images(8), _images(9).astype(np.float64)
    want = jcolor.skin_color_transfer(img, ref, mode)
    got = color.skin_color_transfer(img, ref, mode)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    if mode == "mix":
        # mkl in float32 (torch here, XLA there), then the same histogram match
        np.testing.assert_allclose(got, want, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


def test_masked_reinhard_and_bad_mode():
    img, ref = _images(10), _images(11)
    m = np.zeros(img.shape[:2], np.float32)
    m[4:20, 6:26] = 1.0
    want = np.asarray(jcolor.reinhard_color_transfer(
        jnp.asarray(img), jnp.asarray(ref), jnp.asarray(m), jnp.asarray(1 - m)))
    got = color.reinhard_color_transfer(torch.from_numpy(img), torch.from_numpy(ref),
                                        torch.from_numpy(m), torch.from_numpy(1 - m)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    with pytest.raises(ValueError, match="unknown color transfer mode"):
        color.skin_color_transfer(img, ref, "nope")
