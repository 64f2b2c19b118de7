"""The port's ops (e4s2024_torch.ops) against the JAX package's, on the CPU.

Inputs come from numpy seeds and go to both sides, NHWC for JAX and NCHW for
the port. The three kernels' plain versions are also held against the Pallas
kernels run in interpret mode, as tests/test_pallas_kernels.py runs them.
Both sides compute in float32; each test states its tolerance.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from e4s2024_tpu.ops import blend as jblend
from e4s2024_tpu.ops import fused_act as jfused
from e4s2024_tpu.ops import modconv as jmodconv
from e4s2024_tpu.ops import morphology as jmorph
from e4s2024_tpu.ops import pool as jpool
from e4s2024_tpu.ops import resize as jresize
from e4s2024_tpu.ops import upfirdn as jup
from e4s2024_tpu.ops.pallas import blur3x3_tpu, fused_leaky_relu_tpu, modulate_demodulate_tpu

from e4s2024_torch import kernels
from e4s2024_torch.ops import blend, fused_act, modconv, modulate, morphology, pool, resize, upfirdn

# float32 on both sides; differences come from summation order only
ATOL = 1e-5


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def one_hot(rng, b, h, w, k):
    return np.eye(k, dtype=np.float32)[rng.integers(0, k, (b, h, w))]  # (B, H, W, K)


# ------------------------------------------------------------------ K1


@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (1, 7, 11, 8), (3, 5)])
@pytest.mark.parametrize("with_bias", [True, False])
def test_fused_leaky_relu_matches_jax(rng, shape, with_bias):
    x = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal(shape[-1]).astype(np.float32) if with_bias else None
    want = np.asarray(jfused.fused_leaky_relu(jnp.asarray(x), None if b is None else jnp.asarray(b)))
    xt = nchw(x) if x.ndim == 4 else torch.from_numpy(x)
    got = fused_act.fused_leaky_relu(xt, None if b is None else torch.from_numpy(b))
    got = nhwc(got) if x.ndim == 4 else got.numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-6)
    if b is not None:  # the Pallas kernel itself, interpret mode
        pallas = np.asarray(fused_leaky_relu_tpu(jnp.asarray(x), jnp.asarray(b), interpret=True))
        np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=1e-6)


def test_scaled_leaky_relu_matches_jax(rng):
    x = rng.standard_normal((2, 6, 6, 4)).astype(np.float32)
    want = np.asarray(jfused.scaled_leaky_relu(jnp.asarray(x)))
    np.testing.assert_allclose(nhwc(fused_act.scaled_leaky_relu(nchw(x))), want, atol=ATOL)


# ------------------------------------------------------------------ K2

BLUR = np.outer([1.0, 3.0, 3.0, 1.0], [1.0, 3.0, 3.0, 1.0]).astype(np.float32)
BLUR /= BLUR.sum()

# every (up, down, pad, gain) the port runs, plus blur3x3_tpu's own case
UPFIRDN_CASES = [
    pytest.param(1, 1, (2, 1), 1.0, 16, id="blur3x3-pad21"),
    pytest.param(1, 1, (1, 1), 4.0, 17, id="after-transposed-conv"),
    pytest.param(2, 1, (2, 1), 4.0, 8, id="torgb-skip-up2"),
    pytest.param(1, 2, (1, 1), 1.0, 16, id="downsample-2x"),
    pytest.param(1, 1, (-1, 2), 1.0, 9, id="negative-pad-crops"),
]


@pytest.mark.parametrize("up,down,pad,gain,size", UPFIRDN_CASES)
def test_upfirdn2d_matches_jax(rng, up, down, pad, gain, size):
    x = rng.standard_normal((2, size, size + 1, 3)).astype(np.float32)
    # an asymmetric kernel catches a missing flip
    k = (BLUR + 0.01 * rng.standard_normal(BLUR.shape)).astype(np.float32) * gain
    want = np.asarray(jup.upfirdn2d(jnp.asarray(x), jnp.asarray(k), up=up, down=down, pad=pad))
    got = nhwc(upfirdn.upfirdn2d(nchw(x), torch.from_numpy(k), up=up, down=down, pad=pad))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5)


def test_upfirdn2d_matches_pallas_blur(rng):
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    taps = np.array([1.0, 3.0, 3.0, 1.0], np.float32) / 8.0
    want = np.asarray(blur3x3_tpu(jnp.asarray(x), tuple(float(t) for t in taps), interpret=True))
    got = nhwc(upfirdn.upfirdn2d(nchw(x), torch.from_numpy(np.outer(taps, taps)), pad=(2, 1)))
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("which", ["upsample_2x", "downsample_2x", "blur"])
def test_resampling_helpers_match_jax(rng, which):
    x = rng.standard_normal((1, 8, 8, 5)).astype(np.float32)
    kj, kt = jup.make_kernel([1, 3, 3, 1]), upfirdn.make_kernel([1, 3, 3, 1])
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=0)
    if which == "blur":
        want = jup.blur(jnp.asarray(x), kj, pad=(1, 1), upsample_factor=2)
        got = upfirdn.blur(nchw(x), kt, pad=(1, 1), upsample_factor=2)
    else:
        want = getattr(jup, which)(jnp.asarray(x), kj)
        got = getattr(upfirdn, which)(nchw(x), kt)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL)


# ------------------------------------------------------------------ K3


@pytest.mark.parametrize("b,h,w,c,k", [(2, 8, 8, 32, 12), (1, 5, 7, 3, 12), (1, 4, 4, 70, 3)])
def test_regional_scale_matches_jax(rng, b, h, w, c, k):
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    seg = one_hot(rng, b, h, w, k)
    s = rng.standard_normal((b, k, c)).astype(np.float32)
    pallas = np.asarray(modulate_demodulate_tpu(jnp.asarray(x), jnp.asarray(seg), jnp.asarray(s),
                                                interpret=True))
    einsum = x * np.einsum("bhwk,bkc->bhwc", seg, s)
    got = nhwc(modulate.regional_scale(nchw(x), nchw(seg), torch.from_numpy(s)))
    np.testing.assert_allclose(got, pallas, atol=ATOL)
    np.testing.assert_allclose(got, einsum, atol=ATOL)


# ---------------------------------------------------- wrappers on the CPU


def test_wrappers_take_plain_versions_on_cpu(rng):
    """On CPU tensors the wrappers equal their plain versions bit for bit and
    launch nothing."""
    kernels.reset_launch_counts()
    x = torch.from_numpy(rng.standard_normal((1, 4, 9, 9)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(4).astype(np.float32))
    seg = nchw(one_hot(rng, 1, 9, 9, 12))
    s = torch.from_numpy(rng.standard_normal((1, 12, 4)).astype(np.float32))
    k = upfirdn.make_kernel([1, 3, 3, 1])
    assert torch.equal(fused_act.fused_leaky_relu(x, b), fused_act.fused_leaky_relu_plain(x, b))
    assert torch.equal(upfirdn.upfirdn2d(x, k, up=2, pad=(2, 1)),
                       upfirdn.upfirdn2d_plain(x, k, up=2, pad=(2, 1)))
    assert torch.equal(modulate.regional_scale(x, seg, s), modulate.regional_scale_plain(x, seg, s))
    assert kernels.launch_counts() == dict.fromkeys(kernels.WRAPPERS, 0)


# ------------------------------------------------------------- resizing


@pytest.mark.parametrize("src,dst", [((16, 16), (8, 8)), ((4, 6), (8, 12)), ((10, 7), (6, 9))])
def test_resize_nearest_matches_jax(rng, src, dst):
    x = rng.standard_normal((2, *src, 3)).astype(np.float32)
    want = np.asarray(jresize.resize_nearest(jnp.asarray(x), dst))
    np.testing.assert_array_equal(nhwc(resize.resize_nearest(nchw(x), dst)), want)


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("src,dst", [((16, 12), (32, 20)), ((64, 64), (17, 23))])
def test_resize_bilinear_matches_jax(rng, align_corners, src, dst):
    x = rng.standard_normal((2, *src, 3)).astype(np.float32)
    fn = jresize.resize_bilinear_align_corners if align_corners else jresize.resize_bilinear
    want = np.asarray(fn(jnp.asarray(x), dst))
    got = nhwc(resize.resize_bilinear(nchw(x), dst, align_corners=align_corners))
    np.testing.assert_allclose(got, want, atol=ATOL)
    # the JAX planar form is the same function on (..., H, W)
    planar = np.asarray(jresize.resize_bilinear_planar(jnp.asarray(x.transpose(0, 3, 1, 2)), dst,
                                                       align_corners=align_corners))
    np.testing.assert_allclose(got.transpose(0, 3, 1, 2), planar, atol=ATOL)


def test_max_pool_matches_jax(rng):
    x = rng.standard_normal((2, 15, 16, 4)).astype(np.float32)
    want = np.asarray(jpool.max_pool2d(jnp.asarray(x), 3, 2, padding=1))
    np.testing.assert_array_equal(nhwc(pool.max_pool2d(nchw(x), 3, 2, padding=1)), want)


@pytest.mark.parametrize("size", [5, 4])
def test_dilation_planar_matches_jax(rng, size):
    t = (rng.random((2, 2, 16, 13)) > 0.7).astype(np.float32) * rng.random((2, 2, 16, 13)).astype(
        np.float32)
    np.testing.assert_array_equal(
        morphology.dilation_planar(torch.from_numpy(t), size).numpy(),
        np.asarray(jmorph.dilation_planar(jnp.asarray(t), size)))
    # erosion as the swap computes it: the negated dilation of -t
    np.testing.assert_array_equal(
        -morphology.dilation_planar(-torch.from_numpy(t), size).numpy(),
        np.asarray(jmorph.erosion_planar(jnp.asarray(t), size)))


# ---------------------------------------------------------- compositing


def test_soft_erosion_planar_matches_jax(rng):
    m = np.zeros((2, 3, 48, 40), np.float32)
    m[:, :, 10:38, 8:30] = 1.0
    m[:, 1] *= rng.random((2, 48, 40)).astype(np.float32)
    soft_j, hard_j = jblend.soft_erosion_planar(jnp.asarray(m))
    soft, hard = blend.soft_erosion_planar(torch.from_numpy(m))
    np.testing.assert_allclose(soft.numpy(), np.asarray(soft_j), atol=1e-5)
    np.testing.assert_array_equal(hard.numpy(), np.asarray(hard_j))


@pytest.mark.parametrize("levels", [4, 10])
def test_laplacian_blend_planar_matches_jax(rng, levels):
    a = (rng.random((1, 3, 64, 64)) * 255).astype(np.float32)
    b = (rng.random((1, 3, 64, 64)) * 255).astype(np.float32)
    m = rng.random((1, 1, 64, 64)).astype(np.float32)
    want = np.asarray(jblend.laplacian_pyramid_blend_planar(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(m), num_levels=levels))
    got = blend.laplacian_pyramid_blend_planar(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(m), num_levels=levels)
    # values in [0, 255]; float32 rounding over up to 6 levels
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3)


# ----------------------------------------------------- modulated convs


def _modconv_inputs(rng, b, cin, cout, h, k_sz):
    x = rng.standard_normal((b, h, h, cin)).astype(np.float32)
    w = rng.standard_normal((k_sz, k_sz, cin, cout)).astype(np.float32)
    return x, w, torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("demod", [True, False])
@pytest.mark.parametrize("up,down", [(False, False), (True, False), (False, True)])
def test_modulated_conv_matches_jax(rng, demod, up, down):
    x, w, wt = _modconv_inputs(rng, 2, 8, 12, 16, 3)
    s = (rng.standard_normal((2, 8)) * 0.2 + 1.0).astype(np.float32)
    bk = jup.make_kernel([1, 3, 3, 1])
    want = np.asarray(jmodconv.modulated_conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
                                                demodulate=demod, up=up, down=down, blur_kernel=bk))
    got = modconv.modulated_conv2d(nchw(x), wt, torch.from_numpy(s), demodulate=demod, up=up,
                                   down=down, blur_kernel=upfirdn.make_kernel([1, 3, 3, 1]))
    np.testing.assert_allclose(nhwc(got), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("mode", ["exact", "fast"])
@pytest.mark.parametrize("up,k_sz,demod", [(False, 3, True), (True, 3, True), (False, 1, False)])
def test_regional_modulated_conv_matches_jax(rng, mode, up, k_sz, demod):
    """exact against exact and fast against fast: the two modes differ at
    region boundaries by design, so they are never compared across."""
    b, cin, cout, h, k = 2, 6, 10, 8, 12
    x, w, wt = _modconv_inputs(rng, b, cin, cout, h, k_sz)
    s = (rng.standard_normal((b, k, cin)) * 0.2 + 1.0).astype(np.float32)
    seg = one_hot(rng, b, 4 * h, 4 * h, k)  # resized (nearest) inside
    want = np.asarray(jmodconv.regional_modulated_conv2d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(s), jnp.asarray(seg), demodulate=demod, up=up,
        blur_kernel=jup.make_kernel([1, 3, 3, 1]), mode=mode))
    got = modconv.regional_modulated_conv2d(
        nchw(x), wt, torch.from_numpy(s), nchw(seg), demodulate=demod, up=up,
        blur_kernel=upfirdn.make_kernel([1, 3, 3, 1]), mode=mode)
    assert nhwc(got).shape == want.shape
    np.testing.assert_allclose(nhwc(got), want, atol=1e-4, rtol=1e-4)


def test_regional_mode_rejects_unknown(rng):
    x = torch.zeros(1, 2, 4, 4)
    with pytest.raises(ValueError):
        modconv.regional_modulated_conv2d(x, torch.zeros(3, 2, 3, 3), torch.zeros(1, 12, 2),
                                          torch.zeros(1, 12, 4, 4), mode="approx")
