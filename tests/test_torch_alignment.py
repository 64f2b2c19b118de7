"""The port's alignment and landmark helpers (e4s2024_torch.pipelines.
alignment, pipelines.landmarks) against the JAX package's, on the CPU.

The numpy functions are copies: equal results. The resampling runs the JAX
package's float32 arithmetic in its order, but XLA may contract a multiply
and an add into one rounding where PyTorch rounds twice, so a sample
position may differ by an ulp (under 1e-5 px at these coordinates). On the
noise images below, where neighbours differ by up to 255 levels, that is up
to 3e-3 of a level: the gathers are compared within 5e-3.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from e4s2024_tpu.pipelines import alignment as jal
from e4s2024_tpu.pipelines import landmarks as jlm

from e4s2024_torch.pipelines import alignment as al
from e4s2024_torch.pipelines import landmarks as lmk

LEVELS = 5e-3


def face_landmarks(rng, cx=60.0, cy=50.0, s=20.0):
    """68 points with eyes and mouth where a face has them, jittered."""
    lm = np.stack([cx + s * rng.uniform(-1, 1, 68), cy + s * rng.uniform(-1, 1, 68)], 1)
    lm[36:42] = [cx - 0.4 * s, cy - 0.3 * s] + rng.normal(0, 0.5, (6, 2))
    lm[42:48] = [cx + 0.4 * s, cy - 0.25 * s] + rng.normal(0, 0.5, (6, 2))
    lm[48], lm[54] = [cx - 0.3 * s, cy + 0.5 * s], [cx + 0.3 * s, cy + 0.55 * s]
    return lm


def _image(seed, h=90, w=120):
    return (np.random.default_rng(seed).random((h, w, 3)) * 255).astype(np.uint8)


def test_quad_math_matches_jax():
    rng = np.random.default_rng(0)
    for scale in (1.0, 1.3):
        lm = face_landmarks(rng)
        got, want = (al.compute_transform_from_landmarks(lm, scale),
                     jal.compute_transform_from_landmarks(lm, scale))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        quad = al.quad_from_cxy(*got)
        np.testing.assert_array_equal(quad, jal.quad_from_cxy(*want))
        np.testing.assert_array_equal(al.paste_back_coefficients(quad, 64),
                                      jal.paste_back_coefficients(quad, 64))
        np.testing.assert_array_equal(al.perspective_coefficients(quad, quad[::-1] * 2),
                                      jal.perspective_coefficients(quad, quad[::-1] * 2))
    frames = [al.compute_transform_from_landmarks(face_landmarks(rng)) for _ in range(9)]
    cs, xs, ys = (list(v) for v in zip(*frames))
    for sig in ((1.0, 3.0), (0.0, 2.0)):
        for g, w in zip(al.smooth_video_quads(cs, xs, ys, *sig),
                        jal.smooth_video_quads(cs, xs, ys, *sig)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("bad", ["coincident", "nan"])
def test_degenerate_landmarks_raise(bad):
    lm = np.full((68, 2), 30.0) if bad == "coincident" else face_landmarks(
        np.random.default_rng(1))
    if bad == "nan":
        lm[40, 0] = np.nan
    for mod in (al, jal):
        with pytest.raises(ValueError, match="degenerate"):
            mod.compute_transform_from_landmarks(lm)


def _quad(seed, c=(60.3, 44.2)):
    rng = np.random.default_rng(seed)
    x = np.array([30.0, 9.0]) + rng.normal(0, 2, 2)
    return al.quad_from_cxy(np.asarray(c), x, np.flipud(x) * [-1, 1])


def test_crop_quad_matches_jax():
    """One quad reaching past the top-left of the frame (zero-filled taps),
    then three at once, from a uint8 frame as the swap crops them."""
    img = _image(2)
    quads = np.stack([_quad(3, (25.0, 20.0)), _quad(4), _quad(5, (90.0, 70.0))])
    got = al.crop_quad(torch.from_numpy(img), al.as_f32(quads[0] + 0.5, "cpu"), 48).numpy()
    want = np.asarray(jal.crop_quad(jnp.asarray(img, jnp.float32),
                                    jnp.asarray(quads[0] + 0.5), 48))
    assert np.abs(got - want).max() <= LEVELS
    assert (got == 0).all(-1).any()  # the part outside the frame reads 0
    batch = al.crop_quad(torch.from_numpy(img), al.as_f32(quads + 0.5, "cpu"), 48).numpy()
    for i, q in enumerate(quads):
        want = np.asarray(jal.crop_quad(jnp.asarray(img, jnp.float32), jnp.asarray(q + 0.5), 48))
        assert np.abs(batch[i] - want).max() <= LEVELS
    # one quad per frame of a stack (the video landmarker's crops)
    frames = np.stack([_image(6), _image(7), _image(8)])
    per_frame = al.crop_quad(torch.from_numpy(frames), al.as_f32(quads + 0.5, "cpu"), 48)
    for i in range(3):
        want = np.asarray(jal.crop_quad(jnp.asarray(frames[i], jnp.float32),
                                        jnp.asarray(quads[i] + 0.5), 48))
        assert np.abs(per_frame[i].numpy() - want).max() <= LEVELS


def test_warp_perspective_matches_jax():
    crop = _image(9, 48, 48).astype(np.float32)
    coeffs = al.paste_back_coefficients(_quad(10), 48)
    got = al.warp_perspective(torch.from_numpy(crop), al.as_f32(coeffs, "cpu"), (90, 120))
    want = np.asarray(jal.warp_perspective(jnp.asarray(crop), jnp.asarray(coeffs), (90, 120)))
    assert got.shape == (90, 120, 3)
    assert np.abs(got.numpy() - want).max() <= LEVELS


def test_crop_and_warp_match_pil():
    """The PIL semantics themselves (tests/test_compositing.py's oracles)."""
    PIL = pytest.importorskip("PIL.Image")
    img = _image(11, 64, 64)
    quad = al.quad_from_cxy(np.array([30.3, 34.2]), np.array([14.1, 3.2]), np.array([-3.2, 14.1]))
    got = al.crop_quad(torch.from_numpy(img), al.as_f32(quad + 0.5, "cpu"), 32).numpy()
    want = np.asarray(PIL.fromarray(img).transform((32, 32), PIL.QUAD, (quad + 0.5).flatten(),
                                                   PIL.BILINEAR)).astype(np.float32)
    assert np.abs(got - want).mean() < 1.0  # the oracle rounds to uint8
    coeffs = al.perspective_coefficients(
        np.array([[5.3, 6.2], [8.1, 40.4], [43.2, 38.7], [40.6, 4.9]]),
        [(0, 0), (0, 32), (32, 32), (32, 0)])
    got = al.warp_perspective(torch.from_numpy(img), al.as_f32(coeffs, "cpu"), (64, 64)).numpy()
    want = np.asarray(PIL.fromarray(img).transform((64, 64), PIL.PERSPECTIVE, tuple(coeffs),
                                                   PIL.BILINEAR)).astype(np.float32)
    assert np.abs(got - want).mean() < 1.5


def test_paste_back_round_trip():
    """tests/test_compositing.py's round trip: inside the quad (with a
    margin) the pasted crop equals the original smooth ramps."""
    img = np.zeros((64, 64, 3), np.float32)
    img[:, :, 0] = np.arange(64)[None, :]
    img[:, :, 1] = np.arange(64)[:, None]
    quad = al.quad_from_cxy(np.array([32.0, 32.0]), np.array([16.0, 0.0]), np.array([0.0, 16.0]))
    crop = al.crop_quad(torch.from_numpy(img), al.as_f32(quad + 0.5, "cpu"), 32)
    pasted = al.warp_perspective(crop, al.as_f32(al.paste_back_coefficients(quad, 32), "cpu"),
                                 (64, 64)).numpy()
    inner = slice(24, 40)
    assert np.abs(pasted[inner, inner] - img[inner, inner]).mean() < 2.0
    jcrop = jal.crop_quad(jnp.asarray(img), jnp.asarray(quad + 0.5), 32)
    jpasted = np.asarray(jal.warp_perspective(
        jcrop, jnp.asarray(jal.paste_back_coefficients(quad, 32)), (64, 64)))
    assert np.abs(pasted - jpasted).max() <= LEVELS


def test_track_smoothing_matches_jax():
    rng = np.random.default_rng(12)
    tracks = (np.cumsum(rng.normal(0, 1, (15, 68, 2)), 0) + 50).astype(np.float32)
    np.testing.assert_array_equal(lmk.kalman_smooth_landmarks(tracks),
                                  jlm.kalman_smooth_landmarks(tracks))
    for f in (15, 4, 2):
        np.testing.assert_array_equal(lmk.savgol_smooth_landmarks(tracks[:f]),
                                      jlm.savgol_smooth_landmarks(tracks[:f]))


def test_mls_deformation_matches_jax():
    rng = np.random.default_rng(13)
    src = face_landmarks(rng, 30, 26, 12).astype(np.float32)
    dst = src + rng.normal(0, 1.5, src.shape).astype(np.float32)
    grid = lmk.mls_rigid_deformation_grid(torch.from_numpy(src), torch.from_numpy(dst), 52, 60)
    jgrid = np.asarray(jlm.mls_rigid_deformation_grid(jnp.asarray(src), jnp.asarray(dst), 52, 60))
    # float32 sums over 68 weighted points in each package's order
    assert np.abs(grid.numpy() - jgrid).max() <= 1e-3
    img = _image(14, 52, 60)
    jgrid = np.array(jgrid)
    warped = lmk.warp_with_grid(torch.from_numpy(img), torch.from_numpy(jgrid)).numpy()
    jwarped = np.asarray(jlm.warp_with_grid(jnp.asarray(img, jnp.float32), jnp.asarray(jgrid)))
    assert np.abs(warped - jwarped).max() <= LEVELS
    got = lmk.image_deformation(img, src, dst, device="cpu")
    want = jlm.image_deformation(img, src, dst)
    assert got.shape == want.shape == (52, 60, 3)
    # through the two grids: 1e-3 px moves a sample by at most 1e-3 * 255
    assert np.abs(got - want).max() <= 0.3
    same = lmk.image_deformation(img, src, src, device="cpu")
    assert np.abs(same - img).max() <= 0.05  # identical control points: identity
