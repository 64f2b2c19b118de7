"""The port's aligned-crop swap (e4s2024_torch.pipelines) against the JAX
package's, end to end on the CPU.

The configuration is tests/test_swap_pipeline.py's (128^2 output,
remaining_layer_idx=9, 4 blend levels) with the encoder body cut to one unit
per group on both sides. Weights come from a numpy seed (see
tests/test_torch_models.py::random_params). Random BiSeNet weights collapse
the parse to one class, so a second test feeds the merge + synthesis +
composite stage numpy-made multi-class masks.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from e4s2024_tpu.models.bisenet import BiSeNet as JBiSeNet
from e4s2024_tpu.models.rgi import RGINet as JRGINet
from e4s2024_tpu.pipelines.mask_merge import swap_head_mask as j_swap_head_mask
from e4s2024_tpu.pipelines.swap import FaceSwapper as JFaceSwapper
from e4s2024_tpu.pipelines.swap import SwapConfig as JSwapConfig

from e4s2024_torch.convert import bisenet_state_dict_from_jax, rgi_state_dict_from_jax
from e4s2024_torch.pipelines.mask_merge import swap_comp_style_vector, swap_head_mask
from e4s2024_torch.pipelines.swap import FaceSwapper, SwapConfig
from tests.test_torch_models import random_params
from tests.test_torch_criterion import two_threads  # noqa: F401

SIZE, REMAINING, LEVELS, UNITS = 128, 9, 4, (1, 1, 1, 1)
MODES = ("exact", "fast")


@pytest.fixture(scope="module")
def swappers():
    jrgi = JRGINet(out_size=SIZE, remaining_layer_idx=REMAINING, encoder_num_units=UNITS)
    rgi_vars = random_params(jax.eval_shape(
        jrgi.init, jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)),
        jnp.zeros((1, SIZE, SIZE, 12))), 11)
    bise = random_params(jax.eval_shape(
        JBiSeNet().init, jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3)))["params"], 12)
    rgi_sd, bise_sd = rgi_state_dict_from_jax(rgi_vars), bisenet_state_dict_from_jax(bise)
    out = {}
    for mode in MODES:
        kw = dict(out_size=SIZE, remaining_layer_idx=REMAINING, num_blend_levels=LEVELS,
                  regional_mode=mode)
        jswap = JFaceSwapper(rgi_vars, bise, JSwapConfig(**kw))
        jswap.rgi = jrgi  # the JAX swapper builds the full-depth encoder
        swap = FaceSwapper(rgi_sd, bise_sd, SwapConfig(**kw), device="cpu",
                           encoder_num_units=UNITS)
        out[mode] = (jswap, swap)
    return out


def _assert_same_swap(got, want):
    np.testing.assert_array_equal(got["swapped_mask"].numpy(), np.asarray(want["swapped_mask"]))
    np.testing.assert_array_equal(got["hole_mask"].numpy(), np.asarray(want["hole_mask"]))
    sv_j = np.asarray(want["swapped_style_vectors"])
    np.testing.assert_allclose(got["swapped_style_vectors"].numpy(), sv_j,
                               atol=1e-4 * np.abs(sv_j).max(), rtol=1e-4)
    img, img_j = got["image"].numpy(), np.asarray(want["image"])
    assert img.dtype == np.uint8 and img.shape == img_j.shape
    # uint8 after float32 synthesis and compositing: within one level
    assert np.abs(img.astype(np.int16) - img_j.astype(np.int16)).max() <= 1


def test_swap_aligned_matches_jax(swappers):
    rng = np.random.default_rng(13)
    src = (rng.random((1, SIZE, SIZE, 3)) * 255).astype(np.uint8)
    tgt = (rng.random((1, SIZE, SIZE, 3)) * 255).astype(np.uint8)
    jexact = swappers["exact"][0]
    # the parse + invert stage does not depend on the regional mode: run it
    # once on the JAX side and feed both modes' merge + synthesis programs
    masks, sv = jexact._pair_jit(jnp.concatenate([jnp.asarray(src), jnp.asarray(tgt)]))
    for mode in MODES:
        jswap, swap = swappers[mode]
        want = jswap._merge_jit(masks[:1], masks[1:], sv[:1], sv[1:], jnp.asarray(tgt))
        got = swap.swap_aligned(src, tgt)
        assert got["image"].shape == (1, SIZE, SIZE, 3)
        assert got["swapped_mask"].shape == (1, 512, 512)
        assert got["swapped_style_vectors"].shape == (1, 12, 1280)
        _assert_same_swap(got, want)


def face_masks(rng, b, size=512):
    """Face-like 12-class label maps: hair, skin ellipse, brows, eyes, nose,
    lips, teeth, ears, neck, earring, glasses; jittered per sample."""
    yy, xx = np.mgrid[:size, :size] / size
    out = np.zeros((b, size, size), np.int64)
    for i in range(b):
        cy, cx = 0.5 + 0.04 * rng.standard_normal(2)
        m = out[i]
        m[(yy - cy + 0.1) ** 2 + (xx - cx) ** 2 < 0.13] = 4        # hair
        m[(yy > cy + 0.2) & (np.abs(xx - cx) < 0.12)] = 8         # neck
        m[((yy - cy) / 1.3) ** 2 + (xx - cx) ** 2 < 0.06] = 6     # skin
        for side in (-1, 1):
            m[(np.abs(yy - cy) < 0.05) & (np.abs(xx - cx - side * 0.26) < 0.03)] = 7  # ears
            m[(np.abs(yy - cy + 0.12) < 0.012) & (np.abs(xx - cx - side * 0.09) < 0.05)] = 2
            m[(np.abs(yy - cy + 0.07) < 0.02) & (np.abs(xx - cx - side * 0.09) < 0.04)] = 3
        m[(np.abs(yy - cy - 0.02) < 0.06) & (np.abs(xx - cx) < 0.025)] = 5           # nose
        m[(np.abs(yy - cy - 0.14) < 0.025) & (np.abs(xx - cx) < 0.07)] = 1           # lips
        m[(np.abs(yy - cy - 0.14) < 0.006) & (np.abs(xx - cx) < 0.05)] = 9           # teeth
        m[(np.abs(yy - cy - 0.08) < 0.01) & (np.abs(xx - cx + 0.26) < 0.01)] = 11    # earring
        if i % 2:
            m[(np.abs(yy - cy + 0.07) < 0.004) & (np.abs(xx - cx) < 0.15)] = 10      # glasses
    return out


def test_mask_merge_matches_jax():
    rng = np.random.default_rng(14)
    src, tgt = face_masks(rng, 2), face_masks(rng, 2)
    tgt[0, :60] = 0  # a target with background above the hair
    got = swap_head_mask(torch.from_numpy(src), torch.from_numpy(tgt))
    for i in range(2):
        want = j_swap_head_mask(jnp.asarray(src[i]), jnp.asarray(tgt[i]))
        for key in ("mask", "hole_mask", "hole_map", "nose_line"):
            np.testing.assert_array_equal(got[key][i].numpy(), np.asarray(want[key]), err_msg=key)


def test_swap_comp_style_vector_teeth_fallback():
    rng = np.random.default_rng(15)
    t_sv = rng.standard_normal((2, 12, 8)).astype(np.float32)
    s_sv = rng.standard_normal((2, 12, 8)).astype(np.float32)
    s_sv[1, 9] = 0.0  # the second source has no teeth
    comp = [1, 2, 3, 5, 6, 9]
    got = swap_comp_style_vector(torch.from_numpy(t_sv), torch.from_numpy(s_sv), comp).numpy()
    np.testing.assert_array_equal(got[:, 6], s_sv[:, 6])
    np.testing.assert_array_equal(got[:, 4], t_sv[:, 4])
    np.testing.assert_array_equal(got[:, 7], (t_sv[:, 7] + s_sv[:, 7]) / 2)
    np.testing.assert_array_equal(got[:, 11], t_sv[:, 11])
    np.testing.assert_array_equal(got[0, 9], s_sv[0, 9])
    np.testing.assert_array_equal(got[1, 9], t_sv[1, 9])


@pytest.mark.parametrize("mode", MODES)
def test_merge_synth_composite_multiclass_matches_jax(swappers, mode):
    jswap, swap = swappers[mode]
    rng = np.random.default_rng(16)
    d_masks, t_masks = face_masks(rng, 2), face_masks(rng, 2)
    d_sv = rng.standard_normal((2, 12, 1280)).astype(np.float32)
    t_sv = rng.standard_normal((2, 12, 1280)).astype(np.float32)
    d_sv[1, 9] = 0.0
    t255 = (rng.random((2, SIZE, SIZE, 3)) * 255).astype(np.uint8)
    want = jswap._merge_jit(jnp.asarray(d_masks), jnp.asarray(t_masks), jnp.asarray(d_sv),
                            jnp.asarray(t_sv), jnp.asarray(t255))
    with torch.inference_mode():
        got = swap._merge_synth_composite(
            torch.from_numpy(d_masks), torch.from_numpy(t_masks), torch.from_numpy(d_sv),
            torch.from_numpy(t_sv), torch.from_numpy(t255))
    assert len(np.unique(got["swapped_mask"].numpy())) >= 8
    _assert_same_swap(got, want)


def test_entry_point_raises_without_card():
    """With no device given the swapper runs on CUDA, and without a card it
    raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FaceSwapper({}, {}, SwapConfig(out_size=SIZE, remaining_layer_idx=REMAINING))
