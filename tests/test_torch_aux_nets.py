"""The port's RealESRGAN (models/rrdb.py), Blender (models/blender.py) and
GCFSR (models/gcfsr.py) against the JAX package's, on the CPU.

Small nets, as the JAX tests build them: RRDBNet with 16 features, 2
blocks, growth 8; GCFSR at out_size 64 with narrow 0.25; Blender (which has
no width parameter) as a module at 32^2 input, and the recolorer's resize,
normalisation and output glue on its own. Weights are reference-style
state dicts seeded with numpy (`tests/test_torch_gpen.py`), carried to JAX
by the JAX package's converters and loaded natively by the port: RRDB and
GCFSR inside basicsr's `params_ema` envelope, GCFSR with its FIR and noise
buffers, Blender with spectral-norm `weight_orig` / `weight_u` / `weight_v`.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from e4s2024_tpu.convert.torch_loader import convert_blender, convert_gcfsr, convert_rrdbnet
from e4s2024_tpu.models import blender as jblender
from e4s2024_tpu.models.gcfsr import FaceInpainter as JFaceInpainter
from e4s2024_tpu.models.gcfsr import FaceInpainting as JFaceInpainting
from e4s2024_tpu.models.rrdb import RealESRGANUpscaler as JRealESRGANUpscaler
from e4s2024_tpu.models.rrdb import RRDBNet as JRRDBNet
from e4s2024_tpu.ops import blend as jblend

from e4s2024_torch.convert import (
    blender_state_dict_from_jax, gcfsr_state_dict_from_jax, rrdbnet_state_dict_from_jax)
from e4s2024_torch.models import blender
from e4s2024_torch.models.gcfsr import FaceInpainter, FaceInpainting, gcfsr_state_dict
from e4s2024_torch.models.rrdb import RealESRGANUpscaler, RRDBNet
from e4s2024_torch.ops import blend
from e4s2024_torch.ops.upfirdn import make_kernel
from tests.test_torch_criterion import jit_apply, two_threads  # noqa: F401  (autouse fixture)
from tests.test_torch_gpen import (
    RRDB, assert_close_scaled, nchw, nhwc, np_sd, reference_state_dict)

GCFSR = dict(out_size=64, narrow=0.25)
SPECTRAL = tuple(f"referencer.FPN.layer{i}.0" for i in range(1, 6)) + tuple(
    f"referencer.FPN.{blk}.{conv}" for blk in ("head_0", "G_middle_0", "G_middle_1")
    for conv in ("conv_0", "conv_1", "conv_s"))


def _rgb(seed, shape):
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.float32)


# ------------------------------------------------------------------ RRDB

@pytest.fixture(scope="module")
def rrdb():
    ref = reference_state_dict(RRDBNet(**RRDB), 11)
    file_sd = {f"params_ema.{k}": v for k, v in ref.items()}  # basicsr's envelope
    return ref, convert_rrdbnet(np_sd(file_sd)), file_sd


def test_rrdb_upscaler_matches_jax(rrdb):
    ref, params, file_sd = rrdb
    img = _rgb(12, (2, 16, 12, 3))
    jup = JRealESRGANUpscaler(params, JRRDBNet(**RRDB))
    up = RealESRGANUpscaler(file_sd, **RRDB, device="cpu")
    want_raw = np.asarray(jup._fwd(jup._packed, jnp.asarray(img)))
    got_raw = up.forward(torch.from_numpy(img) / 255.0).numpy()
    assert got_raw.shape == (2, 64, 48, 3)
    # float32 through 2 x 3 dense blocks and 5 convs
    assert_close_scaled(got_raw, want_raw, 1e-5)
    got = up.upscale(img).numpy()
    np.testing.assert_allclose(got, np.asarray(jup.upscale(jnp.asarray(img))), atol=2e-3)
    assert got.min() >= 0 and got.max() <= 255
    # the nested envelope, as torch.load gives it, loads the same weights
    nested = RealESRGANUpscaler({"params_ema": ref}, **RRDB, device="cpu")
    assert torch.equal(nested.forward(torch.from_numpy(img) / 255.0), torch.from_numpy(got_raw))


def test_rrdb_state_dict_from_jax(rrdb):
    ref, params, _ = rrdb
    back = rrdbnet_state_dict_from_jax(params)
    assert set(back) == set(ref) and all(torch.equal(back[k], ref[k]) for k in ref)


# --------------------------------------------------------------- Blender

@pytest.fixture(scope="module")
def blender_nets():
    with torch.device("meta"):
        model = blender.Blender()
    ref = reference_state_dict(model, 13, spectral=SPECTRAL)
    net = blender.Blender().eval()
    net.load_state_dict(blender.blender_state_dict(ref))
    return ref, convert_blender(np_sd(ref)), net


def _blocky_masks(seed, b, size):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 19, (b, 4, 4))
    return np.repeat(np.repeat(base, size // 4, 1), size // 4, 2)


def test_blender_matches_jax(blender_nets):
    """At 32^2: 8^2 features, attention over 64 positions per part, the
    dilation at 3x3 (0.1 of the width, odd), the U-Net down to 4^2."""
    _, params, net = blender_nets
    rng = np.random.default_rng(14)
    mean, std = np.array(blender._MEAN, np.float32), np.array(blender._STD, np.float32)
    img_a = ((rng.random((2, 32, 32, 3)) - mean) / std).astype(np.float32)
    img_t = ((rng.random((2, 32, 32, 3)) - mean) / std).astype(np.float32)
    mask_a, mask_t = _blocky_masks(15, 2, 32), _blocky_masks(16, 2, 32)
    mask_t[1] = np.where(np.isin(mask_t[1], (4, 5)), 0, mask_t[1])  # an eye part absent in T
    want, want_pkgs = jit_apply(
        jblender.Blender(), {"params": params}, jnp.asarray(img_a), jnp.asarray(img_t),
        jnp.asarray(mask_a), jnp.asarray(mask_t))
    with torch.no_grad():
        got, pkgs = net(nchw(img_a), nchw(img_t), torch.from_numpy(mask_a),
                        torch.from_numpy(mask_t))
    # float32 through the FPN's 5 convs and 3 SPADE blocks, the softmax
    # and the U-Net: summation order
    assert_close_scaled(nhwc(pkgs), want_pkgs, 1e-5)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5)
    # the pipeline's swap_batch runs Blender on the whole batch: each
    # sample's result is the single call's (float32 summation order)
    with torch.no_grad():
        for i in range(2):
            one, _ = net(nchw(img_a[i:i + 1]), nchw(img_t[i:i + 1]),
                         torch.from_numpy(mask_a[i:i + 1]), torch.from_numpy(mask_t[i:i + 1]))
            torch.testing.assert_close(one, got[i:i + 1], rtol=0, atol=1e-5)


def test_masked_part_attention_matches_jax():
    rng = np.random.default_rng(17)
    n, c = 64, 8
    fa, ft = rng.standard_normal((2, 2, n, c)).astype(np.float32)
    rgb = rng.random((2, n, 3)).astype(np.float32)
    m_a = (rng.random((2, n)) > 0.5).astype(np.float32)
    m_t = (rng.random((2, n)) > 0.5).astype(np.float32)
    m_t[1] = 0  # no such part in the second target: zero
    got = blender._masked_part_attention(*(torch.from_numpy(v) for v in (fa, ft, rgb, m_a, m_t)),
                                         torch.tensor(2.0)).numpy()
    for i in range(2):
        want = jblender._masked_part_attention(fa[i], ft[i], rgb[i], m_a[i], m_t[i],
                                               jnp.asarray(2.0))
        np.testing.assert_allclose(got[i], np.asarray(want), atol=1e-6)
    assert not got[1].any()


class _Glue(torch.nn.Module):
    """A stand-in for the Blender net that shows what the glue feeds it: a
    fixed function of both images and both masks (NCHW)."""

    def forward(self, ia, it, ma, mt):
        out = torch.sigmoid(ia + 0.5 * it + 0.01 * (ma - mt).float()[:, None])
        return out, None


class _JGlue:
    def apply(self, variables, ia, it, ma, mt):
        out = jnp.asarray(1.0) / (1.0 + jnp.exp(-(ia + 0.5 * it + 0.01 * (ma - mt)[..., None])))
        return out, None


def test_recolorer_glue_matches_jax():
    """BlenderRecolorer's resize to 256 (bilinear images, nearest 19-class
    masks), ImageNet normalisation and [0, 255] clip, around a stand-in net."""
    jrec = jblender.BlenderRecolorer({"unused": np.zeros(1, np.float32)})
    jrec.model = _JGlue()
    rec = object.__new__(blender.BlenderRecolorer)
    rec.device, rec.model = torch.device("cpu"), _Glue()
    a, t = _rgb(18, (2, 128, 128, 3)), _rgb(19, (2, 128, 128, 3))
    ma, mt = _blocky_masks(20, 2, 512), _blocky_masks(21, 2, 512)
    want = np.asarray(jrec.recolor(jnp.asarray(a), jnp.asarray(t), jnp.asarray(ma),
                                   jnp.asarray(mt)))
    got = rec.recolor(torch.from_numpy(a), torch.from_numpy(t), torch.from_numpy(ma),
                      torch.from_numpy(mt)).numpy()
    assert got.shape == (2, 256, 256, 3)
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_blender_state_dict_from_jax(blender_nets):
    ref, params, net = blender_nets
    back = blender_state_dict_from_jax(params)
    want = net.state_dict()
    assert set(back) == set(want)
    for k in want:
        # the spectral fold in float32 by torch and by numpy: a few ulps
        torch.testing.assert_close(back[k], want[k], rtol=1e-6, atol=1e-7, msg=k)


# ----------------------------------------------------------------- GCFSR

def gcfsr_reference_state_dict(seed):
    """A GCFSR file's weights in basicsr's envelope, with the FIR buffers
    (downsample smooths at gain 1, up-conv smooths and skip upsamples at
    gain 4) and noise maps it registers."""
    with torch.device("meta"):
        model = FaceInpainting(**GCFSR)
    ref = reference_state_dict(model, seed)
    file_sd = {f"params_ema.{k}": v for k, v in ref.items()}
    k = make_kernel([1, 3, 3, 1])
    for i in range(len(model.conv_body_down)):
        file_sd[f"params_ema.conv_body_down.{i}.0.kernel"] = k.clone()
    file_sd["params_ema.final_down1.0.kernel"] = k.clone()
    file_sd["params_ema.final_down2.0.kernel"] = k.clone()
    for p in range(len(model.to_rgbs)):
        file_sd[f"params_ema.style_convs.{2 * p}.modulated_conv.smooth.kernel"] = k * 4
        file_sd[f"params_ema.to_rgbs.{p}.upsample.kernel"] = k * 4
    for i in range(model.num_layers):
        file_sd[f"params_ema.noises.noise{i}"] = torch.ones(1, 1, 4, 4)
    return ref, file_sd


@pytest.fixture(scope="module")
def gcfsr():
    ref, file_sd = gcfsr_reference_state_dict(22)
    params = convert_gcfsr(np_sd(file_sd))
    net = FaceInpainting(**GCFSR).eval()
    net.load_state_dict(gcfsr_state_dict(file_sd))
    return ref, file_sd, params, net


def test_gcfsr_matches_jax(gcfsr):
    _, _, params, net = gcfsr
    rng = np.random.default_rng(23)
    x = rng.random((2, 64, 64, 4)).astype(np.float32)
    cond = np.array([[0.1], [0.3]], np.float32)
    img, latent = jit_apply(JFaceInpainting(**GCFSR), {"params": params}, jnp.asarray(x),
                            jnp.asarray(cond))
    with torch.no_grad():
        got, got_latent = net(nchw(x), torch.from_numpy(cond))
    assert got.shape == (2, 3, 64, 64) and got_latent.shape == (2, 6, 512)
    # float32 through 3 downsampling ConvLayers, the latent head and 5
    # modulated convs with their scale-shift conditions: summation order
    assert_close_scaled(nhwc(got), img, 1e-4)
    assert_close_scaled(got_latent.numpy(), latent, 1e-4)


def test_face_inpainter_matches_jax(gcfsr):
    """At 128^2 (the net at 64, resized both ways): the completion inside the
    hole, every pixel outside it unchanged."""
    _, file_sd, params, _ = gcfsr
    img = _rgb(24, (1, 128, 128, 3))
    hole = np.zeros((1, 128, 128), bool)
    hole[:, 40:90, 50:100] = True
    want = np.asarray(JFaceInpainter(params, JFaceInpainting(**GCFSR)).inpaint(
        jnp.asarray(img), jnp.asarray(hole)))
    got = FaceInpainter(file_sd, 64, narrow=0.25, device="cpu").inpaint(img, hole).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3)
    # outside the hole: the image's own value, (x / 255) * 255 in float32
    np.testing.assert_allclose(got[0][~hole[0]], img[0][~hole[0]], rtol=0, atol=3e-5)
    assert np.abs(got[0][hole[0]] - img[0][hole[0]]).mean() > 1.0


def test_gcfsr_buffers_and_state_dict_from_jax(gcfsr):
    ref, file_sd, params, _ = gcfsr
    back = gcfsr_state_dict_from_jax(params)
    assert set(back) == set(ref) and all(torch.equal(back[k], ref[k]) for k in ref)
    bad = dict(file_sd)
    bad["params_ema.to_rgbs.0.upsample.kernel"] = make_kernel([1, 3, 3, 1])  # gain 1, not 4
    with pytest.raises(ValueError, match="FIR taps"):
        gcfsr_state_dict(bad)


# ------------------------------------------------------------ compositing

def test_sobel_blend_and_soft_erosion_match_jax():
    rng = np.random.default_rng(25)
    img = _rgb(26, (2, 24, 20, 3))
    np.testing.assert_allclose(nhwc(blend.sobel_edge(nchw(img))),
                               np.asarray(jblend.sobel_edge(jnp.asarray(img))), rtol=1e-6,
                               atol=1e-3)
    mask = rng.random((2, 24, 20, 1)).astype(np.float32)
    mask[0, 3, 4, 0] = np.nan
    a, b = _rgb(27, (2, 24, 20, 3)), _rgb(28, (2, 24, 20, 3))
    np.testing.assert_allclose(
        blend.blend_with_mask(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(mask),
                              0.75).numpy(),
        np.asarray(jblend.blend_with_mask(jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask),
                                          0.75)), rtol=1e-6, atol=1e-4)
    hole = np.zeros((2, 40, 40, 1), np.float32)
    hole[0, 10:25, 12:30] = 1.0
    hole[1, 5:8, 5:35] = 0.5
    soft, hard = blend.soft_erosion(torch.from_numpy(hole))
    jsoft, jhard = jblend.soft_erosion(jnp.asarray(hole))
    # the dense cone convolution against its separable SVD terms
    np.testing.assert_allclose(soft.numpy(), np.asarray(jsoft), atol=1e-5)
    assert np.mean(hard.numpy() != np.asarray(jhard)) <= 1e-3
    # zero exactly where the cone does not reach the hole
    far = np.ones((40, 40), bool)
    far[10 - 7:25 + 7, 12 - 7:30 + 7] = False
    assert not soft.numpy()[0, far].any()
