"""The port's GPEN enhancer (e4s2024_torch.models.gpen), its ConvLayer and
the ArcFace-template alignment (pipelines/arcface_align.py) against the JAX
package's, on the CPU.

Small nets, as tests/test_gpen.py builds them: GPEN at size 64 with
narrow 0.25. Weights are reference-style state dicts seeded with numpy,
carried to JAX by the JAX package's converter (`convert_gpen`) and loaded
natively by the port, FIR buffers included.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from e4s2024_tpu.convert.torch_loader import convert_gpen, convert_rrdbnet
from e4s2024_tpu.models import stylegan2 as jsg2
from e4s2024_tpu.models.gpen import GPENEnhancer as JGPENEnhancer
from e4s2024_tpu.models.gpen import GPENFullFrameEnhancer as JGPENFullFrameEnhancer
from e4s2024_tpu.models.gpen import GPENFullGenerator as JGPENFullGenerator
from e4s2024_tpu.models.gpen import landmarks68_to_5 as j_landmarks68_to_5
from e4s2024_tpu.models.rrdb import RealESRGANUpscaler as JRealESRGANUpscaler
from e4s2024_tpu.models.rrdb import RRDBNet as JRRDBNet
from e4s2024_tpu.pipelines import arcface_align as jalign

from e4s2024_torch.convert import gpen_state_dict_from_jax
from e4s2024_torch.models import stylegan2 as sg2
from e4s2024_torch.models.arcface import FrozenBatchNorm
from e4s2024_torch.models.gpen import (
    GPENEnhancer, GPENFullFrameEnhancer, GPENFullGenerator, gpen_state_dict, landmarks68_to_5)
from e4s2024_torch.models.rrdb import RealESRGANUpscaler, RRDBNet
from e4s2024_torch.ops.upfirdn import make_kernel
from e4s2024_torch.pipelines import arcface_align
from tests.test_torch_criterion import jit_apply, two_threads  # noqa: F401  (autouse fixture)

GPEN = dict(size=64, narrow=0.25)
RRDB = dict(num_feat=16, num_block=2, num_grow=8)


def reference_state_dict(model: torch.nn.Module, seed: int, spectral=()) -> dict:
    """A state dict in the reference's names for `model` (a port module, whose
    names are the reference's), seeded with numpy as a trained file would
    hold it: equalised-LR weights standard normal (the style MLP's divided by
    its lr_mul, as the reference initialises them), other convolutions and
    linear layers LeCun normal, modulation and condition-scale biases and
    norm scales near 1, BatchNorm statistics away from the identity, noise
    weights, biases and embeddings small and non-zero. Convolutions named in `spectral` are stored as the reference's
    spectral norm stores them: `weight_orig` with power-iterated `weight_u`
    and `weight_v`."""
    rng = np.random.default_rng(seed)
    out = {}

    def f32(v):
        return torch.tensor(np.asarray(v), dtype=torch.float32)

    for mname, m in model.named_modules():
        p = f"{mname}." if mname else ""
        for name, t in list(m.named_parameters(recurse=False)) + list(
                m.named_buffers(recurse=False)):
            shape, n = tuple(t.shape), rng.standard_normal(t.shape)
            if isinstance(m, FrozenBatchNorm):
                v = {"weight": 1 + 0.1 * n, "bias": 0.1 * n, "running_mean": 0.1 * n,
                     "running_var": rng.uniform(0.5, 1.5, shape)}[name]
            elif name == "weight" and isinstance(m, (sg2.EqualConv2d, sg2.ModulatedConv2d)):
                v = n
            elif name == "weight" and len(shape) == 5:  # a pre-scaled ("clean") modconv
                v = n / np.sqrt(np.prod(shape[2:]))
            elif name == "weight" and isinstance(m, (torch.nn.GroupNorm, torch.nn.LayerNorm)):
                v = 1 + 0.1 * n
            elif name in ("weight", "in_proj_weight") and isinstance(
                    m, torch.nn.Linear) or name == "in_proj_weight":
                v = n / np.sqrt(shape[1])
            elif name == "weight" and isinstance(m, sg2.EqualLinear):
                v = n / m.lr_mul
            elif name == "input":
                v = n
            elif name == "weight" and isinstance(m, torch.nn.Conv2d):
                v = n / np.sqrt(np.prod(shape[1:]))
                if mname in spectral:
                    w2 = v.reshape(shape[0], -1)
                    u = rng.standard_normal(shape[0])
                    for _ in range(5):  # power iteration, as training leaves u, v
                        vv = w2.T @ u
                        vv /= np.linalg.norm(vv)
                        u = w2 @ vv
                        u /= np.linalg.norm(u)
                    out[f"{p}weight_orig"], out[f"{p}weight_u"] = f32(v), f32(u)
                    out[f"{p}weight_v"] = f32(vv)
                    continue
            elif name == "bias" and (mname.endswith("modulation") or "condition_scale" in mname):
                v = 1 + 0.1 * n
            elif name == "trainable_tao":
                v = np.full(shape, 1.7)
            else:  # biases, noise weights
                v = 0.1 * n
            out[f"{p}{name}"] = f32(v)
    return out


def np_sd(sd) -> dict:
    return {k: v.numpy() for k, v in sd.items()}


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def assert_close_scaled(got, want, rel):
    """max |got - want| within `rel` of want's largest magnitude."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def gpen_reference_state_dict(seed: int) -> dict:
    """A GPEN-64 (narrow 0.25) file's state dict: the weights plus the FIR
    buffers the reference registers (encoder blurs at gain 1, decoder blurs
    and skip upsamples at gain 4)."""
    with torch.device("meta"):
        model = GPENFullGenerator(**GPEN)
    sd = reference_state_dict(model, seed)
    blur = make_kernel([1, 3, 3, 1])
    for i in range(1, model.log_size - 1):
        sd[f"ecd{i}.0.0.kernel"] = blur.clone()
    for j in range(len(model.generator.to_rgbs)):
        sd[f"generator.convs.{2 * j}.conv.blur.kernel"] = blur * 4
        sd[f"generator.to_rgbs.{j}.upsample.kernel"] = blur * 4
    return sd


@pytest.fixture(scope="module")
def gpen():
    ref = gpen_reference_state_dict(1)
    params = convert_gpen(np_sd(ref))
    net = GPENFullGenerator(**GPEN).eval()
    net.load_state_dict(gpen_state_dict(ref))
    return ref, params, net


@pytest.mark.parametrize("downsample,bias,activate,k", [
    (True, True, True, 3), (False, True, True, 1), (False, True, False, 3),
    (True, False, True, 3), (True, False, False, 1)])
def test_conv_layer_matches_jax(downsample, bias, activate, k):
    layer = sg2.ConvLayer(6, 10, k, downsample=downsample, bias=bias, activate=activate)
    sd = reference_state_dict(layer, 2)
    layer.load_state_dict(sd)
    i = 1 if downsample else 0
    p = {"conv": {"weight": sd[f"{i}.weight"].numpy().transpose(2, 3, 1, 0)}}
    if f"{i}.bias" in sd:
        p["conv"]["bias"] = sd[f"{i}.bias"].numpy()
    if activate and bias:
        p["act_bias"] = sd[f"{i + 1}.bias"].numpy()
    x = np.random.default_rng(3).standard_normal((2, 16, 16, 6)).astype(np.float32)
    want = jit_apply(jsg2.ConvLayer(10, k, downsample=downsample, use_bias=bias,
                                    activate=activate), {"params": p}, jnp.asarray(x))
    got = layer(nchw(x))
    # float32 convolutions of 6 * k^2 terms
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_gpen_matches_jax(gpen):
    _, params, net = gpen
    x = (np.random.default_rng(4).random((2, 64, 64, 3)) * 2 - 1).astype(np.float32)
    img, latent = jit_apply(JGPENFullGenerator(**GPEN), {"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got, got_latent = net(nchw(x))
    assert got.shape == (2, 3, 64, 64) and got_latent.shape == (2, 10, 512)
    # float32 through 5 encoder ConvLayers, an 8-layer style MLP and 9
    # modulated convs: summation order, within 1e-4 of the largest value
    assert_close_scaled(nhwc(got), img, 1e-4)
    assert_close_scaled(got_latent.numpy(), latent, 1e-4)


def test_gpen_enhancer_matches_jax(gpen):
    """At another size than GPEN's: the resize to 64 and back, through the
    interpolation matrices on both sides."""
    ref, params, _ = gpen
    crop = 96
    img = (np.random.default_rng(5).random((1, crop, crop, 3)) * 255).astype(np.float32)
    want = np.asarray(JGPENEnhancer(params, 64, JGPENFullGenerator(**GPEN)).enhance_aligned(
        jnp.asarray(img)))
    got = GPENEnhancer(ref, 64, narrow=0.25, device="cpu").enhance_aligned(img).numpy()
    assert got.shape == (1, crop, crop, 3) and got.min() >= 0 and got.max() <= 255
    # the net's 1e-4 relative, in levels of [0, 255]
    np.testing.assert_allclose(got, want, atol=0.02)


def test_gpen_state_dict_from_jax_inverts_the_converter(gpen):
    ref, params, _ = gpen
    back = gpen_state_dict_from_jax(params)
    want = gpen_state_dict(ref)
    assert set(back) == set(want)
    for k in want:
        assert torch.equal(back[k], want[k]), k


def test_reference_fir_buffers_are_checked(gpen):
    ref = dict(gpen[0])
    ref["ecd1.0.0.kernel"] = ref["ecd1.0.0.kernel"] * 4  # a gain the encoder blur lacks
    with pytest.raises(ValueError, match="FIR taps"):
        gpen_state_dict(ref)
    ref = dict(gpen[0], **{"generator.unexpected": torch.zeros(1)})
    with pytest.raises(RuntimeError, match="Unexpected key"):
        GPENFullGenerator(**GPEN).load_state_dict(gpen_state_dict(ref))


def test_arcface_alignment_matches_jax():
    rng = np.random.default_rng(6)
    lm68 = rng.random((68, 2)) * 40 + 30
    lm5 = landmarks68_to_5(lm68)
    np.testing.assert_array_equal(lm5, j_landmarks68_to_5(lm68))
    for mode, size in (("set1", 64), ("ffhq", 512), ("arcface", 112)):
        np.testing.assert_allclose(arcface_align.estimate_norm(lm5, size, mode),
                                   jalign.estimate_norm(lm5, size, mode), rtol=1e-12, atol=1e-12)
    m = arcface_align.estimate_norm(lm5, 64, "set1")
    img = rng.random((90, 110, 3)).astype(np.float32) * 255
    got = arcface_align.warp_affine(torch.from_numpy(img), m, 64).numpy()
    want = np.asarray(jalign.warp_affine(jnp.asarray(img), jnp.asarray(m), 64))
    # float32 inverse and sample coordinates on both sides, rounded in
    # another order: up to 4 ulps of a coordinate near 110 (7.6e-6 each)
    # move a bilinear weight by as much, times neighbours 255 levels apart
    np.testing.assert_allclose(got, want, atol=8e-3)
    inv = arcface_align.invert_affine(m)
    np.testing.assert_array_equal(inv, jalign.invert_affine(m))
    back = arcface_align.warp_affine_hw(torch.from_numpy(got), inv, (90, 110)).numpy()
    want_back = np.asarray(jalign.warp_affine_hw(jnp.asarray(want), jnp.asarray(inv), (90, 110)))
    np.testing.assert_allclose(back, want_back, atol=8e-3)


def test_full_frame_enhancer_matches_jax(gpen):
    """A 68-point landmark hook (one face), then with a tiny RealESRGAN
    upscaling the frame first (detection on the x4 frame; same hook)."""
    ref, params, _ = gpen
    rng = np.random.default_rng(7)
    frame = (rng.random((60, 80, 3)) * 255).astype(np.uint8)
    lm68 = rng.random((68, 2)) * 30 + 15

    def hook(f):
        return lm68 * (f.shape[0] / 60)

    enh = GPENEnhancer(ref, 64, narrow=0.25, device="cpu")
    jenh = JGPENEnhancer(params, 64, JGPENFullGenerator(**GPEN))
    got = GPENFullFrameEnhancer(enh, landmark_fn=hook).enhance_frame(frame)
    want = JGPENFullFrameEnhancer(jenh, landmark_fn=hook).enhance_frame(frame)
    assert got.shape == frame.shape and got.dtype == np.uint8
    # uint8 truncation of float32 on both sides: one level where the two
    # straddle an integer
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert not np.array_equal(got, frame)

    rrdb_ref = reference_state_dict(RRDBNet(**RRDB), 8)
    up = RealESRGANUpscaler(rrdb_ref, **RRDB, device="cpu")
    jup = JRealESRGANUpscaler(convert_rrdbnet(np_sd(rrdb_ref)), JRRDBNet(**RRDB))
    got = GPENFullFrameEnhancer(enh, landmark_fn=hook, sr_upscaler=up).enhance_frame(frame)
    want = JGPENFullFrameEnhancer(jenh, landmark_fn=hook, sr_upscaler=jup).enhance_frame(frame)
    assert got.shape == (240, 320, 3)
    diff = np.abs(got.astype(int) - want.astype(int))
    # the upscaled frame is truncated to uint8 before detection: a pixel
    # that straddles an integer moves the restored crop by a level there
    assert diff.max() <= 2 and diff.mean() <= 0.02, (diff.max(), diff.mean())
