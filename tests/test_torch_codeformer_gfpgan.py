"""The port's CodeFormer (models/codeformer.py) and GFPGAN
(models/gfpgan.py) against the JAX package's, on the CPU.

CodeFormer's plan is fixed at 512^2 in both packages; here both run a
smaller plan of the same structure (nf 32, ch_mult (1, 2), 32^2 input: one
downsample to the 16^2 latent grid, attention at 16^2, the fuse taps at 32
and 16 at the reference's rule), with two transformer layers: each
package's plan functions and tap tables are patched for the test. GFPGAN as
tests/test_gfpgan.py builds it (64^2, channel multiplier 1, narrow 0.25).
Weights are reference-style state dicts seeded with numpy
(`tests/test_torch_gpen.py`), through the JAX package's converters.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import e4s2024_tpu.models.codeformer as jcf
from e4s2024_tpu.convert.torch_loader import convert_codeformer, convert_gfpgan
from e4s2024_tpu.models.gfpgan import GFPGANEnhancer as JGFPGANEnhancer
from e4s2024_tpu.models.gfpgan import GFPGANv1Clean as JGFPGANv1Clean

from e4s2024_torch.convert import codeformer_state_dict_from_jax, gfpgan_state_dict_from_jax
from e4s2024_torch.models import codeformer
from e4s2024_torch.models.codeformer import CodeFormer, CodeFormerEnhancer, codeformer_state_dict
from e4s2024_torch.models.gfpgan import GFPGANEnhancer, GFPGANv1Clean, gfpgan_state_dict
from e4s2024_torch.ops.resize import resize_bilinear
from tests.test_torch_criterion import jit_apply, two_threads  # noqa: F401  (autouse fixture)
from tests.test_torch_gpen import assert_close_scaled, nchw, nhwc, np_sd, reference_state_dict

PLAN = dict(nf=32, ch_mult=(1, 2), resolution=32)
TAPS = dict(fuse_encoder_block={32: 2, 16: 6}, fuse_generator_block={16: 6, 32: 9})
CF = dict(n_layers=2, connect_list=(32,))
GFPGAN = dict(out_size=64, channel_multiplier=1, narrow=0.25)


@pytest.fixture
def small_plans(monkeypatch):
    """Both packages' CodeFormer on PLAN's blocks and TAPS' fuse taps: the
    plan functions and the tap tables are module attributes each reads
    when it builds or traces a net."""
    for mod in (jcf, codeformer):
        enc, gen = mod.encoder_plan, mod.generator_plan
        monkeypatch.setattr(mod, "encoder_plan", lambda enc=enc: enc(**PLAN))
        monkeypatch.setattr(mod, "generator_plan", lambda gen=gen: gen(**PLAN))
        monkeypatch.setattr(mod, "FUSE_ENCODER_BLOCK", TAPS["fuse_encoder_block"])
        monkeypatch.setattr(mod, "FUSE_GENERATOR_BLOCK", TAPS["fuse_generator_block"])
    return jcf.CodeFormer(**CF)


def test_plans_match_jax():
    def kinds(plan):  # JAX names the last conv "conv_out"; widths per block
        return [({"conv_out": "conv"}.get(k, k), f) for k, f in plan]

    for kw in ({}, PLAN):
        assert [(k, o) for k, _, o in codeformer.encoder_plan(**kw)] == kinds(
            jcf.encoder_plan(**kw))
        assert [(k, o) for k, _, o in codeformer.generator_plan(**kw)] == kinds(
            jcf.generator_plan(**kw))
    assert codeformer.FUSE_ENCODER_BLOCK == jcf.FUSE_ENCODER_BLOCK
    assert codeformer.FUSE_GENERATOR_BLOCK == jcf.FUSE_GENERATOR_BLOCK


def test_codeformer_matches_jax(small_plans):
    w = 0.7  # the fuse residual scales with w; at 0 it is exactly zero on both sides
    ref = reference_state_dict(CodeFormer(**CF), 50)
    file_sd = {"params_ema": ref}  # the released file's envelope, nested
    params = convert_codeformer({f"params_ema.{k}": v for k, v in np_sd(ref).items()})
    net = CodeFormer(**CF).eval()
    net.load_state_dict(codeformer_state_dict(file_sd))
    x = (np.random.default_rng(51).random((2, 32, 32, 3)) * 2 - 1).astype(np.float32)
    img, logits, lq = jit_apply(small_plans, {"params": params}, jnp.asarray(x), w=w)
    with torch.no_grad():
        got, got_logits, got_lq = net(nchw(x), w)
    # float32 through the VQ encoder, two transformer layers and the
    # decoder: summation order; the codes (argmax of the logits) equal
    assert_close_scaled(nhwc(got_lq), lq, 1e-5)
    assert_close_scaled(got_logits.numpy(), logits, 1e-5)
    np.testing.assert_array_equal(got_logits.argmax(-1).numpy(),
                                  np.asarray(logits).argmax(-1))
    assert_close_scaled(nhwc(got), img, 1e-5)
    back = codeformer_state_dict_from_jax(params)
    assert set(back) == set(ref) and all(torch.equal(back[k], ref[k]) for k in ref)


def test_codeformer_enhancer_glue(small_plans):
    """`restore_aligned` with the fidelity weight: [-1, 1] in, resized to
    the net's size and back, clipped to [0, 255]."""
    ref = reference_state_dict(CodeFormer(**CF), 52)
    enh = CodeFormerEnhancer(ref, w=0.5, device="cpu", **CF)
    enh.size = PLAN["resolution"]
    img = (np.random.default_rng(53).random((1, 48, 48, 3)) * 255).astype(np.float32)
    got = enh.enhance_aligned(img)
    with torch.no_grad():
        x = resize_bilinear(nchw(img) / 127.5 - 1.0, (32, 32))
        want = resize_bilinear(torch.clamp((enh.model(x, 0.5)[0] + 1) * 127.5, 0, 255),
                               (48, 48))
    torch.testing.assert_close(got, want.permute(0, 2, 3, 1))


@pytest.fixture(scope="module")
def gfpgan():
    with torch.device("meta"):
        model = GFPGANv1Clean(**GFPGAN)
    ref = reference_state_dict(model, 54)
    # what a reference file also holds and the restoration never reads
    file_sd = dict(ref, **{"stylegan_decoder.style_mlp.1.weight": torch.zeros(512, 512),
                           "toRGB.0.weight": torch.zeros(3, 64, 1, 1),
                           "stylegan_decoder.noises.noise0": torch.zeros(1, 1, 4, 4)})
    return ref, file_sd, convert_gfpgan(np_sd(file_sd))


def test_gfpgan_matches_jax(gfpgan):
    ref, file_sd, params = gfpgan
    net = GFPGANv1Clean(**GFPGAN).eval()
    net.load_state_dict(gfpgan_state_dict(file_sd))
    x = (np.random.default_rng(55).random((2, 64, 64, 3)) * 2 - 1).astype(np.float32)
    img, latent = jit_apply(JGFPGANv1Clean(**GFPGAN), {"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got, got_latent = net(nchw(x))
    # float32 through the U-Net and 11 modulated convs: summation order
    assert_close_scaled(nhwc(got), img, 1e-5)
    assert_close_scaled(got_latent.numpy(), latent, 1e-5)
    back = gfpgan_state_dict_from_jax(params)
    assert set(back) == set(ref) and all(torch.equal(back[k], ref[k]) for k in ref)


def test_gfpgan_enhancer_matches_jax(gfpgan):
    _, file_sd, params = gfpgan
    img = (np.random.default_rng(56).random((1, 96, 96, 3)) * 255).astype(np.float32)
    want = np.asarray(JGFPGANEnhancer(params, JGFPGANv1Clean(**GFPGAN)).enhance_aligned(img))
    got = GFPGANEnhancer(file_sd, device="cpu", **GFPGAN).enhance_aligned(img).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3)
