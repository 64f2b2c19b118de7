"""The port's networks (e4s2024_torch.models) against the JAX package's, on
the CPU, at small sizes.

Each JAX module's parameter tree is shaped by its `init` (through
`jax.eval_shape`, which runs no computation) and filled from a numpy seed;
`e4s2024_torch.convert` carries it to the port's module, which loads it with
`load_state_dict(strict=True)`. Both sides run float32 on the same inputs.
The round-trip tests hold `convert.py` against the JAX package's own
checkpoint converter.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from e4s2024_tpu.convert.torch_loader import convert_bisenet, convert_encoder, convert_generator, convert_rgi
from e4s2024_tpu.models.bisenet import BiSeNet as JBiSeNet
from e4s2024_tpu.models.bisenet import bicubic_downsample as j_bicubic_downsample
from e4s2024_tpu.models.encoders import FSEncoderPSP as JFSEncoderPSP
from e4s2024_tpu.models.rgi import RGINet as JRGINet
from e4s2024_tpu.models.stylegan2 import EqualConv2d as JEqualConv2d
from e4s2024_tpu.models.stylegan2 import Generator as JGenerator

from e4s2024_torch import convert
from e4s2024_torch.models.bisenet import BiSeNet, bicubic_downsample
from e4s2024_torch.models.encoders import FSEncoderPSP
from e4s2024_torch.models.rgi import RGINet
from e4s2024_torch.models.stylegan2 import EqualConv2d, Generator
from tests.test_torch_criterion import jit_apply, two_threads  # noqa: F401


def random_params(tree, seed: int):
    """Fill a tree of shapes (from jax.eval_shape of `init`) with numpy
    draws scaled by what each leaf is, so that deep nets stay finite."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        parent = path[-2].key if len(path) > 1 else ""
        shape = leaf.shape
        n = rng.standard_normal(shape)
        if name == "kernel" and len(shape) == 4:  # flax Conv: lecun normal
            v = n / np.sqrt(np.prod(shape[:-1]))
        elif name in ("kernel", "weight", "input"):  # equalised-LR leaves
            v = n
        elif name == "bias" and parent == "modulation":
            v = 1.0 + 0.1 * n
        elif name == "alpha":
            v = 0.25 + 0.05 * n
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "scale":
            v = 1.0 + 0.1 * n
        elif name == "latent_avg":
            v = 0.5 * n
        else:  # biases, BN means, noise weights
            v = 0.1 * n
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def one_hot_nhwc(rng, b, h, w, k=12):
    return np.eye(k, dtype=np.float32)[rng.integers(0, k, (b, h, w))]


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).detach().numpy()


def assert_trees_equal(a, b):
    la, lb = jax.tree_util.tree_leaves_with_path(a), jax.tree_util.tree_leaves_with_path(b)
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for (pa, va), (_, vb) in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(va), np.asarray(vb), err_msg=str(pa))


def torch_to_numpy(sd):
    return {k: v.numpy() for k, v in sd.items()}


# --------------------------------------------------------------- Generator

GEN_SIZE, GEN_REMAINING = 16, 5  # masked and shared-style layers both run


@pytest.fixture(scope="module")
def generator_pair():
    jgen = JGenerator(size=GEN_SIZE, remaining_layer_idx=GEN_REMAINING)
    n_latent = jgen.n_latent
    shapes = jax.eval_shape(jgen.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 12, n_latent, 512)), None, jnp.zeros((1, 8, 8, 12)))
    params = random_params(shapes["params"], 1)
    gen = Generator(GEN_SIZE, remaining_layer_idx=GEN_REMAINING)
    gen.load_state_dict(convert.generator_state_dict_from_jax(params), strict=True)
    return jgen, params, gen.eval()


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_generator_matches_jax(generator_pair, mode):
    jgen, params, gen = generator_pair
    rng = np.random.default_rng(2)
    latent = (0.5 * rng.standard_normal((2, 12, jgen.n_latent, 512))).astype(np.float32)
    seg = one_hot_nhwc(rng, 2, 8, 8)
    want, _, _ = jit_apply(jgen, {"params": params}, jnp.asarray(latent), None,
                           jnp.asarray(seg), regional_mode=mode)
    with torch.no_grad():
        got, _, _ = gen(torch.from_numpy(latent), None, nchw(seg), regional_mode=mode)
    want = np.asarray(want)
    assert got.shape == (2, 3, GEN_SIZE, GEN_SIZE)
    # images of O(1) magnitude through 7 float32 conv layers
    np.testing.assert_allclose(nhwc(got), want, atol=2e-4 * np.abs(want).max(), rtol=1e-3)


def test_generator_noise_matches_jax(generator_pair):
    """Per-layer noise inputs, (B, res, res, 1) in JAX and (B, 1, res, res)."""
    jgen, params, gen = generator_pair
    rng = np.random.default_rng(3)
    latent = (0.5 * rng.standard_normal((1, 12, jgen.n_latent, 512))).astype(np.float32)
    seg = one_hot_nhwc(rng, 1, 8, 8)
    noise = [rng.standard_normal((1, 2 ** ((i + 5) // 2), 2 ** ((i + 5) // 2), 1)).astype(np.float32)
             for i in range(jgen.num_layers)]
    want, _, _ = jit_apply(jgen, {"params": params}, jnp.asarray(latent), None,
                           jnp.asarray(seg), noise=[jnp.asarray(n) for n in noise],
                           regional_mode="fast")
    with torch.no_grad():
        got, _, _ = gen(torch.from_numpy(latent), None, nchw(seg), noise=[nchw(n) for n in noise],
                        regional_mode="fast")
    want = np.asarray(want)
    np.testing.assert_allclose(nhwc(got), want, atol=2e-4 * np.abs(want).max(), rtol=1e-3)


def test_style_mlp_matches_jax(generator_pair):
    """pixel_norm + 8 EqualLinear(lr_mul 0.01, fused LeakyReLU): z -> w."""
    jgen, params, gen = generator_pair
    z = np.random.default_rng(4).standard_normal((3, 512)).astype(np.float32)
    want = np.asarray(jit_apply(jgen, {"params": params}, jnp.asarray(z),
                                method=JGenerator.style))
    with torch.no_grad():
        got = gen.style(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=1e-4)


@pytest.mark.parametrize("stride,padding", [(1, 1), (2, 0)])
def test_equal_conv2d_matches_jax(stride, padding):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 9, 6)).astype(np.float32)
    jconv = JEqualConv2d(8, 3, stride=stride, padding=padding)
    params = random_params(jax.eval_shape(jconv.init, jax.random.PRNGKey(0),
                                          jnp.asarray(x))["params"], 6)
    conv = EqualConv2d(6, 8, 3, stride=stride, padding=padding)
    conv.load_state_dict({"weight": torch.from_numpy(np.ascontiguousarray(
        params["weight"].transpose(3, 2, 0, 1))), "bias": torch.from_numpy(params["bias"])})
    with torch.no_grad():
        got = nhwc(conv(nchw(x)))
    np.testing.assert_allclose(got, np.asarray(jconv.apply({"params": params}, jnp.asarray(x))),
                               atol=1e-5, rtol=1e-5)


def test_generator_round_trip(generator_pair):
    _, params, gen = generator_pair
    assert_trees_equal(convert_generator(torch_to_numpy(gen.state_dict())), params)


# ------------------------------------------------------------ FSEncoderPSP

UNITS = (1, 1, 1, 1)


def test_encoder_matches_jax_and_round_trips():
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    seg = one_hot_nhwc(rng, 2, 32, 32)
    seg[1, :, :, 5] = 0.0  # an empty region pools to zeros
    jenc = JFSEncoderPSP(num_units=UNITS)
    params = random_params(jax.eval_shape(jenc.init, jax.random.PRNGKey(0), jnp.asarray(x),
                                          jnp.asarray(seg))["params"], 4)
    want, _ = jit_apply(jenc, {"params": params}, jnp.asarray(x), jnp.asarray(seg))
    enc = FSEncoderPSP(UNITS)
    enc.load_state_dict(convert.encoder_state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got, struct = enc(nchw(x), nchw(seg))
    assert got.shape == (2, 12, 1280) and struct.shape == (2, 512, 4, 4)
    # instance-normalised features of O(1): float32 summation order only
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    assert_trees_equal(convert_encoder(torch_to_numpy(enc.state_dict())), params)


# ----------------------------------------------------------------- BiSeNet


@pytest.fixture(scope="module")
def bisenet_pair():
    jnet = JBiSeNet()
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    params = random_params(shapes["params"], 5)
    net = BiSeNet()
    net.load_state_dict(convert.bisenet_state_dict_from_jax(params), strict=True)
    return jnet, params, net.eval()


def test_bisenet_matches_jax(bisenet_pair):
    jnet, params, net = bisenet_pair
    x = np.random.default_rng(6).standard_normal((2, 64, 64, 3)).astype(np.float32)
    want = jit_apply(jnet, {"params": params}, jnp.asarray(x), aux=True)
    with torch.no_grad():
        got = net(nchw(x), aux=True)
        main_low, _, _ = net(nchw(x), aux=False, upsample=False)
    want_low, _, _ = jit_apply(jnet, {"params": params}, jnp.asarray(x), aux=False,
                               upsample=False)
    for g, w in zip(got, want):
        w = np.asarray(w)
        # logits of O(10) through 20 conv layers: relative float32 bound
        np.testing.assert_allclose(nhwc(g), w, atol=1e-4 * np.abs(w).max(), rtol=1e-4)
    np.testing.assert_allclose(nhwc(main_low), np.asarray(want_low),
                               atol=1e-4 * np.abs(np.asarray(want_low)).max(), rtol=1e-4)


def test_bisenet_round_trip(bisenet_pair):
    _, params, net = bisenet_pair
    assert_trees_equal(convert_bisenet(torch_to_numpy(net.state_dict())), params)


@pytest.mark.parametrize("factor", [2, 4])
def test_bicubic_downsample_matches_jax(factor):
    x = np.random.default_rng(7).random((2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(j_bicubic_downsample(jnp.asarray(x), factor))
    np.testing.assert_allclose(nhwc(bicubic_downsample(nchw(x), factor)), want, atol=1e-5)


# ------------------------------------------------------------------ RGINet

RGI_KW = dict(out_size=16, remaining_layer_idx=5, encoder_input_size=64, encoder_num_units=UNITS)


@pytest.fixture(scope="module")
def rgi_pair():
    jrgi = JRGINet(**RGI_KW)
    shapes = jax.eval_shape(jrgi.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                            jnp.zeros((1, 16, 16, 12)))
    variables = random_params(shapes, 8)
    rgi = RGINet(**RGI_KW)
    rgi.load_state_dict(convert.rgi_state_dict_from_jax(variables), strict=True)
    return jrgi, variables, rgi.eval()


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_rgi_matches_jax(rgi_pair, mode):
    """get_style_vectors -> cal_style_codes -> gen_img, stage by stage."""
    jrgi, variables, rgi = rgi_pair
    rng = np.random.default_rng(9)
    img = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    seg = one_hot_nhwc(rng, 1, 16, 16)
    sv_j, _ = jit_apply(jrgi, variables, jnp.asarray(img), jnp.asarray(seg),
                        method=JRGINet.get_style_vectors)
    codes_j = jit_apply(jrgi, variables, sv_j, method=JRGINet.cal_style_codes)
    img_j, _, _ = jit_apply(jrgi, variables, None, codes_j, jnp.asarray(seg),
                            method=JRGINet.gen_img, regional_mode=mode)
    with torch.no_grad():
        sv, _ = rgi.get_style_vectors(nchw(img), nchw(seg))
        codes = rgi.cal_style_codes(sv)
        out, _, _ = rgi.gen_img(None, codes, nchw(seg), regional_mode=mode)
    np.testing.assert_allclose(sv.numpy(), np.asarray(sv_j), atol=1e-4, rtol=1e-4)
    codes_j = np.asarray(codes_j)
    np.testing.assert_allclose(codes.numpy(), codes_j, atol=1e-4 * np.abs(codes_j).max(), rtol=1e-4)
    img_j = np.asarray(img_j)
    np.testing.assert_allclose(nhwc(out), img_j, atol=2e-4 * np.abs(img_j).max(), rtol=1e-3)


def test_rgi_round_trip(rgi_pair):
    _, variables, rgi = rgi_pair
    assert_trees_equal(convert_rgi(torch_to_numpy(rgi.state_dict())), variables)
