"""The port's loss stack against the JAX package's, on the CPU: adaptive
and global pooling, dilation and erosion, the three loss nets (LPIPS
AlexNet, IR-SE-50 ArcFace, the face-parsing U-Net) with weights seeded in
torch and carried to JAX by the JAX package's converters, the converters'
inverses, the reconstruction criterion term by term with its gradient, the
other training losses, and K1's bias gradient (its wrapper once detached
the bias).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from e4s2024_tpu.convert.torch_loader import convert_arcface, convert_lpips, convert_parsing_unet
from e4s2024_tpu.losses import losses as jlosses
from e4s2024_tpu.losses.recon import ReconCriterion as JReconCriterion
from e4s2024_tpu.models.arcface import ArcFaceBackbone as JArcFace
from e4s2024_tpu.models.lpips import LPIPS as JLPIPS
from e4s2024_tpu.models.parser_unet import ParsingUNet as JParsingUNet
from e4s2024_tpu.ops.morphology import dilation as j_dilation, erosion as j_erosion
from e4s2024_tpu.ops.pool import _bin_matrix, adaptive_avg_pool2d as j_adaptive_avg_pool2d

from e4s2024_torch.convert import (
    arcface_state_dict_from_jax, lpips_state_dict_from_jax, parsing_unet_state_dict_from_jax)
from e4s2024_torch.losses import losses
from e4s2024_torch.losses.recon import ReconCriterion
from e4s2024_torch.models.arcface import ArcFaceBackbone, FrozenBatchNorm
from e4s2024_torch.models.lpips import LPIPS
from e4s2024_torch.models.parser_unet import ParsingUNet
from e4s2024_torch.ops import fused_act
from e4s2024_torch.ops.morphology import dilation, erosion
from e4s2024_torch.ops.pool import adaptive_avg_pool2d, global_avg_pool
from tests.torch_ranks import release_memory

# ArcFace taps (C, H, W) at a 112^2 input: units 2, 6, 20, 23
ARCFACE_TAPS = ((64, 56, 56), (128, 28, 28), (256, 14, 14), (512, 7, 7))


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two torch threads for a module's fixtures and tests: the suite runs
    six workers on the host's cores, and these tests' many small ops, each
    a parallel region over every core, then wait on descheduled threads
    (the other port test files import this fixture; module scope, so that
    their module-scoped fixtures, which build the nets, run on two threads
    too); at the module's end its memory goes back to the system
    (`torch_ranks.release_memory`)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
    release_memory()


def jit_apply(module, variables, *args, **static):
    """`module.apply(variables, *args, **static)` as one compiled program:
    op by op, a net's JAX reference takes several times as long on the CPU.
    The variables and arrays are the program's arguments (as constants,
    XLA would fold them at compile time); the keywords stay fixed."""
    return jax.jit(lambda v, *a: module.apply(v, *a, **static))(variables, *args)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def seeded_state_dict(module: torch.nn.Module, seed: int) -> dict[str, torch.Tensor]:
    """Weights drawn from a numpy seed by what each tensor is, so that deep
    nets stay finite: convolutions and linear layers scaled by their fan-in,
    BatchNorm statistics and affine terms near identity, PReLU slopes near
    0.25, biases small."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, m in module.named_modules():
        p = f"{name}." if name else ""
        for key, t in list(m.named_parameters(recurse=False)) + list(m.named_buffers(recurse=False)):
            shape = tuple(t.shape)
            n = rng.standard_normal(shape)
            if isinstance(m, FrozenBatchNorm):
                v = {"weight": 1 + 0.1 * n, "bias": 0.1 * n, "running_mean": 0.1 * n,
                     "running_var": rng.uniform(0.5, 1.5, shape)}[key]
            elif isinstance(m, torch.nn.PReLU):
                v = 0.25 + 0.05 * n
            elif key == "weight" and isinstance(m, torch.nn.ConvTranspose2d):
                v = n / np.sqrt(shape[0])
            elif key == "weight":
                v = n / np.sqrt(np.prod(shape[1:]))
            else:
                v = 0.1 * n
            out[p + key] = torch.from_numpy(v.astype(np.float32))
    return {k: v for k, v in out.items() if k in module.state_dict()}


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


@pytest.fixture(scope="module")
def loss_nets():
    """(torch modules with seeded weights, their JAX params via the JAX
    package's converters)."""
    nets = {"lpips": LPIPS(), "arcface": ArcFaceBackbone(), "parser": ParsingUNet()}
    for seed, net in enumerate(nets.values(), start=30):
        sd = seeded_state_dict(net, seed)
        # LPIPS's lin heads weigh squared differences: non-negative
        net.load_state_dict({k: v.abs() if k.startswith("lin") else v for k, v in sd.items()})
        net.eval().requires_grad_(False)
    lp = _np(nets["lpips"].state_dict())
    jparams = {"lpips": convert_lpips(lp, lp),
               "arcface": convert_arcface(_np(nets["arcface"].state_dict())),
               "parser": convert_parsing_unet(_np(nets["parser"].state_dict()))}
    return nets, jparams


def _images(seed, b, size):
    """Smooth random images in [-1, 1], (b, size, size, 3)."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(-1, 1, (b, 8, 8, 3))
    img = np.kron(coarse, np.ones((1, size // 8, size // 8, 1)))
    return np.clip(img + 0.1 * rng.standard_normal(img.shape), -1, 1).astype(np.float32)


# ------------------------------------------------------------ ops


@pytest.mark.parametrize("h,w,oh,ow", [(1024, 1024, 256, 256), (188, 188, 112, 112),
                                       (64, 64, 256, 256), (37, 29, 5, 11)])
def test_adaptive_avg_pool2d_matches_jax_bins(h, w, oh, ow):
    """torch's bins against JAX's `_bin_matrix` (the 188 -> 112 case is the
    ID loss's after its 35:223 crop); float32 summation order only."""
    x = np.random.default_rng(h + ow).standard_normal((1, h, w, 3)).astype(np.float32)
    got = nhwc(adaptive_avg_pool2d(nchw(x), (oh, ow)))
    want = np.einsum("oh,bhwc->bowc", _bin_matrix(oh, h), x)
    want = np.einsum("pw,bhwc->bhpc", _bin_matrix(ow, w), want)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(j_adaptive_avg_pool2d(jnp.asarray(x), (oh, ow))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(global_avg_pool(nchw(x)).numpy()[..., 0, 0], x.mean(axis=(1, 2)),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("size", [3, 7, 31])
def test_dilation_erosion_match_jax(size):
    x = np.random.default_rng(size).random((2, 40, 33, 2)).astype(np.float32)
    for ours, theirs in ((dilation, j_dilation), (erosion, j_erosion)):
        np.testing.assert_array_equal(nhwc(ours(nchw(x), size)),
                                      np.asarray(theirs(jnp.asarray(x), size)))


# ------------------------------------------------------------ loss nets


def test_lpips_matches_jax(loss_nets):
    nets, jp = loss_nets
    x, y = _images(1, 2, 64), _images(2, 2, 64)
    got = float(nets["lpips"](nchw(x), nchw(y)))
    want = float(jit_apply(JLPIPS(), {"params": jp["lpips"]}, jnp.asarray(x), jnp.asarray(y)))
    assert got == pytest.approx(want, rel=1e-5)


def test_arcface_matches_jax(loss_nets):
    """Taps and embedding at 112^2; the port's taps flatten in (C, H, W)
    order, JAX's in (H, W, C); each is held after the permutation."""
    nets, jp = loss_nets
    x = _images(3, 2, 112)
    got = nets["arcface"](nchw(x), multi_scale=True)
    want = jit_apply(JArcFace(), {"params": jp["arcface"]}, jnp.asarray(x), multi_scale=True)
    assert len(got) == len(want) == 5
    for g, w, shape in zip(got, want, ARCFACE_TAPS + (None,)):
        g = g.numpy()
        if shape is not None:
            g = g.reshape(2, *shape).transpose(0, 2, 3, 1).reshape(2, -1)
        np.testing.assert_allclose(g, np.asarray(w), atol=2e-5 * np.abs(w).max(), rtol=1e-4)


def test_parser_unet_matches_jax(loss_nets):
    """Encoder features (the loss's), permuted as ArcFace's, and the full
    segmentation head, whose transposed convolutions prove the layout."""
    nets, jp = loss_nets
    x = _images(4, 1, 64)
    net = nets["parser"]
    got = net.extract_feats(nchw(x))
    want = jit_apply(JParsingUNet(), {"params": jp["parser"]}, jnp.asarray(x),
                     method=JParsingUNet.extract_feats)
    for i, (g, w) in enumerate(zip(got, want)):
        c, s = 16 * 2 ** i, 64 // 2 ** i
        g = g.numpy().reshape(1, c, s, s).transpose(0, 2, 3, 1).reshape(1, -1)
        np.testing.assert_allclose(g, np.asarray(w), atol=2e-5 * np.abs(w).max(), rtol=1e-4)
    logits = jit_apply(JParsingUNet(), {"params": jp["parser"]}, jnp.asarray(x))
    np.testing.assert_allclose(nhwc(net(nchw(x))), np.asarray(logits),
                               atol=1e-4 * np.abs(logits).max(), rtol=1e-4)


def test_state_dict_from_jax_round_trips(loss_nets):
    """Port state dict -> JAX converter -> `*_state_dict_from_jax` -> the same
    state dict, bit for bit."""
    nets, jp = loss_nets
    for name, back in (("lpips", lpips_state_dict_from_jax),
                       ("arcface", arcface_state_dict_from_jax),
                       ("parser", parsing_unet_state_dict_from_jax)):
        sd = nets[name].state_dict()
        again = back(jp[name])
        assert set(again) == set(sd), name
        for k in sd:
            torch.testing.assert_close(again[k], sd[k], rtol=0, atol=0, msg=f"{name}: {k}")


# gradient bounds, as a share of the largest element: JAX's CPU gradient
# through the 24 IR-SE units differs from a float64 run of the port by
# 2.4e-3 of its largest element, the port's by 1.4e-6 (measured, CPU)
GRAD_RTOL = {"l2": 1e-4, "lpips": 1e-4, "id": 5e-3, "face_parsing": 1e-3}


@pytest.mark.parametrize("term", ["l2", "lpips", "id", "face_parsing"])
def test_recon_criterion_matches_jax(loss_nets, term):
    """Each term alone at 64^2 (LPIPS at 64 and 32 px, ArcFace after the ID
    crop, the parser after pooling up to 512^2): the loss, and its gradient
    with respect to the reconstruction, against jax.grad (bounds in
    GRAD_RTOL)."""
    nets, jp = loss_nets
    lambdas = dict.fromkeys(("l2_lambda", "lpips_lambda", "id_lambda",
                             "face_parsing_lambda"), 0.0)
    lambdas[f"{term}_lambda"] = 1.0
    recon, img = _images(5, 2, 64), _images(6, 2, 64)
    crit = ReconCriterion(nets, **lambdas)
    r = nchw(recon).requires_grad_(True)
    loss, metrics = crit(r, nchw(img))
    (grad,) = torch.autograd.grad(loss, r)
    loss = loss.detach()
    jcrit = JReconCriterion(jp, **lambdas)
    # the target is an argument: captured as a constant, XLA's CPU compile
    # folds the target's whole branch (the 512^2 parser: a minute)
    value_and_grad = jax.jit(jax.value_and_grad(lambda a, b: jcrit(a, b)[0]))
    jloss, jgrad = value_and_grad(jnp.asarray(recon), jnp.asarray(img))
    assert float(loss) == pytest.approx(float(jloss), rel=2e-5)
    assert float(metrics[f"loss_{term}"].detach()) == pytest.approx(float(jloss), rel=2e-5)
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(nhwc(grad), jgrad, atol=GRAD_RTOL[term] * np.abs(jgrad).max(),
                               rtol=1e-3)


def test_losses_match_jax():
    rng = np.random.default_rng(7)
    fake, real = rng.standard_normal((4, 1)), rng.standard_normal((4, 1))
    assert float(losses.adv_g_loss(torch.tensor(fake))) == pytest.approx(
        float(jlosses.adv_g_loss(jnp.asarray(fake))), rel=1e-6)
    assert float(losses.adv_d_loss(torch.tensor(real), torch.tensor(fake))) == pytest.approx(
        float(jlosses.adv_d_loss(jnp.asarray(real), jnp.asarray(fake))), rel=1e-6)
    lat = rng.standard_normal((2, 12, 10, 512)).astype(np.float32)
    avg = rng.standard_normal((10, 512)).astype(np.float32)
    assert float(losses.w_norm_loss(torch.tensor(lat), torch.tensor(avg))) == pytest.approx(
        float(jlosses.w_norm_loss(jnp.asarray(lat), jnp.asarray(avg))), rel=1e-5)
    grads = rng.standard_normal((2, 10, 512)).astype(np.float32)
    got = losses.g_path_lengths_penalty(torch.tensor(grads), torch.tensor(0.5))
    want = jlosses.g_path_lengths_penalty(jnp.asarray(grads), jnp.asarray(0.5))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)
    # R1 through a conv, K1's plain version and a head: second order on the CPU
    w1 = rng.standard_normal((4, 3, 3, 3)).astype(np.float32) / 5
    b1 = rng.standard_normal(4).astype(np.float32)
    img = rng.standard_normal((2, 3, 8, 8)).astype(np.float32)

    def d_torch(x):
        h = fused_act.fused_leaky_relu(torch.nn.functional.conv2d(x, torch.tensor(w1), padding=1),
                                       torch.tensor(b1))
        return h.mean(dim=(1, 2, 3))

    def d_jax(x):  # NHWC
        h = jax.lax.conv_general_dilated(x, jnp.asarray(w1.transpose(2, 3, 1, 0)), (1, 1),
                                         "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
        h = h + b1
        h = jnp.where(h >= 0, h, 0.2 * h) * np.sqrt(2.0)
        return h.mean(axis=(1, 2, 3))

    r1 = losses.r1_penalty(d_torch, torch.tensor(img))
    assert r1.requires_grad
    assert float(r1) == pytest.approx(
        float(jlosses.r1_penalty(d_jax, jnp.asarray(img.transpose(0, 2, 3, 1)))), rel=1e-5)


# ------------------------------------------------------------ K1's bias


def test_fused_leaky_relu_bias_gradient_without_x_gradient():
    """A bias that requires grad gets its gradient when x needs none (the
    wrapper once detached the bias); both against the closed form."""
    rng = np.random.default_rng(8)
    x = torch.tensor(rng.standard_normal((2, 5, 3, 4)).astype(np.float32))
    bias = torch.tensor(rng.standard_normal(5).astype(np.float32), requires_grad=True)
    g = torch.tensor(rng.standard_normal((2, 5, 3, 4)).astype(np.float32))
    out = fused_act.fused_leaky_relu(x, bias)
    (gb,) = torch.autograd.grad(out, bias, g)
    y = x + bias.detach().view(1, -1, 1, 1)
    want = (g * torch.where(y >= 0, 1.0, 0.2) * np.sqrt(2.0)).sum(dim=(0, 2, 3))
    torch.testing.assert_close(gb, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(fused_act.fused_leaky_relu_backward(g, out),
                               g * torch.where(y >= 0, 1.0, 0.2) * np.sqrt(2.0))
