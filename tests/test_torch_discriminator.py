"""The port's StyleGAN2 Discriminator and R1 against the JAX package's, on
the CPU, at the trainer tests' tiny size (16^2, channel multiplier 1, so
512 channels throughout; B=4, one stddev group of 4): the forward through
`convert_discriminator` from a reference-style state dict seeded with
numpy, R1 and its gradient in every parameter against `jax.grad`, the
plain versions' double backward of K1 and K2 against JAX's second
derivatives, and a reference file's Blur buffers checked and dropped.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e4s2024_tpu.convert.torch_loader import convert_discriminator
from e4s2024_tpu.losses import r1_penalty as j_r1_penalty
from e4s2024_tpu.models import Discriminator as JDiscriminator
from e4s2024_tpu.ops.fused_act import fused_leaky_relu as j_fused_leaky_relu
from e4s2024_tpu.ops.upfirdn import upfirdn2d as j_upfirdn2d

from e4s2024_torch.convert import discriminator_state_dict_from_jax, drop_discriminator_buffers
from e4s2024_torch.losses.losses import r1_penalty
from e4s2024_torch.models.stylegan2 import Discriminator
from e4s2024_torch.ops import fused_act, upfirdn
from e4s2024_torch.ops.upfirdn import make_kernel
from tests.test_torch_criterion import two_threads  # noqa: F401  (autouse fixture)
from tests.test_torch_gpen import nchw, np_sd, reference_state_dict

SIZE = 16  # the trainer tests' size (tests/test_torch_coach.py)


def reference_discriminator(seed: int = 0) -> dict:
    """A reference-style Discriminator state dict (numpy-seeded weights) with
    the reference's Blur `kernel` buffers of each ResBlock."""
    sd = reference_state_dict(Discriminator(SIZE, 1), seed)
    n_res = sum(1 for k in sd if k.endswith(".conv1.0.weight"))
    for i in range(1, n_res + 1):
        for branch in ("conv2", "skip"):
            sd[f"convs.{i}.{branch}.0.kernel"] = make_kernel([1, 3, 3, 1])
    return sd


@pytest.fixture(scope="module")
def nets():
    """The port's D from the reference-style dict (buffers dropped) and
    JAX's from the same dict through the JAX package's converter."""
    sd = reference_discriminator()
    d = Discriminator(SIZE, 1)
    d.load_state_dict(drop_discriminator_buffers(sd), strict=True)
    jparams = convert_discriminator(np_sd(sd))
    return d, JDiscriminator(size=SIZE, channel_multiplier=1), jparams


def _images(seed, b=4):
    return np.tanh(np.random.default_rng(seed).standard_normal((b, SIZE, SIZE, 3))).astype(
        np.float32)


@pytest.mark.parametrize("b", [4, 2])
def test_discriminator_matches_jax(nets, b):
    """Logits within 1e-5 of the largest (float32 summation order), at one
    stddev group of 4 and of 2."""
    d, jd, jparams = nets
    x = _images(1, b)
    want = np.asarray(jd.apply({"params": jparams}, x))
    with torch.no_grad():
        got = d(nchw(x)).numpy()
    assert got.shape == (b, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_converter_inverse_round_trips(nets):
    d, _, jparams = nets
    back = discriminator_state_dict_from_jax(jparams)
    assert set(back) == set(d.state_dict())
    for k, v in d.state_dict().items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)


def test_r1_and_its_gradient_match_jax(nets):
    """R1 within 1e-5 relative, its gradient in every parameter within 1e-4
    of that tensor's largest element (a second derivative through 512-wide
    convolutions: float32 summation order, twice)."""
    d, jd, jparams = nets
    x = _images(2)
    r1 = r1_penalty(d, nchw(x))
    # the last bias does not reach the input gradient: no gradient (JAX: 0)
    grads = torch.autograd.grad(r1, list(d.parameters()), allow_unused=True)

    def j_r1(p):
        return j_r1_penalty(lambda v: jd.apply({"params": p}, v), jnp.asarray(x))

    want, jgrads = jax.value_and_grad(j_r1)(jparams)
    np.testing.assert_allclose(float(r1), float(want), rtol=1e-5)
    want_sd = discriminator_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    for (name, _), g in zip(d.named_parameters(), grads):
        w = want_sd[name]
        g = torch.zeros_like(w) if g is None else g
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * float(w.abs().max()), msg=name)


def _composite(act, fir):
    """x -> sum(w * fir(act(conv(x) + b))): a conv, K1 and K2 in a row."""
    def f(x, conv_w, b, w):
        return (w * fir(act(x * conv_w, b))).sum()
    return f


def test_plain_double_backward_of_k1_and_k2_match_jax():
    """The penalty ||d f / d x||^2 of f = sum(w * blur(K1(x * c + b))), and its
    gradient in c (a per-channel scale), b and w: the port's plain versions
    differentiated twice against JAX's XLA ops. K2 runs the
    discriminator's downsampling blur (pad (2, 2)) and an up-2 skip."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 9, 10)).astype(np.float32)
    c = rng.standard_normal((1, 3, 1, 1)).astype(np.float32)
    b = (0.3 * rng.standard_normal(3)).astype(np.float32)
    k = make_kernel([1, 3, 3, 1])
    for up, down, pad, gain in ((1, 2, (2, 2), 1.0), (2, 1, (2, 1), 4.0)):
        kk = k * gain
        oh, ow = (upfirdn.out_size(n, 4, up, down, pad) for n in x.shape[2:])
        w = rng.standard_normal((2, 3, oh, ow)).astype(np.float32)

        def port(xt, ct, bt, wt):
            y = fused_act.fused_leaky_relu(xt * ct, bt)
            return (wt * upfirdn.upfirdn2d(y, kk, up, down, pad)).sum()

        def jax_f(xj, cj, bj, wj):
            y = j_fused_leaky_relu(jnp.transpose(xj * cj, (0, 2, 3, 1)), bj)
            z = j_upfirdn2d(y, jnp.asarray(kk.numpy()), up=up, down=down, pad=pad)
            return jnp.sum(wj * jnp.transpose(z, (0, 3, 1, 2)))

        ts = [torch.from_numpy(v).requires_grad_(True) for v in (x, c, b, w)]
        (gx,) = torch.autograd.grad(port(*ts), ts[0], create_graph=True)
        pen = gx.square().sum()
        # the bias moves only K1's sign mask: no gradient (JAX: 0)
        got = torch.autograd.grad(pen, ts[1:], allow_unused=True)

        def j_pen(xj, cj, bj, wj):
            return jnp.sum(jnp.square(jax.grad(jax_f)(xj, cj, bj, wj)))

        want_pen, want = jax.value_and_grad(j_pen, argnums=(1, 2, 3))(x, c, b, w)
        np.testing.assert_allclose(float(pen), float(want_pen), rtol=1e-5)
        for g, wj in zip(got, want):
            wj = np.asarray(wj)
            g = np.zeros_like(wj) if g is None else g.numpy()
            np.testing.assert_allclose(g, wj, rtol=0, atol=1e-5 * np.abs(wj).max())


def test_reference_buffers_checked_and_dropped():
    """A reference file's Blur buffers (gain 1) are dropped with DDP's
    `module.` prefix; one that differs from the port's constant raises."""
    sd = reference_discriminator(1)
    d = Discriminator(SIZE, 1)
    d.load_state_dict(drop_discriminator_buffers({f"module.{k}": v for k, v in sd.items()}),
                      strict=True)
    bad = dict(sd)
    bad["convs.2.skip.0.kernel"] = make_kernel([1, 3, 3, 1]) * 4
    with pytest.raises(ValueError, match="convs.2.skip.0.kernel"):
        drop_discriminator_buffers(bad)
    with pytest.raises(RuntimeError):  # a buffer kept is an unexpected key
        d.load_state_dict(sd, strict=True)
