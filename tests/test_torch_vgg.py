"""The port's VGG16 features and Gram style loss (e4s2024_torch.models.vgg)
against the JAX package's, on the CPU: torchvision-named weights written
from a numpy seed, bridged by `convert_vgg16`, 64^2 inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from e4s2024_tpu.convert import convert_vgg16
from e4s2024_tpu.models import vgg as jvgg

from e4s2024_torch.models import StyleGramLoss, VGG16Features, gram_matrix
from tests.test_torch_criterion import jit_apply, nchw, nhwc, two_threads  # noqa: F401

TAPS = (3, 8, 15, 21)


@pytest.fixture(scope="module")
def weights():
    """torchvision vgg16 weights (`features.*` and a classifier key, which
    the loss ignores), He-scaled from a numpy seed."""
    rng = np.random.default_rng(0)
    sd = {}
    for name, t in VGG16Features().state_dict().items():
        if name.endswith("weight"):
            fan_in = int(np.prod(t.shape[1:]))
            v = rng.standard_normal(t.shape) * np.sqrt(2.0 / fan_in)
        else:
            v = 0.05 * rng.standard_normal(t.shape)
        sd[name] = torch.from_numpy(v.astype(np.float32))
    sd["classifier.0.weight"] = torch.zeros(4, 4)
    return sd


def _images(seed, n=2, size=64):
    rng = np.random.default_rng(seed)
    return (rng.random((n, size, size, 3)) * 2 - 1).astype(np.float32)


def test_features_match_jax(weights):
    """Activations at torchvision indices 3, 8, 15, 21 within 1e-4 of each
    tap's largest value (float32, CPU)."""
    net = VGG16Features(TAPS)
    net.load_state_dict({k: v for k, v in weights.items() if k.startswith("features.")})
    params = convert_vgg16({k: v.numpy() for k, v in weights.items()})
    x = _images(1)
    with torch.no_grad():
        got = net(nchw(x))
    want = jit_apply(jvgg.VGG16Features(taps=TAPS), {"params": params}, jnp.asarray(x))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(nhwc(g), w, rtol=0, atol=1e-4 * np.abs(w).max())
    np.testing.assert_allclose(gram_matrix(nchw(x)).numpy(),
                               np.asarray(jvgg.gram_matrix(jnp.asarray(x))), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("normalize,masked", [(False, False), (True, True)])
def test_style_gram_loss_matches_jax(weights, normalize, masked):
    """The loss at 256^2 (both packages resize), with and without
    ImageNet normalisation and masks: within 1e-4 relative of JAX's."""
    x, x_hat = _images(2), _images(3)
    loss = StyleGramLoss(weights, taps=(8, 15), normalize=normalize)
    jloss = jvgg.StyleGramLoss(convert_vgg16({k: v.numpy() for k, v in weights.items()}),
                               taps=(8, 15), normalize=normalize)
    masks = (None, None)
    jmasks = (None, None)
    if masked:
        rng = np.random.default_rng(4)
        m = (rng.random((2, 2, 48, 48, 1)) > 0.3).astype(np.float32)
        masks = (nchw(m[0]), nchw(m[1]))
        jmasks = (jnp.asarray(m[0]), jnp.asarray(m[1]))
    with torch.no_grad():
        got = float(loss(nchw(x), nchw(x_hat), *masks))
    want = float(jloss(jnp.asarray(x), jnp.asarray(x_hat), *jmasks))
    assert got > 0
    assert got == pytest.approx(want, rel=1e-4)
