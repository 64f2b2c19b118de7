"""The port's DCNv2 (e4s2024_torch.ops.deform_conv) against the JAX
package's, on the CPU, and the pose-drive registry
(e4s2024_torch.pipelines.pose_drive).

Offsets are non-zero and large enough that many taps land outside the frame
(zero padding), with two deformable groups, stride 2 and dilation 2.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from e4s2024_tpu.ops import deform_conv as jdc

from e4s2024_torch.convert import dcnv2pack_state_dict_from_jax
from e4s2024_torch.ops import deform_conv as dc
from e4s2024_torch.pipelines.pose_drive import make_pose_driver
from tests.test_torch_criterion import jit_apply, two_threads  # noqa: F401  (autouse fixture)


@pytest.mark.parametrize("stride,padding,dilation", [(1, 1, 1), (2, 1, 1), (1, 2, 2)])
def test_modulated_deform_conv2d_matches_jax(stride, padding, dilation):
    rng = np.random.default_rng(stride * 10 + dilation)
    b, h, w, cin, cout, g, k = 2, 9, 11, 8, 6, 2, 3
    ho = (h + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    offset = (rng.standard_normal((b, ho, wo, g, k * k, 2)) * 3).astype(np.float32)
    mask = rng.random((b, ho, wo, g, k * k)).astype(np.float32)
    weight = (rng.standard_normal((k, k, cin, cout)) * 0.2).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    want = np.asarray(jdc.modulated_deform_conv2d(
        jnp.asarray(x), jnp.asarray(offset), jnp.asarray(mask), jnp.asarray(weight),
        jnp.asarray(bias), stride, padding, dilation))
    got = dc.modulated_deform_conv2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(offset),
        torch.from_numpy(mask), torch.from_numpy(weight).permute(3, 2, 0, 1),
        torch.from_numpy(bias), stride, padding, dilation).permute(0, 2, 3, 1).numpy()
    pos_y = np.arange(ho)[:, None, None] * stride - padding + offset[..., 0].max()
    assert (np.abs(offset) > 1).mean() > 0.5 and pos_y.max() > h  # taps leave the frame
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_dcnv2pack_matches_jax():
    """Non-zero offset-conv weights (the layer's zero start is half a plain
    conv): offsets from o1 (dy) and o2 (dx), masks from the third chunk."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 16, 20, 8)).astype(np.float32)
    feat = rng.standard_normal((1, 16, 20, 8)).astype(np.float32)
    jmod = jdc.DCNv2Pack(12, deformable_groups=2)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x),
                            jnp.asarray(feat))["params"]
    params = jax.tree_util.tree_map(
        lambda s: jnp.asarray(rng.standard_normal(s.shape).astype(np.float32) * 0.4), shapes)
    want = np.asarray(jit_apply(jmod, {"params": params}, jnp.asarray(x), jnp.asarray(feat)))
    mod = dc.DCNv2Pack(8, 12, deformable_groups=2)
    mod.load_state_dict(dcnv2pack_state_dict_from_jax(params), strict=True)
    with torch.inference_mode():
        got = mod(torch.from_numpy(x).permute(0, 3, 1, 2),
                  torch.from_numpy(feat).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    # at its zero start the layer is half a plain convolution
    fresh = dc.DCNv2Pack(8, 12)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.inference_mode():
        half = torch.nn.functional.conv2d(xt, fresh.weight, fresh.bias, padding=1) * 0.5 \
            + fresh.bias.view(1, -1, 1, 1) * 0.5
        np.testing.assert_allclose(fresh(xt, xt).numpy(), half.numpy(), atol=1e-5)


def test_registry():
    with pytest.raises(KeyError, match="unknown"):
        make_pose_driver("FOMM")
    with pytest.raises(NotImplementedError, match="PIRender"):
        make_pose_driver("PIRender")
    for name in ("TPSMM", "DaGAN", "LIA"):
        with pytest.raises(ValueError, match=name):
            make_pose_driver(name)
