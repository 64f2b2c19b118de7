"""The port's DaGAN (e4s2024_torch.models.dagan) against the JAX package's,
on the CPU: the depth network, the keypoint detector with jacobians and the
driver.

Narrow widths as tests/test_dagan.py builds them, on 64^2 frames: 3
keypoints, the hourglasses at block_expansion 8 / max_features 32 with 2
blocks, the keypoint detector at scale 0.5, the generator at 8 / 32 with 2
bottleneck blocks, the depth encoder's ResNet-50 with one Bottleneck per
layer and a narrow depth decoder. Weights are reference-style state dicts
seeded with numpy (the anti-alias buffers, the encoder's ImageNet `fc` and
the decoder's unused disparity heads included, as the files hold them),
carried to JAX by `convert_dagan` and loaded natively by the port.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from e4s2024_tpu.convert.torch_loader import convert_dagan
from e4s2024_tpu.models import dagan as jdagan

from e4s2024_torch.convert import dagan_state_dicts_from_jax
from e4s2024_torch.models import dagan
from tests.test_torch_criterion import jit_apply, two_threads  # noqa: F401  (autouse fixture)
from tests.test_torch_facevid2vid import np_sd, seeded_state_dict

NUM_KP, LAYERS, DCH = 3, (1, 1, 1, 1), (4, 8, 16, 32, 64)
KP = dict(block_expansion=8, max_features=32, num_blocks=2, scale_factor=0.5)
DMK = dict(block_expansion=8, max_features=32, num_blocks=2, scale_factor=0.25)
GEN = dict(block_expansion=8, max_features=32, num_down_blocks=2, num_bottleneck_blocks=2,
           dense_motion=DMK)


@pytest.fixture(scope="module")
def drivers():
    with torch.device("meta"):
        nets = {"generator": dagan.DepthAwareGenerator(NUM_KP, **GEN),
                "kp_detector": dagan.DaGANKPDetector(NUM_KP, **KP),
                "depth_encoder": dagan.DepthResnetEncoder(LAYERS),
                "depth_decoder": dagan.DepthDecoder(DCH)}
    sds = {k: seeded_state_dict(m, 31 + i) for i, (k, m) in enumerate(nets.items())}
    sds["generator"]["AttnModule.gamma"] = torch.tensor([0.7])  # the attention counts
    g = torch.Generator().manual_seed(35)
    sds["depth_encoder"]["encoder.fc.weight"] = torch.randn(1000, 2048, generator=g)
    sds["depth_encoder"]["encoder.fc.bias"] = torch.randn(1000, generator=g)
    for s, n in ((1, 11), (2, 12), (3, 13)):
        sds["depth_decoder"][f"decoder.{n}.conv.weight"] = torch.randn(1, DCH[s], 3, 3,
                                                                       generator=g)
        sds["depth_decoder"][f"decoder.{n}.conv.bias"] = torch.randn(1, generator=g)
    params = convert_dagan(*(np_sd(sds[k]) for k in nets), num_kp=NUM_KP, num_blocks=2,
                           num_down_blocks=2, num_bottleneck=2, resnet_layers=LAYERS)
    jdrv = jdagan.DaGANDriver.__new__(jdagan.DaGANDriver)
    jdrv.enc, jdrv.dec = jdagan.DepthResnetEncoder(LAYERS), jdagan.DepthDecoder(DCH)
    jdrv.kp = jdagan.DaGANKPDetector(NUM_KP, **KP)
    jdrv.gen = jdagan.DepthAwareGenerator(NUM_KP, **{k: v for k, v in GEN.items()})
    jdrv.params = jax.tree_util.tree_map(jnp.asarray, params)
    jdrv._animate = jax.jit(jdrv._animate_p)
    drv = dagan.DaGANDriver(sds, NUM_KP, kp=KP, gen=GEN, resnet_layers=LAYERS,
                            num_ch_dec=DCH, device="cpu")
    return jdrv, drv, sds, params


def _frames(seed, n, size=64):
    rng = np.random.default_rng(seed)
    coarse = rng.random((n, 8, 8, 3))
    img = np.kron(coarse, np.ones((1, size // 8, size // 8, 1))) * 0.8 + \
        rng.random((n, size, size, 3)) * 0.2
    return img.astype(np.float32)


def test_depth_and_keypoints_match_jax(drivers):
    """The disparity within 1e-4 and the keypoints and jacobians within
    1e-4."""
    jdrv, drv, _, _ = drivers
    img = _frames(36, 2)
    p = jdrv.params
    feats = jit_apply(jdrv.enc, {"params": p["depth_encoder"]}, jnp.asarray(img))
    want_d = jit_apply(jdrv.dec, {"params": p["depth_decoder"]}, feats)
    x = torch.from_numpy(img).permute(0, 3, 1, 2)
    with torch.inference_mode():
        got_d = drv.dec(drv.enc(x))
        np.testing.assert_allclose(got_d.permute(0, 2, 3, 1).numpy(), np.asarray(want_d),
                                   atol=1e-4)
        got = drv.kp(torch.cat([x, got_d], 1))
    want = jit_apply(jdrv.kp, {"params": p["kp_detector"]},
                     jnp.concatenate([jnp.asarray(img), want_d], -1))
    for key in ("value", "jacobian"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-4,
                                   err_msg=key)


def test_driver_matches_jax(drivers):
    """The reenacted frame within 2e-3 max on [0, 1]."""
    jdrv, drv, _, _ = drivers
    src, tgt = _frames(37, 1), _frames(38, 1)
    want = np.asarray(jdrv._animate(jdrv.params, jnp.asarray(src), jnp.asarray(tgt)))
    got = drv(src, tgt).numpy()
    assert got.shape == (1, 64, 64, 3) and 0 <= got.min() and got.max() <= 1
    err = np.abs(got - want)
    assert err.max() <= 2e-3, (err.max(), err.mean())


def test_state_dicts_from_jax_and_dropped_entries(drivers):
    """JAX params -> `dagan_state_dicts_from_jax` -> the files without their
    fixed buffers and the entries inference never reads."""
    _, _, sds, params = drivers
    back = dagan_state_dicts_from_jax(params)
    want = dagan.dagan_state_dicts(sds["generator"], sds["kp_detector"], sds["depth_encoder"],
                                   sds["depth_decoder"], KP["scale_factor"])
    assert "encoder.fc.weight" not in want["depth_encoder"]
    assert "decoder.11.conv.weight" not in want["depth_decoder"]
    assert "down.weight" not in want["kp_detector"]
    for net in want:
        assert set(back[net]) == set(want[net]), net
        for k in want[net]:
            np.testing.assert_array_equal(back[net][k].numpy(), want[net][k].numpy())
