"""The port's TPSMM (e4s2024_torch.models.tpsmm) against the JAX package's,
on the CPU: the 2-D samplers, the thin-plate-spline warps and the driver.

Narrow widths as tests/test_tpsmm.py builds them, at the vox geometry (256^2
frames, the dense motion at 64^2): 2 TPS transforms, the dense motion's
hourglass at block_expansion 8 / max_features 64, the inpainting network at
8 / 32. Weights are reference-style state dicts seeded with numpy (the
dense motion's anti-alias buffer included), carried to JAX by
`convert_tpsmm` and loaded natively by the port.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from e4s2024_tpu.convert.torch_loader import convert_tpsmm
from e4s2024_tpu.models import tpsmm as jtps

from e4s2024_torch.convert import tpsmm_state_dicts_from_jax
from e4s2024_torch.models import tpsmm
from tests.test_torch_criterion import two_threads  # noqa: F401  (autouse fixture)
from tests.test_torch_facevid2vid import _frames, np_sd, seeded_state_dict

NUM_TPS = 2
DM = dict(block_expansion=8, max_features=64)
INP = dict(block_expansion=8, max_features=32)


@pytest.mark.parametrize("align_corners", [True, False])
def test_grid_sample_2d_and_gaussians_match_jax(align_corners):
    rng = np.random.default_rng(0)
    img = rng.standard_normal((2, 6, 7, 3)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (2, 5, 4, 2)).astype(np.float32)  # reaches outside
    want = np.asarray(jtps.grid_sample_2d(jnp.asarray(img), jnp.asarray(grid), align_corners))
    got = tpsmm.grid_sample_2d(torch.from_numpy(img).permute(0, 3, 1, 2),
                               torch.from_numpy(grid), align_corners).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    kp = rng.uniform(-1, 1, (2, 4, 2)).astype(np.float32)
    want = np.asarray(jtps.kp2gaussian2d(jnp.asarray(kp), (9, 11)))
    got = tpsmm.kp2gaussian2d(torch.from_numpy(kp), (9, 11)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_tps_warp_grid_matches_jax():
    """Both sides solve the ridged 8x8 systems in float32 (torch.linalg.solve
    and jnp.linalg.solve): within 1e-4."""
    rng = np.random.default_rng(1)
    kp_d = rng.uniform(-0.9, 0.9, (2, 3, 5, 2)).astype(np.float32)
    kp_s = (kp_d + rng.normal(0, 0.1, kp_d.shape)).astype(np.float32)
    want = np.asarray(jtps.tps_warp_grid(jnp.asarray(kp_d), jnp.asarray(kp_s), 16, 12))
    got = tpsmm.tps_warp_grid(torch.from_numpy(kp_d), torch.from_numpy(kp_s), 16, 12).numpy()
    assert got.shape == (2, 3, 16, 12, 2)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.fixture(scope="module")
def drivers():
    with torch.device("meta"):
        kp, dm, inp = tpsmm.TPSKPDetector(NUM_TPS), tpsmm.TPSDenseMotion(NUM_TPS, **DM), \
            tpsmm.TPSInpainting(**INP)
    ckpt = {"kp_detector": seeded_state_dict(kp, 11),
            "dense_motion_network": seeded_state_dict(dm, 12),
            "inpainting_network": seeded_state_dict(inp, 13)}
    params = convert_tpsmm({k: np_sd(v) for k, v in ckpt.items()})
    jdrv = jtps.TPSMMDriver.__new__(jtps.TPSMMDriver)
    jdrv.kp, jdrv.dm = jtps.TPSKPDetector(NUM_TPS), jtps.TPSDenseMotion(NUM_TPS, **DM)
    jdrv.inp = jtps.TPSInpainting(**INP)
    jdrv.params = jax.tree_util.tree_map(jnp.asarray, params)
    jdrv._animate = jax.jit(jdrv._animate_p)
    drv = tpsmm.TPSMMDriver(ckpt, NUM_TPS, dm=DM, inp=INP, device="cpu")
    return jdrv, drv, ckpt, params


def test_driver_matches_jax(drivers):
    """The reenacted frame within 2e-3 max on [0, 1]."""
    jdrv, drv, _, _ = drivers
    src, tgt = _frames(14, 1), _frames(15, 1)
    want = np.asarray(jdrv._animate(jdrv.params, jnp.asarray(src), jnp.asarray(tgt)))
    got = drv(src, tgt).numpy()
    assert got.shape == (1, 256, 256, 3) and 0 <= got.min() and got.max() <= 1
    err = np.abs(got - want)
    assert err.max() <= 2e-3, (err.max(), err.mean())
    assert np.abs(got - src).mean() > 1e-3  # the frame moved


def test_state_dicts_from_jax(drivers):
    _, _, ckpt, params = drivers
    back = tpsmm_state_dicts_from_jax(params)
    want = tpsmm.tpsmm_state_dicts(ckpt)
    assert "down.weight" not in want["dense_motion_network"]
    for net in want:
        assert set(back[net]) == set(want[net]), net
        for k in want[net]:
            np.testing.assert_array_equal(back[net][k].numpy(), want[net][k].numpy())
