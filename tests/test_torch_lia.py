"""The port's LIA (e4s2024_torch.models.lia) and the StyleGAN2 ResBlock its
encoder is built of against the JAX package's, on the CPU.

LIA at size 64 (motion_dim 4), as tests/test_lia.py builds it: its channel
plan is fixed, 512 channels up to 32^2. Weights are a reference-style file
seeded with numpy (inside its 'gen' envelope, with LIA's (1, C, 1, 1)
activation biases, the FIR buffers and the unused `dec.to_rgb1`), carried
to JAX by `convert_lia` and loaded natively by the port. On the CPU the
port runs the plain versions of kernels K1 and K2.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from e4s2024_tpu.convert.torch_loader import convert_lia
from e4s2024_tpu.models import lia as jlia
from e4s2024_tpu.models import stylegan2 as jsg2

from e4s2024_torch.convert import lia_state_dict_from_jax
from e4s2024_torch.models import lia
from e4s2024_torch.models.stylegan2 import ResBlock
from e4s2024_torch.ops.upfirdn import make_kernel
from tests.test_torch_criterion import jit_apply, two_threads  # noqa: F401  (autouse fixture)
from tests.test_torch_facevid2vid import np_sd, seeded_state_dict

SIZE, MOTION = 64, 4


def lia_reference_file(seed: int) -> dict:
    """The 'gen' state dict as LIA's checkpoint holds it."""
    with torch.device("meta"):
        gen = lia.LIAGenerator(size=SIZE, motion_dim=MOTION)
    sd = seeded_state_dict(gen, seed)
    for k in list(sd):  # LIA's FusedLeakyReLU keeps its bias as (1, C, 1, 1)
        if k.endswith((".activate.bias", ".conv.1.bias")) or \
                (k.endswith(".bias") and ".net_app.convs." in k and ".skip." not in k):
            sd[k] = sd[k].reshape(1, -1, 1, 1)
    fir = make_kernel([1, 3, 3, 1])
    for j in range(int(np.log2(SIZE)) - 2):
        for part in ("conv2", "skip"):
            sd[f"enc.net_app.convs.{j + 1}.{part}.0.kernel"] = fir.clone()
    for i in range(0, 2 * (int(np.log2(SIZE)) - 2), 2):
        sd[f"dec.convs.{i}.conv.blur.kernel"] = fir * 4
    for j in range(1, int(np.log2(SIZE)) - 2):
        sd[f"dec.to_rgbs.{j}.upsample.kernel"] = fir * 4
        sd[f"dec.to_flows.{j}.upsample.kernel"] = fir * 4
    sd["dec.to_rgb1.conv.0.weight"] = torch.ones(3, 512, 1, 1)
    sd["dec.to_rgb1.conv.1.bias"] = torch.zeros(1, 3, 1, 1)
    sd["dec.to_rgb1.bias"] = torch.zeros(1, 3, 1, 1)
    return {f"gen.{k}": v for k, v in sd.items()}


@pytest.fixture(scope="module")
def drivers():
    file_sd = lia_reference_file(41)
    params = jax.tree_util.tree_map(jnp.asarray, convert_lia(np_sd(file_sd), size=SIZE))
    jdrv = jlia.LIADriver.__new__(jlia.LIADriver)
    jdrv.gen, jdrv.params = jlia.LIAGenerator(size=SIZE, motion_dim=MOTION), params
    jdrv._animate = jax.jit(jdrv._animate_p)
    drv = lia.LIADriver(file_sd, SIZE, MOTION, device="cpu")
    return jdrv, drv, file_sd, params


def test_resblock_matches_jax():
    """ResBlock: K2's blur before both strided convs, K1 after the two
    activated ones; within 1e-4 of the largest output."""
    with torch.device("meta"):
        blk = ResBlock(16, 32)
    sd = seeded_state_dict(blk, 42)
    jblk = jsg2.ResBlock(32)
    params = {"conv1": {"conv": {"weight": sd["conv1.0.weight"].numpy().transpose(2, 3, 1, 0)},
                        "act_bias": sd["conv1.1.bias"].numpy()},
              "conv2": {"conv": {"weight": sd["conv2.1.weight"].numpy().transpose(2, 3, 1, 0)},
                        "act_bias": sd["conv2.2.bias"].numpy()},
              "skip": {"conv": {"weight": sd["skip.1.weight"].numpy().transpose(2, 3, 1, 0)}}}
    x = np.random.default_rng(43).standard_normal((2, 12, 10, 16)).astype(np.float32)
    want = np.asarray(jit_apply(jblk, {"params": params}, jnp.asarray(x)))
    blk = ResBlock(16, 32)
    blk.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        got = blk(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == (2, 6, 5, 32)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


def test_direction_q_matches_jax(drivers):
    """Q of the QR of weight + 1e-8 within 1e-5, signs included."""
    _, drv, _, params = drivers
    want, _ = jnp.linalg.qr(params["dec"]["direction"]["weight"] + 1e-8)
    got = drv.gen.dec.direction.basis().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got.T @ got, np.eye(MOTION), atol=1e-5)


def test_driver_matches_jax(drivers):
    """The reenacted frame within 2e-3 max (its values reach 1.8); the
    synthesis draws no noise, so two calls agree exactly."""
    jdrv, drv, _, _ = drivers
    rng = np.random.default_rng(44)
    src, tgt = (rng.uniform(-1, 1, (1, SIZE, SIZE, 3)).astype(np.float32) for _ in range(2))
    want = np.asarray(jdrv._animate(jdrv.params, jnp.asarray(src), jnp.asarray(tgt)))
    got = drv(src, tgt).numpy()
    assert got.shape == (1, SIZE, SIZE, 3)
    err = np.abs(got - want)
    assert err.max() <= 2e-3, (err.max(), np.abs(want).max())
    np.testing.assert_array_equal(drv(src, tgt).numpy(), got)


def test_state_dict_from_jax(drivers):
    _, _, file_sd, params = drivers
    back = lia_state_dict_from_jax(params)
    want = lia.lia_state_dict(file_sd)
    assert not any(k.startswith("dec.to_rgb1") or k.endswith(".kernel") for k in want)
    assert want["dec.conv1.activate.bias"].ndim == 1 and want["dec.to_rgbs.0.bias"].ndim == 4
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k].numpy(), want[k].numpy(), err_msg=k)
    bad = dict(file_sd)
    bad["gen.dec.convs.0.conv.blur.kernel"] = make_kernel([1, 3, 3, 1])  # gain 1, not 4
    with pytest.raises(ValueError, match="FIR"):
        lia.lia_state_dict(bad)
