"""The port's faceVid2Vid (e4s2024_torch.models.facevid2vid) against the JAX
package's, on the CPU: the samplers, the keypoint transforms, the three nets
and FaceVid2VidDriver's `drive` and `set_pose`.

The nets run at the tiny widths of tests/test_facevid2vid.py (256^2
geometry: a (4, 64, 64) feature volume, 15 keypoints). Weights are
reference-style state dicts seeded with numpy (`seeded_state_dict`, the
SPADE convolutions stored as spectral norm stores them, the keypoint
detector's anti-alias buffer included), carried to JAX by the JAX
package's converter and loaded natively by the port.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from e4s2024_tpu.convert.torch_loader import convert_facevid2vid
from e4s2024_tpu.models import facevid2vid as jfv

from e4s2024_torch.convert import facevid2vid_state_dicts_from_jax
from e4s2024_torch.models import facevid2vid as fv
from e4s2024_torch.models.arcface import FrozenBatchNorm
from e4s2024_torch.models.stylegan2 import EqualConv2d, EqualLinear, ModulatedConv2d
from tests.test_torch_criterion import two_threads  # noqa: F401  (autouse fixture)

KP = dict(block_expansion=4, max_features=32, reshape_features=64, reshape_depth=4)
HE = dict(block_expansion=8, width=16)
GEN = dict(block_expansion=8, max_features=32, reshape_channel=8, reshape_depth=4,
           num_resblocks=1, dm_block_expansion=4, dm_max_features=32, decoder_ic=8)


def seeded_state_dict(model: torch.nn.Module, seed: int, spectral: bool = False) -> dict:
    """A state dict in the reference's names for `model` (a port module),
    seeded with numpy as a trained file would hold it: plain convolutions
    (2-D and 3-D) and linear layers LeCun normal, equalised-LR weights
    standard normal, modulation biases near 1, BatchNorm statistics away
    from the identity, norm scales near 1, other biases small. With
    `spectral`, every `conv_0`, `conv_1` and `conv_s` is stored as the
    reference's spectral norm stores it (`weight_orig`, `weight_u`,
    `weight_v`). Fixed buffers (anti-alias kernels) are written as the
    reference holds them."""
    rng = np.random.default_rng(seed)
    out = {}

    def f32(v):
        return torch.tensor(np.asarray(v), dtype=torch.float32)

    for mname, m in model.named_modules():
        p = f"{mname}." if mname else ""
        if isinstance(m, fv.AntiAliasDownsample):
            out[f"{p}weight"] = m.kernel.clone()
        for name, t in m.named_parameters(recurse=False):
            shape, n = tuple(t.shape), rng.standard_normal(tuple(t.shape))
            if isinstance(m, (FrozenBatchNorm, torch.nn.InstanceNorm2d)):
                v = {"weight": 1 + 0.1 * n, "bias": 0.1 * n}[name]
            elif name == "weight" and isinstance(m, (EqualConv2d, ModulatedConv2d,
                                                     EqualLinear)):
                v = n
            elif name == "bias" and mname.endswith("modulation"):
                v = 1 + 0.1 * n
            elif name == "weight" and isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d,
                                                     torch.nn.Linear)):
                v = n / np.sqrt(np.prod(shape[1:]))
                if spectral and mname.rsplit(".", 1)[-1] in ("conv_0", "conv_1", "conv_s"):
                    w2 = v.reshape(shape[0], -1)
                    u = rng.standard_normal(shape[0])
                    for _ in range(5):  # power iteration, as training leaves u, v
                        vv = w2.T @ u
                        vv /= np.linalg.norm(vv)
                        u = w2 @ vv
                        u /= np.linalg.norm(u)
                    # a trained file's sigma is about 1: keep the activations' scale
                    sigma = float(u @ (w2 @ vv))
                    out[f"{p}weight_orig"] = f32(v * sigma)
                    out[f"{p}weight_u"], out[f"{p}weight_v"] = f32(u), f32(vv)
                    continue
            elif name == "input" or name == "weight":
                v = n
            else:  # biases, gamma
                v = 0.1 * n
            out[f"{p}{name}"] = f32(v)
        for name, t in m.named_buffers(recurse=False):
            if isinstance(m, FrozenBatchNorm):
                n = rng.standard_normal(tuple(t.shape))
                out[f"{p}{name}"] = f32(0.1 * n if name == "running_mean"
                                        else rng.uniform(0.5, 1.5, tuple(t.shape)))
    return out


def np_sd(sd) -> dict:
    return {k: v.numpy() for k, v in sd.items()}


@pytest.fixture(scope="module")
def nets():
    """Reference-style files for the three tiny nets, and JAX's params."""
    with torch.device("meta"):
        kp, he, gen = fv.KPDetector(**KP), fv.HEEstimator(**HE), \
            fv.OcclusionAwareSPADEGenerator(**GEN)
    ckpt = {"kp_detector": seeded_state_dict(kp, 1), "he_estimator": seeded_state_dict(he, 2),
            "generator": seeded_state_dict(gen, 3, spectral=True)}
    params = convert_facevid2vid({k: np_sd(v) for k, v in ckpt.items()})
    return ckpt, params


@pytest.fixture(scope="module")
def drivers(nets):
    ckpt, params = nets
    jkp, jhe = jfv.KPDetector(**KP), jfv.HEEstimator(**HE)
    jgen = jfv.OcclusionAwareSPADEGenerator(**GEN)
    jdrv = jfv.FaceVid2VidDriver(jax.tree_util.tree_map(jnp.asarray, params), kp=jkp, he=jhe,
                                 gen=jgen, frames_per_batch=1)
    drv = fv.FaceVid2VidDriver(ckpt, kp=KP, he=HE, gen=GEN, frames_per_batch=1, device="cpu")
    return jdrv, drv


def _frames(seed, n):
    rng = np.random.default_rng(seed)
    coarse = rng.random((n, 8, 8, 3))
    img = np.kron(coarse, np.ones((1, 32, 32, 1))) * 0.8 + rng.random((n, 256, 256, 3)) * 0.2
    return img.astype(np.float32)


def test_grid_sample_3d_and_gaussians_match_jax():
    rng = np.random.default_rng(0)
    vol = rng.standard_normal((2, 4, 6, 5, 3)).astype(np.float32)
    grid = (rng.random((2, 3, 7, 5, 3)).astype(np.float32) * 2.4 - 1.2)  # reaches outside
    want = np.asarray(jfv.grid_sample_3d(jnp.asarray(vol), jnp.asarray(grid)))
    got = fv.grid_sample_3d(torch.from_numpy(vol).permute(0, 4, 1, 2, 3),
                            torch.from_numpy(grid)).permute(0, 2, 3, 4, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    kp = rng.uniform(-1, 1, (2, 5, 3)).astype(np.float32)
    want = np.asarray(jfv.kp2gaussian3d(jnp.asarray(kp), (4, 9, 7)))
    got = fv.kp2gaussian3d(torch.from_numpy(kp), (4, 9, 7)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_array_equal(fv.make_grid_3d(4, 9, 7).numpy(),
                                  np.asarray(jfv.make_grid_3d(4, 9, 7)))


@pytest.mark.parametrize("overrides", [{}, {"yaw": 0.0, "pitch": 0.0, "roll": 0.0},
                                       {"yaw": 30.0}, {"pitch": [10.0, -25.0]}])
def test_keypoint_transformation_matches_jax(overrides):
    """With and without the free-view overrides (a scalar, or one angle per
    sample); rotation_matrix converts degrees with 3.14 on both sides."""
    rng = np.random.default_rng(1)
    kp = rng.standard_normal((2, 15, 3)).astype(np.float32)
    he = {k: rng.standard_normal(s).astype(np.float32) * 2 for k, s in
          (("yaw", (2, 66)), ("pitch", (2, 66)), ("roll", (2, 66)), ("t", (2, 3)),
           ("exp", (2, 45)))}
    want = np.asarray(jfv.keypoint_transformation(
        {"value": jnp.asarray(kp)}, {k: jnp.asarray(v) for k, v in he.items()},
        **overrides)["value"])
    got = fv.keypoint_transformation(
        {"value": torch.from_numpy(kp)}, {k: torch.from_numpy(v) for k, v in he.items()},
        **overrides)["value"].numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_nets_match_jax(nets, drivers):
    """Keypoints and head pose of the tiny nets within 1e-4, and the
    generator's prediction within 2e-3 max / 1e-4 mean on [0, 1]."""
    ckpt, params = nets
    _, drv = drivers
    src = _frames(4, 1)
    x = torch.from_numpy(src).permute(0, 3, 1, 2)
    jkp, jhe = jfv.KPDetector(**KP), jfv.HEEstimator(**HE)
    want_kp = jax.jit(jkp.apply)({"params": params["kp_detector"]}, src)["value"]
    want_he = jax.jit(jhe.apply)({"params": params["he_estimator"]}, src)
    with torch.inference_mode():
        got_kp = drv.kp(x)["value"].numpy()
        got_he = drv.he(x)
    np.testing.assert_allclose(got_kp, np.asarray(want_kp), atol=1e-4)
    for key in ("yaw", "pitch", "roll", "t", "exp"):
        np.testing.assert_allclose(got_he[key].numpy(), np.asarray(want_he[key]), atol=1e-4,
                                   err_msg=key)
    # the crossed heads: "yaw" is fc_roll's output and "roll" fc_yaw's
    seen = {}
    hooks = [getattr(drv.he, n).register_forward_hook(
        lambda m, i, o, n=n: seen.__setitem__(n, o)) for n in ("fc_roll", "fc_yaw")]
    with torch.inference_mode():
        drv.he(x)
    for h in hooks:
        h.remove()
    np.testing.assert_array_equal(seen["fc_roll"].numpy(), got_he["yaw"].numpy())
    np.testing.assert_array_equal(seen["fc_yaw"].numpy(), got_he["roll"].numpy())


def test_drive_matches_jax(drivers):
    """Two target frames in chunks of one (one compile of JAX's generator
    program); the port's driver at two frames a chunk too."""
    jdrv, drv = drivers
    src, tgt = _frames(5, 1), _frames(6, 2)
    want = np.asarray(jdrv.drive(jnp.asarray(src), jnp.asarray(tgt)))
    got = drv.drive(src, tgt).numpy()
    assert got.shape == (2, 256, 256, 3)
    drv.frames_per_batch = 2
    np.testing.assert_allclose(drv.drive(src, tgt).numpy(), got, atol=1e-5)
    drv.frames_per_batch = 1
    assert 0 <= got.min() and got.max() <= 1
    err = np.abs(got - want)
    assert err.max() <= 2e-3 and err.mean() <= 1e-4, (err.max(), err.mean())
    assert np.abs(got[0] - got[1]).mean() > 1e-4  # the frames drive differently


def test_set_pose_matches_jax(drivers):
    jdrv, drv = drivers
    src = _frames(7, 1)
    want = np.asarray(jdrv.set_pose(jnp.asarray(src), yaw=25.0, pitch=-10.0, roll=5.0))
    got = drv.set_pose(src, yaw=25.0, pitch=-10.0, roll=5.0).numpy()
    err = np.abs(got - want)
    assert got.shape == (1, 256, 256, 3)
    assert err.max() <= 2e-3 and err.mean() <= 1e-4, (err.max(), err.mean())


def test_state_dicts_from_jax_and_buffers(nets):
    """JAX params -> `facevid2vid_state_dicts_from_jax` -> the reference file
    with its spectral norms folded and its anti-alias buffer dropped; a
    buffer that differs from the port's constant is refused."""
    ckpt, params = nets
    back = facevid2vid_state_dicts_from_jax(params)
    want = fv.facevid2vid_state_dicts(ckpt)
    for net in want:
        assert set(back[net]) == set(want[net]), net
        for k in want[net]:
            np.testing.assert_allclose(back[net][k].numpy(), want[net][k].numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    assert "down.weight" in ckpt["kp_detector"] and "down.weight" not in want["kp_detector"]
    flat = {f"{net}.{k}": v for net, sd in ckpt.items() for k, v in sd.items()}
    assert set(fv.facevid2vid_state_dicts(flat)["kp_detector"]) == set(want["kp_detector"])
    bad = dict(ckpt, kp_detector=dict(ckpt["kp_detector"]))
    bad["kp_detector"]["down.weight"] = bad["kp_detector"]["down.weight"] * 1.01
    with pytest.raises(ValueError, match="anti-alias"):
        fv.facevid2vid_state_dicts(bad)
