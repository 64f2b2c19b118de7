"""The port's Hopenet and PoseEstimator (e4s2024_torch.models.hopenet)
against the JAX package's, on the CPU.

Hopenet runs its published ResNet-50 widths with one Bottleneck per layer
(layers (1, 1, 1, 1)), on 128^2 and 224^2 crops. Weights are a
reference-style state dict seeded with numpy (`fc_finetune` included, as
the reference file holds it), carried to JAX by `convert_hopenet` and loaded
natively by the port.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from e4s2024_tpu.convert.torch_loader import convert_hopenet
from e4s2024_tpu.models.hopenet import Hopenet as JHopenet
from e4s2024_tpu.models.hopenet import PoseEstimator as JPoseEstimator

from e4s2024_torch.convert import hopenet_state_dict_from_jax
from e4s2024_torch.models.hopenet import Hopenet, PoseEstimator, hopenet_state_dict
from tests.test_torch_criterion import two_threads  # noqa: F401  (autouse fixture)
from tests.test_torch_facevid2vid import np_sd, seeded_state_dict

LAYERS = (1, 1, 1, 1)


def hopenet_reference_state_dict(seed: int) -> dict:
    """A Hopenet file at LAYERS: the seeded net, its logits sharpened (x 8
    on the heads) so that the angles spread over tens of degrees, plus the
    reference's unused `fc_finetune`."""
    with torch.device("meta"):
        net = Hopenet(layers=LAYERS)
    sd = seeded_state_dict(net, seed)
    for head in ("fc_yaw", "fc_pitch", "fc_roll"):
        sd[f"{head}.weight"] = sd[f"{head}.weight"] * 8
    g = torch.Generator().manual_seed(seed)
    sd["fc_finetune.weight"] = torch.randn(3, 2051, generator=g)
    sd["fc_finetune.bias"] = torch.randn(3, generator=g)
    return sd


def jax_estimator(sd) -> JPoseEstimator:
    est = JPoseEstimator(jax.tree_util.tree_map(jnp.asarray, convert_hopenet(np_sd(sd), LAYERS)))
    est.model = JHopenet(layers=LAYERS)  # traced at the first call
    return est


@pytest.fixture(scope="module")
def estimators():
    sd = hopenet_reference_state_dict(21)
    return jax_estimator(sd), PoseEstimator(sd, layers=LAYERS, device="cpu"), sd


def _crops(seed, n, size):
    rng = np.random.default_rng(seed)
    coarse = rng.random((n, 8, 8, 3))
    img = np.kron(coarse, np.ones((1, size // 8, size // 8, 1))) * 200 + \
        rng.random((n, size, size, 3)) * 55
    return img.astype(np.uint8)


@pytest.mark.parametrize("size", [128, 224])
def test_angles_match_jax(estimators, size):
    """Yaw, pitch and roll within 1e-3 degrees (128^2 crops go through the
    bilinear resize to 224^2, 224^2 crops do not)."""
    jest, est, _ = estimators
    img = _crops(22 + size, 2, size)
    want = jest.estimate(jnp.asarray(img))
    got = est.estimate(img)
    for name, w, g in zip(("yaw", "pitch", "roll"), want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3, err_msg=name)
    assert float(np.ptp(np.stack([g.numpy() for g in got]))) > 5.0  # the angles spread


def test_pose_gap_matches_jax_per_pair(estimators):
    """`pose_gap` within 1e-3 of JAX's for one pair; `pose_gaps` gives each
    pair of a batch its own gap (the largest of its three angles), JAX's
    gap of that pair alone. The gates at thresholds 1 degree either side of
    each gap decide alike."""
    jest, est, _ = estimators
    a, b = _crops(30, 3, 128), _crops(31, 3, 128)
    gaps = est.pose_gaps(a, b).numpy()
    for i in range(3):
        want = jest.pose_gap(jnp.asarray(a[i:i + 1]), jnp.asarray(b[i:i + 1]))
        assert abs(gaps[i] - want) <= 1e-3, (i, gaps[i], want)
        assert abs(est.pose_gap(a[i:i + 1], b[i:i + 1]) - want) <= 1e-3
        for threshold in (want - 1.0, want + 1.0):
            assert (gaps[i] < threshold) == (want < threshold)
    assert len(set(np.round(gaps, 3))) == 3
    assert est.pose_gap(a, b) == pytest.approx(float(gaps.max()))


def test_state_dict_from_jax_and_dropped_head(estimators):
    """JAX params -> `hopenet_state_dict_from_jax` -> the reference file
    without `fc_finetune`; a DDP `module.` prefix loads too."""
    _, _, sd = estimators
    back = hopenet_state_dict_from_jax(convert_hopenet(np_sd(sd), LAYERS))
    want = hopenet_state_dict(sd)
    assert "fc_finetune.weight" in sd and not any(k.startswith("fc_finetune") for k in want)
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k].numpy(), want[k].numpy(), err_msg=k)
    wrapped = {f"module.{k}": v for k, v in sd.items()}
    Hopenet(layers=LAYERS).load_state_dict(hopenet_state_dict(wrapped), strict=True)
