"""The port's reenacted swap (FullFaceSwapPipeline with a faceVid2Vid pose
driver and a Hopenet pose estimator) against the JAX package's, on the CPU:
one call that the gate drives, and `swap_batch` against JAX's per-pair
loop, one pair driven and one not.

`build_pipelines` puts the tiny faceVid2Vid of
tests/test_torch_facevid2vid.py (with 4 keypoints) and the
one-block-per-layer Hopenet of tests/test_torch_hopenet.py over the 128^2
swapper of tests/test_torch_default_swap.py in fast regional mode, with
those of the default configuration's components (GPEN at 64^2, GCFSR at
64^2) that a file asks for; the files stay small: none here, GPEN and
GCFSR with face_inpainting in tests/test_torch_reenact_gate.py (the gate's
other side); the Blender stage of the staged call is held in
tests/test_torch_reenact_recolor.py. A pose driver makes JAX's call staged
(its gate runs on the host), so JAX's `__call__` and its per-pair
`swap_batch` loop are the references; the port runs the plain versions of
its kernels.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from e4s2024_tpu.convert.torch_loader import (
    convert_facevid2vid, convert_gcfsr, convert_gpen)
from e4s2024_tpu.models import facevid2vid as jfv
from e4s2024_tpu.models.gcfsr import FaceInpainter as JFaceInpainter
from e4s2024_tpu.models.gcfsr import FaceInpainting as JFaceInpainting
from e4s2024_tpu.models.gpen import GPENEnhancer as JGPENEnhancer
from e4s2024_tpu.models.gpen import GPENFullGenerator as JGPENFullGenerator
from e4s2024_tpu.pipelines.full_swap import FullFaceSwapPipeline as JFullFaceSwapPipeline
from e4s2024_tpu.pipelines.full_swap import FullSwapConfig as JFullSwapConfig
from e4s2024_tpu.pipelines.full_swap import SwapComponents as JSwapComponents

from e4s2024_torch.models import facevid2vid as fv
from e4s2024_torch.models.gcfsr import FaceInpainter
from e4s2024_torch.models.gpen import GPENEnhancer
from e4s2024_torch.models.hopenet import PoseEstimator
from e4s2024_torch.pipelines.full_swap import FullFaceSwapPipeline, FullSwapConfig, SwapComponents
from tests.test_torch_aux_nets import GCFSR, gcfsr_reference_state_dict
from tests.test_torch_criterion import two_threads  # noqa: F401  (autouse fixture)
from tests.test_torch_default_swap import small_swappers
from tests.test_torch_facevid2vid import GEN, HE, KP, np_sd, seeded_state_dict
from tests.test_torch_full_swap import SIZE, _assert_close_images
from tests.test_torch_gpen import GPEN, gpen_reference_state_dict
from tests.test_torch_hopenet import LAYERS, hopenet_reference_state_dict, jax_estimator

# the tiny faceVid2Vid of tests/test_torch_facevid2vid.py with 4 keypoints:
# the dense motion's 3-D hourglass and 7x7x7 mask conv shrink with them
PKP, PHE, PGEN = dict(KP, num_kp=4), dict(HE, num_kp=4), dict(GEN, num_kp=4)


def build_pipelines(parts=()):
    """JAX's pipeline and the port's on the same seeded weights: the small
    swapper, the tiny faceVid2Vid and Hopenet, and those of the default
    configuration's components that `parts` names: "gpen" (the enhancer),
    "gcfsr" (the inpainter, face_inpainting on); ct_mode "none" (the
    recolor: tests/test_torch_reenact_recolor.py)."""
    jswap, swap = small_swappers()
    with torch.device("meta"):
        nets = fv.KPDetector(**PKP), fv.HEEstimator(**PHE), \
            fv.OcclusionAwareSPADEGenerator(**PGEN)
    ckpt = {name: seeded_state_dict(net, 50 + i, spectral=name == "generator")
            for i, (name, net) in enumerate(zip(("kp_detector", "he_estimator", "generator"),
                                                nets))}
    jdrv = jfv.FaceVid2VidDriver(
        jax.tree_util.tree_map(jnp.asarray, convert_facevid2vid(
            {k: np_sd(v) for k, v in ckpt.items()})),
        kp=jfv.KPDetector(**PKP), he=jfv.HEEstimator(**PHE),
        gen=jfv.OcclusionAwareSPADEGenerator(**PGEN))
    hope = hopenet_reference_state_dict(53)
    jcomp = JSwapComponents(pose_driver=jdrv, pose_estimator=jax_estimator(hope))
    comp = SwapComponents(
        pose_driver=fv.FaceVid2VidDriver(ckpt, kp=PKP, he=PHE, gen=PGEN, device="cpu"),
        pose_estimator=PoseEstimator(hope, layers=LAYERS, device="cpu"))
    cfg = dict(face_inpainting="gcfsr" in parts, ct_mode="none")
    # the files of tests/test_torch_default_swap.py's `zoo_state_dicts`
    if "gpen" in parts:
        sd = gpen_reference_state_dict(40)
        jcomp.enhancers = {"gpen": JGPENEnhancer(convert_gpen(np_sd(sd)), 64,
                                                 JGPENFullGenerator(**GPEN)).enhance_aligned}
        comp.enhancers = {"gpen": GPENEnhancer(sd, 64, narrow=0.25,
                                               device="cpu").enhance_aligned}
    if "gcfsr" in parts:
        sd = gcfsr_reference_state_dict(43)[1]
        jcomp.inpainter = JFaceInpainter(convert_gcfsr(np_sd(sd)), JFaceInpainting(**GCFSR))
        comp.inpainter = FaceInpainter(sd, 64, narrow=0.25, device="cpu")
    return (JFullFaceSwapPipeline(jswap, jcomp, JFullSwapConfig(**cfg)),
            FullFaceSwapPipeline(swap, comp, FullSwapConfig(**cfg)))


@pytest.fixture(scope="module")
def pipelines():
    return build_pipelines()


def pairs(seed, b):
    """Smooth crops (the enhancer's float output is then not noise), the
    targets mirrored so that the pose estimates differ."""
    rng = np.random.default_rng(seed)
    coarse = rng.random((2, b, 8, 8, 3))
    img = np.kron(coarse, np.ones((1, 1, SIZE // 8, SIZE // 8, 1))) * 200
    img += rng.random(img.shape) * 55
    img = img.astype(np.uint8)
    return img[0], np.ascontiguousarray(img[1][:, :, ::-1])


def set_threshold(jpipe, pipe, threshold):
    jpipe.cfg.pose_gap_threshold = pipe.cfg.pose_gap_threshold = threshold


def assert_close_swaps(got, want):
    """uint8 swaps within 0.02 levels mean, and at most 1e-3 of the values
    more than 2 levels apart (the default swap's tolerance allows none).
    Measured reason, on `test_swap_batch_gates_each_pair`'s driven pair: the
    two drives differ by at most 2.3e-3 levels (float32), which truncates to
    a one-level difference in 0.035% of the driven crop's values; that flips
    BiSeNet's argmax at a near-tie on 2 of the 512^2 mask pixels, and there
    the swap differs by up to 10 levels on 5 values."""
    assert got.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.mean() <= 0.02, diff.mean()
    assert (diff > 2).mean() <= 1e-3, ((diff > 2).mean(), diff.max())


def check_single_call(jpipe, pipe, side):
    """One call on one side of the gate, at a threshold 5 degrees from the
    gap. JAX's driven crop is its float drive, resized back; with GPEN both
    enhance it, and the staged swap truncates the enhanced crop to uint8."""
    src, tgt = pairs(54, 1)
    gap = pipe.comp.pose_estimator.pose_gap(src, tgt)
    set_threshold(jpipe, pipe, gap - 5.0 if side == "driven" else gap + 5.0)
    want = jpipe(src[0], tgt[0], return_intermediates=True)
    got = pipe(src[0], tgt[0], return_intermediates=True, verbose=True)
    assert not pipe._fused() and jpipe._fused_call is None
    assert pipe.last_gate["driven"] == [side == "driven"]
    assert abs(pipe.last_gate["gaps"][0] - jpipe.comp.pose_estimator.pose_gap(
        jnp.asarray(src), jnp.asarray(tgt))) <= 1e-3
    stages = set(got["stage_times"])
    assert {"pose_align", "pose_gate"} <= stages
    assert ("pose_drive" in stages) == (side == "driven")
    # the driven crops: the drives' float32 differences, x 255, resized,
    # enhanced by GPEN and truncated: a level apart where the two straddle
    # an integer
    _assert_close_images(got["driven"].numpy(), np.asarray(want["driven"]), 1, 0.01)
    # where a driven value differs by one level, BiSeNet's argmax may flip at
    # a near-tie: the masks agree on all but a 1e-4 fraction of pixels
    for key in ("swapped_mask", "hole_mask"):
        assert np.mean(got[key].numpy() != np.asarray(want[key])) <= 1e-4, key
    # the enhanced, swapped, recolored and inpainted image
    assert_close_swaps(got["image"].numpy(), np.asarray(want["image"]))
    enhance = pipe.comp.enhancers.get("gpen", lambda x: x)
    kept = enhance(torch.from_numpy(src).float()).numpy()
    moved = np.abs(got["driven"].numpy().astype(float) - kept).mean()
    assert (moved > 1.0) == (side == "driven"), moved


def test_reenacted_swap_matches_jax(pipelines):
    """The pair driven: the float drive, resized back, enters the staged
    swap, which truncates it."""
    check_single_call(*pipelines, "driven")


def test_swap_batch_gates_each_pair(pipelines):
    """`swap_batch` against JAX's per-pair loop: two pairs whose gaps differ
    (17.1 and 7.2 degrees) and a threshold between them, more than 0.1
    degree from each; one pair is driven and one keeps its crop, as the
    loop decides."""
    jpipe, pipe = pipelines
    src, tgt = pairs(61, 2)
    gaps = pipe.comp.pose_estimator.pose_gaps(src, tgt).numpy()
    threshold = float(gaps.mean())
    assert np.abs(gaps - threshold).min() > 0.1, gaps
    set_threshold(jpipe, pipe, threshold)
    want = np.asarray(jpipe.swap_batch(src, tgt))
    got = pipe.swap_batch(src, tgt).numpy()
    assert pipe.last_gate["driven"] == [True, False]
    assert_close_swaps(got, want)
