"""The port's FullFaceSwapPipeline beyond its default call, on the CPU:
`swap_batch` at B=2 against two single calls, the classical ct_modes'
recolor stage and the Blender stage with the RealESRGAN upscaler and the
edge-aware blend against JAX's, the inpaint composite, and what the
constructor refuses and which semantics each configuration takes.

Components as in tests/test_torch_default_swap.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from e4s2024_tpu.convert.torch_loader import convert_rrdbnet
from e4s2024_tpu.models.rrdb import RealESRGANUpscaler as JRealESRGANUpscaler
from e4s2024_tpu.models.rrdb import RRDBNet as JRRDBNet
from e4s2024_tpu.pipelines.full_swap import FullFaceSwapPipeline as JFullFaceSwapPipeline
from e4s2024_tpu.pipelines.full_swap import FullSwapConfig as JFullSwapConfig
from e4s2024_tpu.pipelines.full_swap import SwapComponents as JSwapComponents

from e4s2024_torch.models.bisenet import BiSeNet
from e4s2024_torch.models.gcfsr import FaceInpainter
from e4s2024_torch.models.gpen import GPENEnhancer
from e4s2024_torch.models.rgi import RGINet
from e4s2024_torch.models.rrdb import RealESRGANUpscaler, RRDBNet
from e4s2024_torch.pipelines.full_swap import FullFaceSwapPipeline, FullSwapConfig, SwapComponents
from e4s2024_torch.pipelines.swap import FaceSwapper, SwapConfig
from tests.test_torch_aux_nets import gcfsr_reference_state_dict
from tests.test_torch_criterion import two_threads  # noqa: F401  (autouse fixture)
from tests.test_torch_full_swap import LEVELS, REMAINING, SIZE, UNITS, _assert_close_images, _pairs
from tests.test_torch_gpen import RRDB, gpen_reference_state_dict, np_sd, reference_state_dict

@pytest.fixture(scope="module")
def swap():
    """The small swapper (fast mode), weights from torch's seeded default
    initialisation: these tests hold the port against itself or hold stages
    that do not read the swapper."""
    torch.manual_seed(63)
    kw = dict(out_size=SIZE, remaining_layer_idx=REMAINING, num_blend_levels=LEVELS,
              regional_mode="fast")
    return FaceSwapper(RGINet(out_size=SIZE, remaining_layer_idx=REMAINING,
                              encoder_num_units=UNITS).state_dict(), BiSeNet().state_dict(),
                       SwapConfig(**kw), device="cpu", encoder_num_units=UNITS)


def test_swap_batch_matches_single_calls(swap):
    """B=2 through the enhancer, the swap and the inpainter at once against
    chunks of one pair, which run each pair as a single call does (the
    Blender recolor's batch is held in tests/test_torch_aux_nets.py, where
    it is cheap)."""
    comps = SwapComponents(
        enhancers={"gpen": GPENEnhancer(gpen_reference_state_dict(64), 64, narrow=0.25,
                                        device="cpu").enhance_aligned},
        inpainter=FaceInpainter(gcfsr_reference_state_dict(65)[1], 64, narrow=0.25,
                                device="cpu"))
    pipe = FullFaceSwapPipeline(swap, comps, FullSwapConfig(ct_mode="none",
                                                            face_inpainting=True))
    src, tgt = _pairs(43, 2)
    batch = pipe.swap_batch(src, tgt).numpy()
    assert batch.shape == (2, SIZE, SIZE, 3) and batch.dtype == np.uint8
    pipe.cfg.max_fused_batch = 1
    singles = pipe.swap_batch(src, tgt).numpy()
    # the same operations with a batch axis: float32 convolutions may sum in
    # another order at B=2, which can flip a near-tied parse pixel
    _assert_close_images(batch, singles, 2, 0.01)
    assert not np.array_equal(batch[0], batch[1])


@pytest.mark.parametrize("mode", ["lct", "rct", "mkl", "sot", "hist"])
def test_classical_recolor_stage_matches_jax(mode):
    """The classical ct_modes' stage: the swap in float32 and the uint8
    target as JAX's staged `_recolor` reads them (device modes in torch on
    the swap's device, the host modes in numpy), * 255 in float32. sot draws
    its directions from a generator seeded 0 on each side, so only its
    shape and range are held here (its transfer on given directions:
    tests/test_torch_color.py)."""
    rng = np.random.default_rng(66)
    swapped = (rng.random((1, 48, 40, 3)) * 255).astype(np.float32)
    target = (rng.random((1, 48, 40, 3)) * 200 + 30).astype(np.uint8)
    got = FullFaceSwapPipeline(None, None, FullSwapConfig(ct_mode=mode))._recolor(
        torch.from_numpy(swapped), torch.from_numpy(target)).numpy()[0]
    assert got.shape == swapped.shape[1:] and got.dtype == np.float32
    if mode == "sot":
        assert 0 <= got.min() and got.max() <= 255 and np.abs(got - swapped[0]).mean() > 1
        return
    want = np.asarray(JFullFaceSwapPipeline(None, JSwapComponents(), JFullSwapConfig(
        ct_mode=mode))._recolor(jnp.asarray(swapped[0]), jnp.asarray(target[0]), None, None))
    # ops/color.py's float32 agreement (tests/test_torch_color.py), in levels
    np.testing.assert_allclose(got, want, atol=5e-3)


class _StubRecolor:
    """A fixed 16^2 "recolor" of the swap, so that the x4 upscale fits a
    64^2 crop."""

    def __init__(self, as_tensor):
        self.as_tensor = as_tensor

    def recolor(self, a, t, ma, mt):
        rec = np.asarray(a, np.float32)[:, ::4, ::4][..., ::-1] * 0.9 + 10.0
        return torch.from_numpy(rec.copy()) if self.as_tensor else jnp.asarray(rec)


def test_recolor_stage_with_upscaler_matches_jax():
    ref = reference_state_dict(RRDBNet(**RRDB), 45)
    jup = JRealESRGANUpscaler(convert_rrdbnet(np_sd(ref)), JRRDBNet(**RRDB))
    up = RealESRGANUpscaler(ref, **RRDB, device="cpu")
    jpipe = JFullFaceSwapPipeline(None, JSwapComponents(recolorer=_StubRecolor(False),
                                                        upscaler=jup))
    pipe = FullFaceSwapPipeline(None, SwapComponents(recolorer=_StubRecolor(True), upscaler=up))
    rng = np.random.default_rng(46)
    swapped = (rng.random((1, 64, 64, 3)) * 255).astype(np.float32)
    target = (rng.random((1, 64, 64, 3)) * 255).astype(np.uint8)
    labels = np.zeros((512, 512), np.int32)  # read by the recolorer alone
    want = np.asarray(jpipe._recolor(jnp.asarray(swapped[0]), jnp.asarray(target[0]), labels,
                                     labels))
    got = pipe._recolor(torch.from_numpy(swapped), torch.from_numpy(target),
                        torch.from_numpy(labels)[None], torch.from_numpy(labels)[None]).numpy()[0]
    # RRDB's 1e-5 relative and the Sobel edges' float32 sums, in levels
    np.testing.assert_allclose(got, want, atol=5e-3)
    assert np.abs(got - swapped[0]).mean() > 1.0


def test_inpaint_composite_matches_jax_and_keeps_the_outside():
    jpipe = JFullFaceSwapPipeline(None)
    pipe = FullFaceSwapPipeline(None)
    rng = np.random.default_rng(47)
    img = (rng.random((2, 96, 96, 3)) * 255).astype(np.float32)
    out = (rng.random((2, 96, 96, 3)) * 255).astype(np.float32)
    hole = np.zeros((2, 48, 48), bool)
    hole[0, 10:30, 12:26] = True
    hole[1, 30:34, 5:40] = True
    want = np.asarray(jpipe._inpaint_composite(jnp.asarray(img), jnp.asarray(out),
                                               jnp.asarray(hole)))
    got = pipe._inpaint_composite(torch.from_numpy(img), torch.from_numpy(out),
                                  torch.from_numpy(hole)).numpy()
    # the dense cone convolution against its separable terms
    np.testing.assert_allclose(got, want, atol=2e-3)
    soft = pipe._inpaint_soft_mask(torch.from_numpy(hole), 96)[:, 0].numpy()
    outside = soft == 0
    assert outside.mean() > 0.5
    np.testing.assert_array_equal(got[outside], img[outside])


def test_what_the_constructor_refuses(swap):
    # a pose driver is taken, and keeps JAX's staged semantics, as its gate
    # runs on the host (the reenacted swap: tests/test_torch_reenact_swap.py)
    assert not FullFaceSwapPipeline(swap, SwapComponents(pose_driver=object()))._fused()
    with pytest.raises(ValueError, match="ct_mode"):
        FullFaceSwapPipeline(swap, None, FullSwapConfig(ct_mode="nope"))
    # a component without a fused form (any plain callable) keeps the
    # staged semantics: the enhanced crop is truncated before the swap
    staged = FullFaceSwapPipeline(swap, SwapComponents(enhancers={"gpen": lambda x: x}))
    assert not staged._fused()
    assert FullFaceSwapPipeline(swap)._fused()
    assert not FullFaceSwapPipeline(swap, None, FullSwapConfig(optimize_w_steps=5))._fused()
