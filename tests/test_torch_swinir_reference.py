"""The port's SwinIR (`e4s2024_torch/models/swinir.py`) and its
SwinIR-enhanced swap against the benchmark's plain reference
(`perfbench/reference/swinir.py`, the published forward in plain torch, and
`perfbench/reference/enhanced.py`), on the CPU, on weights seeded as the
benchmark seeds them (`perfbench/weights.py` with
`reference/swinir.py::seeded_draws`, e4s-swinir-1024's draws, at these
widths), at 2 RSTBs of 2 blocks, embed 36, 2 heads,
window 8, num_feat 16 on a 16x24 input.

Each of the port's routes runs its kernels' plain versions here: the fused
route (`apply_fused`, K5's plain block, which rolls by the shift itself),
and the module forward with the attention through K4's or K6's plain
version. Tolerances: both sides compute in float32 and differ in the order
of their sums (K5's one-pass LayerNorm statistics, the attention's layout)
and in the mask (the port subtracts 100 where window labels differ, the
reference adds the published -100 mask: the same logits), so one block
agrees within 1e-5 of its output's largest |value|, the whole net (4
blocks, 7 convs) within 1e-4, and the upscaler's [0, 255] output within
5e-3 levels; the enhanced swap's uint8 driven crop and image within 1
level at no more than 0.1% of pixels.
"""

import copy

import pytest
import torch

from e4s2024_torch.models.swinir import SwinIR, SwinIREnhancer, SwinIRUpscaler, apply_fused
from e4s2024_torch.ops.swin_block import fused_swin_block
from e4s2024_torch.pipelines.full_swap import FullFaceSwapPipeline, FullSwapConfig, SwapComponents
from perfbench import weights
from perfbench.pairs_driver import face_swapper
from perfbench.reference import enhanced as ref_enhanced
from perfbench.reference import swinir as ref_swinir
from perfbench.reference.swap import Swapper
from perfbench.traffic import smooth_images
from tests.torch_ranks import release_memory

EMBED, HEADS, FEAT, WINDOW = 36, 2, 16, 8
PORT_ARCH = dict(embed_dim=EMBED, depths=(2, 2), heads=(HEADS, HEADS), num_feat=FEAT)
REF_ARCH = dict(embed_dim=EMBED, depths=(2, 2), num_heads=(HEADS, HEADS), num_feat=FEAT)
SWAP = {"out_size": 16, "num_seg_cls": 12, "remaining_layer_idx": 5, "outer_dilation": 2,
        "keep_target_components": [0, 10, 4, 8, 7, 11], "regional_mode": "fast",
        "num_blend_levels": 10, "compute_dtype": "float32", "encoder_num_units": [1, 1, 1, 1]}


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)
    release_memory()


@pytest.fixture(scope="module")
def nets():
    """The reference SwinIR and the port's on one seeded state."""
    with torch.device("meta"):
        meta = ref_swinir.SwinIR(**REF_ARCH)
    state = weights.draw(weights.plan(meta, ref_swinir.seeded_draws(EMBED, FEAT)), 2 ** 31 + 17, "cpu")
    ref = ref_swinir.SwinIR(**REF_ARCH)
    ref.load_state_dict(state, strict=True)
    port = SwinIR(**PORT_ARCH)
    port.load_state_dict(state, strict=True)
    return ref.eval().requires_grad_(False), port.eval().requires_grad_(False), state


def close(out, ref, rtol):
    scale = ref.abs().max().item()
    gap = (out - ref).abs().max().item()
    assert gap <= rtol * scale, f"max |diff| {gap} against {rtol} x {scale}"


def x01(h=16, w=24, seed=3):
    return torch.rand(1, h, w, 3, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("route", ["fused", "nhwc", "windowed"])
@pytest.mark.parametrize("index", [0, 1], ids=["unshifted", "shifted"])
def test_block_matches_the_reference(nets, route, index):
    ref, port, _ = nets
    x = torch.randn(1, 16, 24, EMBED, generator=torch.Generator().manual_seed(index))
    blk = port.layers[0].residual_group.blocks[index]
    assert blk.shift == (WINDOW // 2 if index else 0)
    labels = port._labels(16, 24, x.device) if blk.shift else None
    if route == "fused":
        wts = port.fused_weights(torch.float32)[0][index]
        out = fused_swin_block(x, wts, labels, window=WINDOW, heads=HEADS, shift=blk.shift)
    else:
        out = blk(x, port._biases()[0][index], labels, use_kernel=route == "nhwc")
    close(out, ref.layers[0].residual_group.blocks[index](x), 1e-5)


@pytest.mark.parametrize("route", ["fused", "nhwc", "windowed"])
def test_swinir_matches_the_reference(nets, route):
    ref, port, _ = nets
    x = x01()
    expect = ref(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    if route == "fused":
        out = apply_fused(port, x)
    else:
        port.use_kernel = route == "nhwc"
        out = port(x)
    assert out.shape == (1, 64, 96, 3)
    close(out, expect, 1e-4)


def test_enhancer_pads_and_resizes_back_like_the_reference(nets):
    ref, _, state = nets
    crops = 255.0 * x01(18, 22, seed=4)          # padded to 24 x 24 for the window
    up = SwinIRUpscaler(copy.deepcopy(state), device="cpu", **PORT_ARCH)
    out = SwinIREnhancer(up).enhance_aligned(crops)
    expect = ref_enhanced.enhance(ref, crops)
    assert out.shape == (1, 18, 22, 3)
    assert (out - expect).abs().max().item() <= 5e-3


def test_enhanced_swap_reads_the_enhanced_crop_truncated(nets):
    """`FullFaceSwapPipeline.__call__` with the SwinIR enhancer, at the 16^2
    swap: the enhanced driven crop is the reference's, truncated to uint8
    (`reference/enhanced.py`), and the staged path's swap reads that crop
    and its image is the call's. The reference's swap is held against the
    port's, and the whole enhanced swap against `EnhancedSwapper`, in
    perfbench/tests, where time allows the reference's 512^2 parse too."""
    ref, _, sr_state = nets
    state = weights.seeded_state(Swapper(SWAP, "meta").nets(), 2 ** 31 + 19, "cpu")
    swapper = face_swapper(SWAP, state, "cpu")
    swaps = []

    def recorded(driven, target):
        out = type(swapper).swap_aligned(swapper, driven, target)
        swaps.append((driven, out["image"]))
        return out

    swapper.swap_aligned = recorded
    up = SwinIRUpscaler(copy.deepcopy(sr_state), device="cpu", **PORT_ARCH)
    pipe = FullFaceSwapPipeline(
        swapper, SwapComponents(enhancers={"swinir": SwinIREnhancer(up).enhance_aligned}),
        FullSwapConfig(enhancement_mode="swinir", ct_mode="none", face_inpainting=False))
    src, tgt = smooth_images(2, 16, 5, "cpu", block=4)
    out = pipe(src.numpy(), tgt.numpy(), return_intermediates=True)
    expect = torch.clamp(ref_enhanced.enhance(ref, src[None]), 0, 255).to(torch.uint8)[0]
    diff = (out["driven"].int() - expect.int()).abs()
    assert diff.max() <= 1 and (diff > 0).float().mean() <= 1e-3
    (driven, image), = swaps
    assert driven.dtype == torch.float32
    assert torch.equal(torch.clamp(driven[0], 0, 255).to(torch.uint8), out["driven"])
    assert torch.equal(image[0], out["image"])
