#!/usr/bin/env python3
"""Drive the PyTorch port (e4s2024_torch) on one NVIDIA card.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero:

1. build: compile the six CUDA kernels from e4s2024_torch/kernels/csrc/
   for sm_90a (one nvcc per source, in parallel), count the tensor-core
   instructions of each kernel in the built library (the bfloat16 instances
   of the Swin block and of the window attention must hold some), and print
   the card's name and power limit as nvidia-smi reports them;
2. kernels: at the shapes the 1024^2 generator and the SwinIR-M enhancer
   give them, run each kernel and its plain PyTorch version on the same
   inputs, check the difference against a stated bound, and time kernel,
   plain version and (where one PyTorch call computes the same function)
   that call with CUDA events; K2's and K3's cases rotate through buffer
   sets past the L2 where one set is under 128 MB, and also log the kernel's
   device-only time per launch from torch.profiler (`device_ms`) beside the
   replaced kernel's (`previous_ms`);
3. swap: build FaceSwapper at the reference's default configuration
   (1024^2 output, full IR-SE encoder, full BiSeNet, float32) with seeded
   random weights, run B=1 aligned swaps in exact and fast regional mode,
   check the output and the kernels' launch counts, and hold one swap per
   mode against the same swap with the plain versions forced on the card;
   then time the bfloat16 configuration;
4. enhance: FullFaceSwapPipeline over that FaceSwapper with a full-width
   SwinIR-M "swinir" enhancer (seeded random weights), B=1 at 1024^2: check
   the output and the launch counts of two requests through the default
   fused route (K5), which must run no torch.roll, hold the whole call and
   the upscaler's unclipped output against the plain versions, run the
   upscaler once through K4 and once through K6 against their plain
   versions, then time bfloat16;
5. raw: the raw-frame swap at the default stack (RetinaFace MobileNet-0.25
   at det_size 640 and 2DFAN4 from `default_landmarker`, seeded random
   weights; the 1024^2 float32 aligned swap) on a 1280x960 source and a
   1920x1080 target: timed `FaceSwapper.swap` calls in exact and fast mode,
   one `swap_all` (at least one face) and one `FullFaceSwapPipeline.swap_raw`
   over the SwinIR-M enhancer; per call the launches (the detector runs no
   kernel), the landmarks and the frame against the same call with the plain
   versions forced on, and the pixels outside the pasted quad against the
   target frame;
6. video: `FaceSwapVideoPipeline` over the phase-3 float32 exact swapper
   and the default landmark stack, with the three loss nets at their
   published widths (seeded random weights), on an 8-frame 1280x720 clip
   with PTI 4 steps and stitching 2 steps: the frames, the tunes' losses,
   the launches of K1-K3 and of their backward kernels (which PTI and
   stitching run), the clip against the same clip with the plain versions
   forced on from the same starting weights, the pixels outside every
   pasted quad, a stitching run on two crops whose labels have background
   (the random parse has none, so the clip's border ring is empty) against
   its plain-version run, and one PTI step's time and peak memory at
   frames_per_chunk 2, 4 and 8. Phase 2 also holds each K1-K3 backward, at the 1024^2
   generator's shapes, against torch.autograd.grad of the plain version;
7. zoo: `FullFaceSwapPipeline` at the reference's default configuration
   with face_inpainting (GPEN-512 enhancement, the phase-3 float32 exact
   swapper, the Blender recolor with RealESRGAN x4 and the edge-aware
   blend, GCFSR inpainting; seeded random weights at published widths), B=1
   on 1024^2 crops: timed calls with the launch counts and the stage times,
   the call against the plain versions on the card, the inpaint
   composite's untouched pixels, `swap_batch` at B=4 against four single
   calls with its throughput and peak memory (and B=8, 16, 24), one `swap_raw` on
   phase 5's frames and one call per classical ct_mode (rct, lct, mkl,
   sot); then the CodeFormer and GFPGAN enhancers, MISF inpainting and a
   2-step W-space refinement once each. Phase 2 also holds K1 and K2 at the
   two shapes GPEN-512 adds;
8. reenact: the phase-7 pipeline with a faceVid2Vid pose driver (vox-256
   widths) and a Hopenet ResNet-50 pose estimator (`profile_swap.
   reenact_components`, seeded random weights), B=1 on 1024^2 crops at
   pose_gap_threshold 0 (every call drives the source): timed calls with
   each call's gap and gate decision, the launch counts, the stage times
   (pose_gate and pose_drive inside pose_align), the peak memory and the
   busy share of one traced call, the call against the plain versions on
   the card (image mean within 0.5 levels, the same gate decision), one
   call at the default 20 degrees,
   `swap_batch` at B=4 with a threshold between the pairs' gaps (each pair
   gated on its own) against four single calls; then TPSMM, DaGAN and LIA
   from the pose-drive registry once each at their published widths on a
   256^2 source and driving frame (ms per driven frame, finite output in
   range; LIA, which runs K1 and K2, against its plain versions), and
   DCNv2Pack at (1, 64, 128^2) against the same call on the CPU;
9. train: `Coach.fit` at the reference's default TrainConfig (1024^2, B=2,
   exact mode, the full IR-SE-50 encoder at 256^2, channel multiplier 2,
   remaining_layer_idx 13, the StyleGAN2 Discriminator at 1024, the three
   loss nets at published widths, Adam at 1e-4) on the phase-3 RGI weights
   and a seeded reference-style Discriminator (its Blur buffers checked and
   dropped), over seeded smooth 1024^2 batches with 12-class label maps at
   512^2; the one cut is the cadence (D every step, R1 every second: 3
   steps run D+R1, D, D+R1, each followed by G): ms per G, D and D+R1 step
   and images/s, the launches of K1-K3 forward, backward and double
   backward per step kind, each step's losses against the same 3 steps with
   the plain versions from the same weights (step 0 within 1e-4; later
   steps within 1e-3, R1 within 5e-2), the frozen tensors unchanged,
   a G step's peak memory with remat off and on, the EMA against its
   formula, and one G step over a process group at world size 1 (NCCL)
   against the same step without it. Phase 2 also holds K1's and
   K2's double backwards (R1's) at the Discriminator's largest shapes, and
   R1 with its parameter gradient of a 256^2 Discriminator through the
   kernels, against the plain versions;
10. edit: the editor over the phase-3 RGI weights (1024^2, channel
   multiplier 2, full IR-SE-50 at 256^2, BiSeNet at 512^2): `app.editor_parse`
   and `Editor.invert` of one face, then its five edits each re-rendered by
   `generate_from_label` in float32 exact, float32 fast and bfloat16 exact,
   each against the same re-render with the plain versions forced (phase
   3's bounds), the launches per re-render, the re-render's latency after a
   warm-up, its peak memory and one `program_mfu` reading of the float32
   exact re-render against the bfloat16 dense peak; the apps and eval:
   `editor_resynthesize` after an `editor_apply_stroke`, `recon_cli` over 4
   synthetic faces into a temporary directory (PNGs through `save_png`,
   SSIM, PSNR, RMSE), a 3-step `interpolation_strip` and `mouth_transfer`
   at 1024^2; and phase 6's clip with bfloat16 PTI (4 steps) and stitching
   (2 steps): ms per step and peak memory beside phase 6's float32 ones,
   the master weights float32, each PTI step's loss against the plain
   versions' (TUNE_BF16_PTI_LIMITS), and a bfloat16 stitching run with a
   border ring, from the clip's weights, against its plain-version run
   (TUNE_BF16_RING_LIMITS). Phase 2 also holds K1-K3's bfloat16
   backwards at PTI's shapes;
11. group: the multi-rank paths over a process group at world size 1
   (NCCL; the machine has one card, so world size 2 is held only by the
   CPU tests over gloo), each grouped run against the same run without
   the group, with its ms, peak memory and K1-K3 launches: (a) one D+R1
   step of phase 9's TrainConfig (1024^2, B=2), whose Discriminator
   gathers its minibatch-stddev features over the group (metrics within
   TRAIN_STEP0_REL, R1 within TRAIN_R1_LATER_REL); (b) 2 PTI steps and 2
   stitching steps over phase 6's 8-frame clip (the stitching on labels
   with a background band, as phase 6's ring run), each loss within 1e-3;
   the runs in turns (ungrouped, grouped, grouped, ungrouped);
   (c) `swap_batch` at B=4 of phase 7's zoo pipeline after
   `shard_inference(group)` (uint8, phase 7's 0.5 levels mean, the same
   launches as one call);
12. grid: phase 9's fit (its TrainConfig, weights, batches and 3 steps:
   D+R1, D, D+R1, each before a G step) by `Coach(process_group=
   make_process_grid(1, 2))`: two spawned ranks on the one card over gloo
   (NCCL refuses two ranks on one device; gloo carries the height split's
   all-reduces and broadcasts on CUDA tensors), each holding half of every
   image's rows. Each rank's per-step metrics against phase 9's run
   through the kernels and its run with the plain versions (phase 9's
   bounds), its K1-K3 launches (forward, backward, double backward) in the
   fit, equal to phase 9's fit's for every kernel, its ms per step kind and its peak memory beside phase 9's
   ungrouped peak.

The second-to-last line is a JSON object with one entry per kernel; the last
line is {"ok": true, "device": {...}}. Float32 convolutions and matrix
products of PyTorch run in full float32 (TF32 off) throughout; the float32
products inside K4-K6 are error-compensated 3xTF32, as accurate as float32
to within 2e-6.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM memory rate
F32_OPS_PER_S = 67e12       # H100 SXM float32 rate outside the tensor cores
BF16_OPS_PER_S = 989e12     # H100 SXM bf16 dense tensor-core rate
# float32 products of K4-K6 run as three tf32 tensor-core products each
# (495 TFLOP/s dense), so a third of that rate is the most float32 work they
# can do and no share of this bound can read over 1
TF32X3_OPS_PER_S = 495e12 / 3
SEED = 0
REQUESTS = 3
ENHANCE_REQUESTS = 2
# K2 and K3 cases whose inputs and outputs fit in under ROTATE_BYTES, 2.5x
# the L2, are timed over a rotation of buffer sets that moves at least that
ROTATE_BYTES = 128 * 2 ** 20

# launches per swap_aligned call at the default configuration
# (Generator.forward: 17 StyledConvs, 8 up-conv blurs + 8 ToRGB skips,
# 6 masked ToRGBs in both modes plus 2 per masked StyledConv in fast mode)
PER_CALL = {
    "exact": {"fused_leaky_relu": 17, "upfirdn2d": 16, "regional_scale": 6},
    "fast": {"fused_leaky_relu": 17, "upfirdn2d": 16, "regional_scale": 32},
}

# launches per upscaler call of SwinIR-M (6 RSTBs of 6 blocks) in each route
SWIN_BLOCKS = 36
ROUTE_KERNEL = {"fused": "fused_swin_block", "nhwc": "swin_attention_nhwc",
                "windowed": "fused_window_attention"}

# The same cases' times with the float32-FMA kernels these replaced
# (chip_smoke.py of that version, NVIDIA H100 80GB HBM3, 700.00 W), by
# (kernel, dtype, shift); K5's shift was the caller's two rolls then.
PREVIOUS_MS = {
    ("swin_attention_nhwc", "float32", 0): 4.8152, ("swin_attention_nhwc", "float32", 4): 4.9979,
    ("swin_attention_nhwc", "bfloat16", 0): 4.8537, ("swin_attention_nhwc", "bfloat16", 4): 5.0157,
    ("fused_window_attention", "float32", 0): 4.4153,
    ("fused_window_attention", "float32", 4): 4.5360,
    ("fused_window_attention", "bfloat16", 0): 4.3664,
    ("fused_window_attention", "bfloat16", 4): 4.5391,
    ("fused_swin_block", "float32", 0): 42.8471, ("fused_swin_block", "float32", 4): 43.0100,
    ("fused_swin_block", "bfloat16", 0): 44.3271, ("fused_swin_block", "bfloat16", 4): 44.5784,
}
# The K2 and K3 cases' device_ms with the scalar kernels these replaced,
# timed as phase_kernels times them now (NVIDIA H100 80GB HBM3, 700.00 W),
# by (kernel, case label, dtype).
PREVIOUS_DEVICE_MS = {
    ("upfirdn2d", "blur after transposed conv, 1024^2", "float32"): 0.2528197,
    ("upfirdn2d", "blur after transposed conv, 1024^2", "bfloat16"): 0.2301989,
    ("upfirdn2d", "exact-mode blur, 12 regions at 256^2", "float32"): 0.7482610,
    ("upfirdn2d", "exact-mode blur, 12 regions at 256^2", "bfloat16"): 0.6823498,
    ("upfirdn2d", "exact-mode blur, 12 regions at 128^2", "float32"): 0.3776486,
    ("upfirdn2d", "ToRGB skip upsample to 1024^2", "float32"): 0.0233288,
    ("upfirdn2d", "blur3x3_tpu's case, pad (2, 1)", "float32"): 0.1199507,
    ("regional_scale", "fast-mode StyledConv at 256^2", "float32"): 0.0317258,
    ("regional_scale", "fast-mode StyledConv at 256^2", "bfloat16"): 0.0247762,
    ("regional_scale", "masked ToRGB at 128^2", "float32"): 0.0229585,
}
# phase 6: the tunes' steps, and the chunk sizes of the PTI-step sweep
VIDEO_PTI_STEPS, VIDEO_STITCHING_STEPS = 4, 2
CHUNK_SWEEP = (2, 4, 8)
# the later stitching steps' losses, kernels against plain versions: the
# first step's gradient is rounding noise on the random-weight clip (see
# phase_video; 3.8e-3 to 5.8e-3 at step 2 in three runs on an H100)
STITCH_LATER_REL = 2e-2
# the stitching run on labels with background (a border ring that is not
# empty): its steps, each held at phase 6's 1e-3
STITCH_RING_STEPS = 3
BACKWARD = ("fused_leaky_relu_backward", "upfirdn2d_backward", "regional_scale_backward")

# phase 7: launches per FullFaceSwapPipeline call at the default config
# (GPEN-512: 8 ConvLayers of the encoder, K1 after each and K2 before the 7
# downsampling ones, K1 after the style head, the 8 style-MLP layers and the
# 15 styled convs, K2 after the 7 up-convs and on the 7 ToRGB skips;
# GCFSR-256: K1 after 8 activated ConvLayers, the latent head and 9 styled
# convs, K2 before the 6 downsampling ConvLayers, after the 4 up-convs and on
# the 4 ToRGB skips; the core swap as PER_CALL["exact"]; Blender runs none;
# RRDB x4 K7 in each of its 23 x 3 dense blocks' 5 convs, conv_body,
# conv_up1, conv_up2 and conv_hr; a swap_batch call launches as many as one
# call; a classical ct_mode runs no RRDB), the timed requests, the B of
# swap_batch against single calls, larger Bs for the memory line, the
# classical ct_modes it runs
RDB_PER_UPSCALE = 23 * 3 * 5 + 4
ZOO_PER_CALL = {"fused_leaky_relu": 17 + 32 + 18, "upfirdn2d": 16 + 21 + 14,
                "regional_scale": 6, "rdb_conv": RDB_PER_UPSCALE}
ZOO_CT_PER_CALL = dict(ZOO_PER_CALL, rdb_conv=0)
ZOO_REQUESTS, ZOO_BATCH, ZOO_BATCH_MEMORY = 3, 4, (8, 16, 24)
ZOO_CT_MODES = ("rct", "lct", "mkl", "sot")
OPTIMIZE_W_STEPS = 2
# the kernel cases phase 7 adds, reported in the summary line too
ZOO_CASES = (("fused_leaky_relu", "GPEN-512 decoder after the concat, (1, 128, 512^2)"),
             ("upfirdn2d", "GPEN-512 encoder downsample blur, (1, 64, 512^2) pad (2, 2)"))

# phase 8: the reenacted calls (faceVid2Vid, Hopenet and the pose gate run
# no K1-K3, so a call launches what a phase-7 call does), the swap_batch B,
# the frames timed per registry driver, LIA's bound against its plain
# versions, and DCNv2Pack's case and bound against the CPU. LIA's bound is
# the larger of 1e-3 of its output's largest magnitude (at least 1) and 4x
# the largest change that a one-ulp perturbation of its two input frames
# makes in the plain-version output (3 draws): on random weights and
# white-noise frames LIA amplifies float32 rounding about 1e4-fold (a 1e-7
# relative perturbation of K1's outputs moves its output by 3e-3, a one-ulp
# input perturbation by 1.5e-3 to 3.7e-3; CPU runs of the same seeded net),
# so summation order alone exceeds 1e-3 there
REENACT_REQUESTS, REENACT_BATCH, DRIVER_FRAMES = 3, 4, 3
LIA_REL_TOL, LIA_ULP_FACTOR, LIA_ULP_DRAWS = 1e-3, 4.0, 3
DCN_SHAPE, DCN_TOL = (1, 64, 128, 128), 1e-4

# phase 2: the double-backward cases (R1's), reported in the summary line
DOUBLE_BACKWARD_CASES = (
    ("fused_leaky_relu_double_backward", "Discriminator convs.0 at 1024^2, B=2"),
    ("upfirdn2d_double_backward", "Discriminator ResBlock blur at 1024^2, B=2, pad (2, 2)"))
DOUBLE_BACKWARD = tuple(name for name, _ in DOUBLE_BACKWARD_CASES)

# phase 9: the trainer at the default TrainConfig, its one cut (the
# cadence: D every step, R1 every second, so that 3 steps run D+R1, D and
# D+R1), the steps, and the fixed bounds of the kernels' run against the
# plain versions': step 0 summation order; later steps also Adam's
# lr-sized steps on rounding noise, as phase 6. In eleven runs without a
# fault, R1 after two D updates (4.5e-6 at 1024^2 on these weights)
# differed from the plain versions' by 3.8e-6 to 8.0e-3, the other later
# metrics by at most 6.4e-4; with K1's backward at a wrong slope, by 0.26
# and 1.2e-2 (train_fault_control.py; NVIDIA H100 80GB HBM3, 700.00 W)
TRAIN_D_EVERY, TRAIN_D_REG_EVERY, TRAIN_STEPS = 1, 2, 3
TRAIN_STEP0_REL, TRAIN_LATER_REL, TRAIN_R1_LATER_REL = 1e-4, 1e-3, 5e-2
TRAIN_DDP_REL = 1e-5
TRAIN_METRICS = ("loss", "loss_l2", "loss_lpips", "loss_id", "loss_face_parsing",
                 "loss_g_adv", "d_loss", "r1_loss")

# phase 10: the editor's configurations (dtype, regional mode), the timed
# re-renders after a warm-up, the recon_cli items, the interpolation steps,
# the bfloat16 tune's steps and its bounds against the plain versions, and
# the bfloat16 backward cases phase 2 adds at PTI's shapes
# (frames_per_chunk 2: B=2), reported in the summary line too. The bounds,
# (first step, later steps), relative: a first step's loss is the forward's
# alone (2.4e-5 to 1.0e-4 in five runs without a fault); later steps carry
# Adam's steps on bfloat16 gradient noise: PTI's 2.4e-2 to 2.9e-2 in five
# runs, the ring run's (from the clip's weights) 5.8e-3. Planted faults:
# K1's backward at slope 0.25 gave PTI 6.3e-2 and the ring 5.9e-2, K3's
# backward x0.9 the ring 7.4e-2 (PTI 3.6e-2), K2's x0.9 stayed in the noise
# (Adam's steps do not see a gradient's scale; phase 2's bfloat16 backward
# cases hold it). So the ring run, quiet, is the fault detector, and PTI's
# bound only catches gross faults (train_fault_control.py --tune; NVIDIA
# H100 80GB HBM3, 700.00 W)
EDIT_CONFIGS = (("float32", "exact"), ("float32", "fast"), ("bfloat16", "exact"))
EDIT_RENDERS, EDIT_RECON_ITEMS, EDIT_STRIP_STEPS = 3, 4, 3
TUNE_BF16_PTI_STEPS, TUNE_BF16_STITCHING_STEPS = 4, 2
TUNE_BF16_PTI_LIMITS, TUNE_BF16_RING_LIMITS = (2e-3, 8e-2), (2e-3, 2e-2)
BF16_BACKWARD_CASES = (
    ("fused_leaky_relu_backward", "StyledConv at 1024^2, PTI chunk B=2, bfloat16"),
    ("upfirdn2d_backward", "blur after transposed conv, 1024^2, PTI chunk B=2, bfloat16"),
    ("regional_scale_backward", "fast-mode StyledConv at 256^2, PTI chunk B=2, bfloat16"))

# phase 11: the tunes' steps over the group and their bound against the
# ungrouped run (phase 6's), and the phase's time budget in seconds
GROUP_TUNE_STEPS, GROUP_TUNE_REL, GROUP_PHASE_S = 2, 1e-3, 60.0

# phase 12: the grid of ranks (dp, sp) and the seconds its ranks may take,
# start-up and kernel loading included, before they are stopped
GRID, GRID_TIMEOUT_S = (1, 2), 300.0

# kernels whose bfloat16 instances must hold tensor-core instructions, and
# those whose every instance must (K7 has float32 instances only)
TENSOR_CORE_KERNELS = ("swin_block_kernel", "window_attention_kernel")
TENSOR_CORE_F32_KERNELS = ("rdb_conv_kernel",)

# the backward and double-backward kernels replace no TPU kernel (the JAX
# package differentiates XLA ops); `replaces` names the TPU kernel whose
# gradient they compute
KERNEL_INFO = {
    "fused_leaky_relu": ("e4s2024_torch/kernels/csrc/fused_act.cu",
                         "e4s2024_tpu/ops/pallas/kernels.py:58"),
    "upfirdn2d": ("e4s2024_torch/kernels/csrc/upfirdn2d.cu",
                  "e4s2024_tpu/ops/pallas/kernels.py:96"),
    "regional_scale": ("e4s2024_torch/kernels/csrc/regional_scale.cu",
                       "e4s2024_tpu/ops/pallas/kernels.py:142"),
    "fused_leaky_relu_backward": ("e4s2024_torch/kernels/csrc/fused_act.cu",
                                  "e4s2024_tpu/ops/pallas/kernels.py:58"),
    "upfirdn2d_backward": ("e4s2024_torch/kernels/csrc/upfirdn2d.cu",
                           "e4s2024_tpu/ops/pallas/kernels.py:96"),
    "regional_scale_backward": ("e4s2024_torch/kernels/csrc/regional_scale.cu",
                                "e4s2024_tpu/ops/pallas/kernels.py:142"),
    "fused_leaky_relu_double_backward": ("e4s2024_torch/kernels/csrc/fused_act.cu",
                                         "e4s2024_tpu/ops/pallas/kernels.py:58"),
    "upfirdn2d_double_backward": ("e4s2024_torch/kernels/csrc/upfirdn2d.cu",
                                  "e4s2024_tpu/ops/pallas/kernels.py:96"),
    "swin_attention_nhwc": ("e4s2024_torch/kernels/csrc/window_attention.cu",
                            "e4s2024_tpu/ops/window_attention.py:131"),
    "fused_swin_block": ("e4s2024_torch/kernels/csrc/swin_block.cu",
                         "e4s2024_tpu/ops/swin_block.py:126"),
    "fused_window_attention": ("e4s2024_torch/kernels/csrc/window_attention.cu",
                               "e4s2024_tpu/ops/window_attention.py:55"),
    "rdb_conv": ("e4s2024_torch/kernels/csrc/rdb_conv.cu",
                 "none (XLA convolutions, e4s2024_tpu/models/rrdb.py)"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, iters: int = 20, warmup: int = 3, sets=((),)) -> float:
    """Mean ms per call by CUDA events; call i is fn(*sets[i % len(sets)]).
    The last len(sets) outputs stay alive, so the outputs rotate too."""
    outs = [None] * len(sets)
    for i in range(warmup):
        outs[i % len(sets)] = fn(*sets[i % len(sets)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        outs[i % len(sets)] = fn(*sets[i % len(sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, symbol: str, iters: int = 20, sets=((),)):
    """Mean device time per launch of the CUDA kernels whose name holds
    `symbol`, over `iters` calls as `time_ms` makes them, from
    torch.profiler's self device time (the wrapper's host cost is not in
    it); None if the profiler saw no such kernel."""
    from torch.autograd import DeviceType

    outs = [fn(*s) for s in sets]
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(iters):
            outs[i % len(sets)] = fn(*sets[i % len(sets)])
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and symbol in e.key]
    count = sum(e.count for e in hits)
    del outs
    return sum(e.self_device_time_total for e in hits) / count / 1e3 if count else None


def rotation(make, working_set_bytes: int) -> list:
    """Buffer sets `make()` for a case, enough that one cycle through them
    moves ROTATE_BYTES (so the caller's cold inputs are not served from the
    50 MB L2); one where a set alone moves that much."""
    n = max(1, -(-ROTATE_BYTES // working_set_bytes))
    return [make() for _ in range(n)]


def phase_build(torch):
    from e4s2024_torch.kernels import build

    t0 = time.perf_counter()
    build.library()
    log(f"[build] kernels ready in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {build.build_info['seconds']:.1f} s, {' '.join(build.NVCC_FLAGS[:1])})")
    for line in build.build_info.get("report", "").splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"[build] {line.strip()}")
    _tensor_core_counts(build)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    return card


def _tensor_core_counts(build):
    """Log, per kernel of the built library, how many tensor-core
    instructions (HMMA: mma.sync; HGMMA: wgmma) its SASS holds, and fail if
    a bfloat16 instance of the Swin block or the window attention has none."""
    sass = subprocess.run([build.cuda_tool("cuobjdump"), "-sass", str(build.library_path())],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    counts: dict[str, int] = {}
    name = None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = 0
        elif name is not None and ("HMMA" in line or "HGMMA" in line):
            counts[name] += 1
    for fn, count in sorted(counts.items()):
        log(f"[build] tensor-core instructions {count:5d}  {fn[:110]}")
    for kernel in TENSOR_CORE_KERNELS:
        bf16 = {fn: c for fn, c in counts.items() if kernel in fn and "bfloat16" in fn}
        if not bf16 or min(bf16.values()) == 0:
            raise AssertionError(f"{kernel}: bfloat16 instances without tensor-core "
                                 f"instructions: {bf16}")
    for kernel in TENSOR_CORE_F32_KERNELS:
        every = {fn: c for fn, c in counts.items() if kernel in fn}
        if not every or min(every.values()) == 0:
            raise AssertionError(f"{kernel}: instances without tensor-core instructions: "
                                 f"{every}")


def _case_record(torch, name, label, kernel_fn, plain_fn, ref_fn, library_fn,
                 bytes_moved, ops, rtol, atol, ops_rate=F32_OPS_PER_S, iters=20,
                 previous_ms=None, sets=((),), symbol=None, library_err=False):
    """`ops_rate` is the card's peak for the case's work: float32 outside the
    tensor cores, a third of the tf32 tensor-core rate for float32 products
    done as 3xTF32, or the bf16 tensor-core rate for bf16 products.
    `previous_ms` is the replaced kernel's time on the same case, a constant
    of this file that goes into the case's log line only: the summary line
    holds what this run measured. The functions take the arguments of one of
    `sets`, the buffer sets the timings rotate through; the first is checked.
    With `symbol`, the log line also holds `device_ms`, the kernel's device
    time per launch from the profiler; with `library_err`, the library
    call's largest difference from `ref_fn`."""
    got = kernel_fn(*sets[0])
    ref = ref_fn(*sets[0])
    torch.cuda.synchronize()
    err = float((got.float() - ref.float()).abs().max())
    bound = atol + rtol * float(ref.float().abs().max())
    ok = err <= bound and bool(torch.isfinite(got).all())
    dtype, shape = str(got.dtype).replace("torch.", ""), list(got.shape)
    del got, ref
    rec = {
        "name": name, "case": label, "dtype": dtype, "shape": shape,
        "max_abs_err": err, "err_bound": bound,
        "ms": time_ms(torch, kernel_fn, iters, sets=sets),
        "plain_ms": time_ms(torch, plain_fn, iters, sets=sets),
        "library_ms": None if library_fn is None else time_ms(torch, library_fn, iters,
                                                               sets=sets),
        "bound_ms": max(bytes_moved / HBM_BYTES_PER_S, ops / ops_rate) * 1e3,
        "bound_by": "bytes" if bytes_moved / HBM_BYTES_PER_S >= ops / ops_rate
        else "operations",
        "ok": ok,
    }
    if library_fn is not None and library_err:
        lib = library_fn(*sets[0])
        rec["library_max_abs_err"] = float((lib.float() - ref_fn(*sets[0]).float()).abs().max())
        del lib
    if symbol is not None:
        rec["device_ms"] = device_ms(torch, kernel_fn, symbol, iters, sets=sets)
        rec["buffer_sets"] = len(sets)
    if previous_ms is not None:
        rec["previous_ms"] = previous_ms
    log(f"[kernels] {json.dumps(rec)}")
    return rec


def phase_kernels(torch):
    """Each kernel against its plain version at main-path shapes. The first
    case of each kernel is the one the summary line reports."""
    import torch.nn.functional as F

    from e4s2024_torch.ops import fused_act, modulate, upfirdn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def rel(dtype):  # float32: summation order; bfloat16: one output rounding
        return (1e-5, 1e-5) if dtype == torch.float32 else (2.0 ** -8, 1e-6)

    records = []
    # K1: bias + LeakyReLU * sqrt(2) after the last StyledConv at 1024^2
    for dtype in (torch.float32, torch.bfloat16):
        x, b = randn(1, 32, 1024, 1024, dtype=dtype), randn(32)
        es = x.element_size()
        rtol, atol = rel(dtype)
        records.append(_case_record(
            torch, "fused_leaky_relu", "StyledConv at 1024^2",
            lambda: fused_act.fused_leaky_relu(x, b),
            lambda: fused_act.fused_leaky_relu_plain(x, b),
            lambda: fused_act.fused_leaky_relu_plain(x.float(), b),
            None, 2 * x.numel() * es + b.numel() * 4, 3 * x.numel(), rtol, atol))

    # K2: upfirdn2d in the cases the generator runs
    blur = upfirdn.make_kernel([1, 3, 3, 1])
    k_dev = (torch.flip(blur, (0, 1)) * 4).to(dev)

    def depthwise(dtype):  # one library call for the x4-gain blur at pad (1, 1)
        w = k_dev.to(dtype)
        return lambda x: F.conv2d(x, w.expand(x.shape[1], 1, 4, 4), padding=1,
                                  groups=x.shape[1])

    cases = [
        # (label, input shape, up, pad, gain, dtype, library call or None)
        ("blur after transposed conv, 1024^2", (1, 32, 1025, 1025), 1, (1, 1), 4.0,
         torch.float32, depthwise(torch.float32)),
        ("blur after transposed conv, 1024^2", (1, 32, 1025, 1025), 1, (1, 1), 4.0,
         torch.bfloat16, depthwise(torch.bfloat16)),
        ("exact-mode blur, 12 regions at 256^2", (12, 128, 257, 257), 1, (1, 1), 4.0,
         torch.float32, depthwise(torch.float32)),
        ("exact-mode blur, 12 regions at 256^2", (12, 128, 257, 257), 1, (1, 1), 4.0,
         torch.bfloat16, depthwise(torch.bfloat16)),
        ("exact-mode blur, 12 regions at 128^2", (12, 256, 129, 129), 1, (1, 1), 4.0,
         torch.float32, depthwise(torch.float32)),
        ("ToRGB skip upsample to 1024^2", (1, 3, 512, 512), 2, (2, 1), 4.0, torch.float32,
         lambda x: F.conv_transpose2d(x, (blur * 4).to(dev).expand(3, 1, 4, 4), stride=2,
                                      padding=1, groups=3)),
        ("blur3x3_tpu's case, pad (2, 1)", (1, 64, 512, 512), 1, (2, 1), 1.0, torch.float32,
         None),
    ]
    for label, shape, up, pad, gain, dtype, lib in cases:
        k = blur * gain
        out_elems = (shape[0] * shape[1] * upfirdn.out_size(shape[2], 4, up, 1, pad)
                     * upfirdn.out_size(shape[3], 4, up, 1, pad))
        es = torch.finfo(dtype).bits // 8
        bytes_moved = (int(np.prod(shape)) + out_elems) * es
        sets = rotation(lambda: (randn(*shape, dtype=dtype),), bytes_moved)
        rtol, atol = rel(dtype)
        records.append(_case_record(
            torch, "upfirdn2d", label,
            lambda x: upfirdn.upfirdn2d(x, k, up=up, pad=pad),
            lambda x: upfirdn.upfirdn2d_plain(x, k, up=up, pad=pad),
            lambda x: upfirdn.upfirdn2d_plain(x.float(), k, up=up, pad=pad),
            lib, bytes_moved, 2 * 16 // (up * up) * out_elems, rtol, atol,
            previous_ms=PREVIOUS_DEVICE_MS.get(("upfirdn2d", label, str(dtype)[6:])),
            sets=sets, symbol="upfirdn2d_kernel"))
        del sets

    # K3: per-pixel regional scale, fast-mode demodulation at 256^2 and the
    # last masked ToRGB's modulation at 128^2; library call: one einsum,
    # seg and scales contracted over the regions first, then times x
    for label, (c, hw), dtype in [("fast-mode StyledConv at 256^2", (128, 256), torch.float32),
                                  ("fast-mode StyledConv at 256^2", (128, 256), torch.bfloat16),
                                  ("masked ToRGB at 128^2", (256, 128), torch.float32)]:
        def make():
            lbl = torch.randint(0, 12, (1, hw, hw), generator=gen, device=dev)
            return (randn(1, c, hw, hw, dtype=dtype),
                    F.one_hot(lbl, 12).permute(0, 3, 1, 2).to(dtype).contiguous(),
                    randn(1, 12, c, dtype=dtype))

        es = torch.finfo(dtype).bits // 8
        bytes_moved = (2 * c * hw * hw + 12 * hw * hw + 12 * c) * es
        sets = rotation(make, bytes_moved)
        rtol, atol = rel(dtype)
        records.append(_case_record(
            torch, "regional_scale", label, modulate.regional_scale,
            modulate.regional_scale_plain,
            lambda x, seg, s: modulate.regional_scale_plain(x.float(), seg.float(), s.float()),
            lambda x, seg, s: torch.einsum("bkhw,bkc,bchw->bchw", seg, s, x),
            bytes_moved, 25 * c * hw * hw, rtol, atol,
            previous_ms=PREVIOUS_DEVICE_MS.get(("regional_scale", label, str(dtype)[6:])),
            sets=sets, symbol="regional_scale_kernel"))
        del sets

    records += _zoo_kernel_records(torch, randn)
    records += _backward_records(torch, randn, gen)
    records += _bf16_backward_records(torch, randn, gen)
    records += _double_backward_records(torch, randn)
    _r1_check(torch)
    records += _swin_kernel_records(torch, randn)
    records += _rdb_kernel_records(torch, randn)
    failed = [r for r in records if not r["ok"]]
    if failed:
        raise AssertionError(f"kernels disagree with their plain versions: {failed}")
    return records


def _zoo_kernel_records(torch, randn):
    """K1 and K2 at the shapes the zoo-enhanced swap adds, float32 (phase
    7): GPEN-512's largest K1, after its last decoder conv concatenates the
    encoder's features onto the conv's output, and the blur of its
    encoder's first downsampling ConvLayer (pad (2, 2), gain 1). Their cases
    are ZOO_CASES, the summary line reports them beside each kernel's first
    case."""
    import torch.nn.functional as F

    from e4s2024_torch.ops import fused_act, upfirdn

    label_k1, label_k2 = (label for _, label in ZOO_CASES)
    x, b = randn(1, 128, 512, 512), randn(128)
    records = [_case_record(
        torch, "fused_leaky_relu", label_k1,
        lambda: fused_act.fused_leaky_relu(x, b),
        lambda: fused_act.fused_leaky_relu_plain(x, b),
        lambda: fused_act.fused_leaky_relu_plain(x, b),
        None, 2 * x.numel() * 4 + b.numel() * 4, 3 * x.numel(), 1e-5, 1e-5)]
    del x
    blur = upfirdn.make_kernel([1, 3, 3, 1])
    shape, pad = (1, 64, 512, 512), (2, 2)
    w = torch.flip(blur, (0, 1)).cuda().expand(shape[1], 1, 4, 4)
    out_elems = shape[0] * shape[1] * upfirdn.out_size(shape[2], 4, 1, 1, pad) ** 2
    bytes_moved = (int(np.prod(shape)) + out_elems) * 4
    sets = rotation(lambda: (randn(*shape),), bytes_moved)
    records.append(_case_record(
        torch, "upfirdn2d", label_k2,
        lambda x: upfirdn.upfirdn2d(x, blur, pad=pad),
        lambda x: upfirdn.upfirdn2d_plain(x, blur, pad=pad),
        lambda x: upfirdn.upfirdn2d_plain(x, blur, pad=pad),
        lambda x: F.conv2d(x, w, padding=2, groups=shape[1]), bytes_moved, 2 * 16 * out_elems,
        1e-5, 1e-5, sets=sets, symbol="upfirdn2d_kernel"))
    del sets
    return records


def _backward_records(torch, randn, gen):
    """K1-K3's backwards at the 1024^2 generator's shapes, float32, each
    kernel's gradient held against torch.autograd.grad of the plain
    forward on the same inputs (summation order only: 1e-5 of the largest
    element). K2's cases: the blur after each transposed convolution, the
    ToRGB skip's up-2 upsample (its gradient a down-2 pass with pads
    (1, 1)), down-2 resampling (an up-2 pass). K3's: grad_x = K3 on
    (grad, seg, scales); grad_scales, a plain batched product, is timed
    and checked in its own log line. Library yardsticks: the depthwise
    convolution (or its transpose) that computes the same gradient, and
    the forward's einsum for K3."""
    import torch.nn.functional as F

    from e4s2024_torch.ops import fused_act, modulate, upfirdn

    dev = torch.device("cuda")
    records = []

    def autograd_plain(plain, x, g, *rest):
        xr = x.detach().requires_grad_(True)
        return torch.autograd.grad(plain(xr, *rest), xr, g)[0]

    # K1: the last StyledConv at 1024^2; the backward reads the output
    x, b = randn(1, 32, 1024, 1024), randn(32)
    g = randn(1, 32, 1024, 1024)
    out = fused_act.fused_leaky_relu_plain(x, b)
    records.append(_case_record(
        torch, "fused_leaky_relu_backward", "StyledConv at 1024^2",
        lambda: fused_act.fused_leaky_relu_backward(g, out),
        lambda: fused_act.fused_leaky_relu_backward_plain(g, out),
        lambda: autograd_plain(fused_act.fused_leaky_relu_plain, x, g, b),
        None, 3 * x.numel() * 4, 2 * x.numel(), 1e-5, 1e-5,
        symbol="fused_leaky_relu_backward_kernel"))
    del x, g, out

    blur = upfirdn.make_kernel([1, 3, 3, 1])

    def depthwise(k, c):
        return k.to(dev).expand(c, 1, *k.shape)

    cases = [
        # (label, input shape, up, down, pad, gain, library call on g)
        ("blur after transposed conv, 1024^2", (1, 32, 1025, 1025), 1, 1, (1, 1), 4.0,
         lambda g: F.conv2d(g, depthwise(blur * 4, 32), padding=2, groups=32)),
        ("ToRGB skip upsample to 1024^2", (1, 3, 512, 512), 2, 1, (2, 1), 4.0,
         lambda g: F.conv2d(g, depthwise(blur * 4, 3), stride=2, padding=1, groups=3)),
        ("down-2 resampling of 1024^2", (1, 3, 1024, 1024), 1, 2, (1, 1), 1.0,
         lambda g: F.conv_transpose2d(g, depthwise(torch.flip(blur, (0, 1)), 3), stride=2,
                                      padding=1, groups=3)),
    ]
    for label, shape, up, down, pad, gain, lib in cases:
        k = blur * gain
        oh = upfirdn.out_size(shape[2], 4, up, down, pad)
        ow = upfirdn.out_size(shape[3], 4, up, down, pad)
        g_shape = (*shape[:2], oh, ow)
        in_elems, out_elems = int(np.prod(shape)), int(np.prod(g_shape))
        bytes_moved = (in_elems + out_elems) * 4
        sets = rotation(lambda: (randn(*shape), randn(*g_shape)), bytes_moved)
        records.append(_case_record(
            torch, "upfirdn2d_backward", label,
            lambda x, g: upfirdn.upfirdn2d_backward(g, k, up, down, pad, shape[2:]),
            lambda x, g: upfirdn.upfirdn2d_backward_plain(g, k, up, down, pad, shape[2:]),
            lambda x, g: autograd_plain(upfirdn.upfirdn2d_plain, x, g, k, up, down, pad),
            lambda x, g: lib(g), bytes_moved, 2 * 16 // (down * down) * in_elems,
            1e-5, 1e-5, sets=sets, symbol="upfirdn2d_kernel", library_err=True))
        del sets

    for label, (c, hw) in [("fast-mode StyledConv at 256^2", (128, 256)),
                           ("masked ToRGB at 128^2", (256, 128))]:
        def make():
            lbl = torch.randint(0, 12, (1, hw, hw), generator=gen, device=dev)
            return (randn(1, c, hw, hw),
                    F.one_hot(lbl, 12).permute(0, 3, 1, 2).float().contiguous(),
                    randn(1, 12, c), randn(1, c, hw, hw))

        bytes_moved = (2 * c * hw * hw + 12 * hw * hw + 12 * c) * 4
        sets = rotation(make, bytes_moved)
        records.append(_case_record(
            torch, "regional_scale_backward", label,
            lambda x, seg, s, g: modulate.regional_scale_backward(g, seg, s),
            lambda x, seg, s, g: modulate.regional_scale_plain(g, seg, s),
            lambda x, seg, s, g: autograd_plain(
                lambda t, seg_, s_: modulate.regional_scale_plain(t, seg_, s_), x, g, seg, s),
            lambda x, seg, s, g: torch.einsum("bkhw,bkc,bchw->bchw", seg, s, g),
            bytes_moved, 25 * c * hw * hw, 1e-5, 1e-5, sets=sets,
            symbol="regional_scale_kernel", library_err=True))
        x, seg, s, g = sets[0]
        sr = s.detach().requires_grad_(True)
        want = torch.autograd.grad(modulate.regional_scale_plain(x, seg, sr), sr, g)[0]
        got = modulate.regional_scale_grad_scales(g, x, seg)
        err = float((got - want).abs().max())
        rec = {"name": "regional_scale grad_scales (plain batched product)", "case": label,
               "max_abs_err": err, "err_bound": 1e-4 * float(want.abs().max()),
               "ms": time_ms(torch, modulate.regional_scale_grad_scales, sets=[
                   (gg, xx, sg) for xx, sg, _, gg in sets]),
               "bound_ms": max((2 * c * hw * hw + 12 * hw * hw) * 4 / HBM_BYTES_PER_S,
                               (2 * 12 + 1) * c * hw * hw / F32_OPS_PER_S) * 1e3}
        log(f"[kernels] {json.dumps(rec)}")
        if err > rec["err_bound"]:
            raise AssertionError(f"grad_scales disagrees with autograd: {rec}")
        del sets, x, seg, s, g
    torch.cuda.empty_cache()
    return records


def _bf16_backward_records(torch, randn, gen):
    """K1-K3's backwards in bfloat16 at the shapes bfloat16 PTI gives them
    (phase 10: the 1024^2 generator, chunks of 2 frames): K1 after the
    last StyledConv, K2 after the last transposed conv (its gradient a K2
    pass on flipped taps), K3 in a fast-mode StyledConv at 256^2. Each
    against the plain backward in float32 on the same bfloat16 inputs
    (one rounding of the output: 2^-8 of the largest element); library
    yardsticks in bfloat16 as in `_backward_records`. Their cases are
    BF16_BACKWARD_CASES."""
    import torch.nn.functional as F

    from e4s2024_torch.ops import fused_act, modulate, upfirdn

    bf16, dev = torch.bfloat16, torch.device("cuda")
    (k1_label, k2_label, k3_label) = (label for _, label in BF16_BACKWARD_CASES)
    rtol, atol = 2.0 ** -8, 1e-6
    records = []

    shape = (2, 32, 1024, 1024)
    x, b = randn(*shape, dtype=bf16), randn(32)
    g = randn(*shape, dtype=bf16)
    out = fused_act.fused_leaky_relu_plain(x, b)
    records.append(_case_record(
        torch, "fused_leaky_relu_backward", k1_label,
        lambda: fused_act.fused_leaky_relu_backward(g, out),
        lambda: fused_act.fused_leaky_relu_backward_plain(g, out),
        lambda: fused_act.fused_leaky_relu_backward_plain(g.float(), out.float()),
        None, 3 * out.numel() * 2, 2 * out.numel(), rtol, atol,
        symbol="fused_leaky_relu_backward_kernel"))
    del x, g, out

    k = upfirdn.make_kernel([1, 3, 3, 1]) * 4.0
    shape, pad = (2, 32, 1025, 1025), (1, 1)
    g_shape = (2, 32, upfirdn.out_size(1025, 4, 1, 1, pad), upfirdn.out_size(1025, 4, 1, 1, pad))
    w = k.to(dev, bf16).expand(32, 1, 4, 4)
    bytes_moved = (int(np.prod(shape)) + int(np.prod(g_shape))) * 2
    sets = rotation(lambda: (randn(*g_shape, dtype=bf16),), bytes_moved)
    records.append(_case_record(
        torch, "upfirdn2d_backward", k2_label,
        lambda g: upfirdn.upfirdn2d_backward(g, k, 1, 1, pad, shape[2:]),
        lambda g: upfirdn.upfirdn2d_backward_plain(g, k, 1, 1, pad, shape[2:]),
        lambda g: upfirdn.upfirdn2d_backward_plain(g.float(), k, 1, 1, pad, shape[2:]),
        lambda g: F.conv2d(g, w, padding=2, groups=32), bytes_moved,
        2 * 16 * int(np.prod(shape)), rtol, atol, sets=sets, symbol="upfirdn2d_kernel"))
    del sets

    c, hw = 128, 256

    def make():
        lbl = torch.randint(0, 12, (2, hw, hw), generator=gen, device=dev)
        return (F.one_hot(lbl, 12).permute(0, 3, 1, 2).to(bf16).contiguous(),
                randn(2, 12, c, dtype=bf16), randn(2, c, hw, hw, dtype=bf16))

    bytes_moved = 2 * (2 * c * hw * hw + 12 * hw * hw + 12 * c) * 2
    sets = rotation(make, bytes_moved)
    records.append(_case_record(
        torch, "regional_scale_backward", k3_label,
        lambda seg, s, g: modulate.regional_scale_backward(g, seg, s),
        lambda seg, s, g: modulate.regional_scale_plain(g, seg, s),
        lambda seg, s, g: modulate.regional_scale_plain(g.float(), seg.float(), s.float()),
        lambda seg, s, g: torch.einsum("bkhw,bkc,bchw->bchw", seg, s, g),
        bytes_moved, 2 * 25 * c * hw * hw, rtol, atol, sets=sets,
        symbol="regional_scale_kernel"))
    del sets
    torch.cuda.empty_cache()
    return records


def _double_backward_records(torch, randn):
    """K1's and K2's double backwards (R1's) at the Discriminator's largest
    shapes in phase 9 (B=2 at 1024^2, channel multiplier 2): K1 after
    `convs.0` on (2, 32, 1024^2), K2 as the first ResBlock's blur before its
    stride-2 conv, pad (2, 2), gain 1, on (2, 32, 1024^2). Each against
    torch.autograd.grad twice through the plain version (the gradient, in
    the incoming gradient, of the plain forward's gradient), float32, 1e-5
    of the largest element. Library yardstick for K2: the depthwise
    convolution that computes the same blur; none computes K1's in one call."""
    import torch.nn.functional as F

    from e4s2024_torch.ops import fused_act, upfirdn

    def twice(plain, x, gg, *rest):
        xr = x.detach().requires_grad_(True)
        y = plain(xr, *rest)
        g = torch.ones_like(y).requires_grad_(True)  # the gradient is linear in g
        (gx,) = torch.autograd.grad(y, xr, g, create_graph=True)
        return torch.autograd.grad(gx, g, gg)[0]

    shape = (2, 32, 1024, 1024)
    x, b, gg = randn(*shape), randn(32), randn(*shape)
    out = fused_act.fused_leaky_relu_plain(x, b)
    records = [_case_record(
        torch, "fused_leaky_relu_double_backward", DOUBLE_BACKWARD_CASES[0][1],
        lambda: fused_act.fused_leaky_relu_double_backward(gg, out),
        lambda: fused_act.fused_leaky_relu_backward_plain(gg, out),
        lambda: twice(fused_act.fused_leaky_relu_plain, x, gg, b),
        None, 3 * out.numel() * 4, 2 * out.numel(), 1e-5, 1e-5,
        symbol="fused_leaky_relu_backward_kernel")]
    del out, b

    k, pad = upfirdn.make_kernel([1, 3, 3, 1]), (2, 2)
    w = torch.flip(k, (0, 1)).cuda().expand(shape[1], 1, 4, 4)
    out_elems = shape[0] * shape[1] * upfirdn.out_size(shape[2], 4, 1, 1, pad) ** 2
    records.append(_case_record(
        torch, "upfirdn2d_double_backward", DOUBLE_BACKWARD_CASES[1][1],
        lambda: upfirdn.upfirdn2d_double_backward(gg, k, 1, 1, pad),
        lambda: upfirdn.upfirdn2d_plain(gg, k, 1, 1, pad),
        lambda: twice(lambda t: upfirdn.upfirdn2d_plain(t, k, 1, 1, pad), x, gg),
        lambda: F.conv2d(gg, w, padding=2, groups=shape[1]),
        (x.numel() + out_elems) * 4, 2 * 16 * out_elems, 1e-5, 1e-5,
        symbol="upfirdn2d_kernel", library_err=True))
    del x, gg
    torch.cuda.empty_cache()
    return records


def _r1_check(torch):
    """R1 of a Discriminator at 256^2 (channel multiplier 2, B=4, seeded
    default weights) and its gradient in every parameter, through the
    kernels (K1 and K2 forward, backward and double backward) against the
    same with the plain versions on the card, cuDNN's deterministic
    algorithms on both sides. R1 within 1e-4 relative. The gradients of the
    ResBlocks' biases are sums of ~1e-9 that cancel (they reach R1 only
    through the minibatch stddev), so in float32 both runs sit up to 5e-3 of
    their largest element from the float64 gradient: each float32 gradient
    is held against the plain versions' float64 run, the kernels' no
    further from it (in norm) than twice the plain float32 run's plus 1e-4
    of its norm."""
    from e4s2024_torch import kernels
    from e4s2024_torch.losses.losses import r1_penalty
    from e4s2024_torch.models.stylegan2 import Discriminator

    torch.manual_seed(SEED)
    disc = Discriminator(256, 2).cuda()
    rng = np.random.default_rng(SEED + 9)
    coarse = rng.random((4, 3, 16, 16)) * 2 - 1
    x = torch.from_numpy(np.kron(coarse, np.ones((1, 1, 16, 16))).astype(np.float32)).cuda()

    def run(d, xx):
        params = list(d.parameters())
        r1 = r1_penalty(d, xx)
        grads = torch.autograd.grad(r1, params, allow_unused=True)
        # the last bias does not reach the input gradient
        return [r1.detach()] + [torch.zeros_like(p) if g is None else g
                                for p, g in zip(params, grads)]

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        kernels.reset_launch_counts()
        got = run(disc, x)
        launches = kernels.launch_counts()
        with kernels.plain_versions_on_card():
            want = run(disc, x)
            d64 = Discriminator(256, 2).cuda().double()
            d64.load_state_dict(disc.state_dict())
            truth = [t.float() for t in run(d64, x.double())]
            del d64
        ms = time_ms(torch, lambda: run(disc, x), iters=5, warmup=1)
        with kernels.plain_versions_on_card():
            plain_ms = time_ms(torch, lambda: run(disc, x), iters=2, warmup=0)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    r1_rel = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
    names = ["r1"] + [n for n, _ in disc.named_parameters()]
    worst, failed, far = 0.0, [], {"kernels": 0.0, "plain": 0.0}
    for name, g, w, t in zip(names[1:], got[1:], want[1:], truth[1:]):
        scale = float(w.abs().max()) or 1.0
        worst = max(worst, float((g - w).abs().max()) / scale)
        err_k, err_p, norm = float((g - t).norm()), float((w - t).norm()), float(t.norm())
        far = {"kernels": max(far["kernels"], err_k / (norm or 1.0)),
               "plain": max(far["plain"], err_p / (norm or 1.0))}
        if err_k > 2 * err_p + 1e-4 * norm:
            failed.append((name, err_k, err_p))
    rec = {"name": "R1 and its parameter gradient", "case": "Discriminator 256^2, B=4",
           "r1": float(got[0]), "r1_plain": float(want[0]), "r1_float64": float(truth[0]),
           "r1_rel": r1_rel, "grad_vs_plain_max_rel_to_largest": worst,
           "grad_norm_rel_to_float64_worst": far,
           "grads_further_from_float64_than_allowed": failed, "ms": ms, "plain_ms": plain_ms,
           "launches": launches}
    log(f"[kernels] {json.dumps(rec)}")
    if r1_rel > 1e-4 or failed or not np.isfinite(float(got[0])) \
            or any(launches[n] == 0 for n in DOUBLE_BACKWARD):
        raise AssertionError(f"R1 through the kernels disagrees with the plain versions: {rec}")
    del disc, got, want, truth
    torch.cuda.empty_cache()


def _swin_block_weights(torch, randn, c, heads, hidden, dtype):
    """Random weights of one SwinIR-M block in the layouts K5 takes."""
    from e4s2024_torch.ops import swin_block

    wts = {"ln1_scale": 1 + 0.1 * randn(c), "ln1_bias": 0.1 * randn(c),
           "ln2_scale": 1 + 0.1 * randn(c), "ln2_bias": 0.1 * randn(c),
           "bias_hnn": 0.5 * randn(heads, 64, 64),
           "qkv_w": randn(c, 3 * c) * c ** -0.5, "qkv_b": 0.1 * randn(3 * c),
           "proj_w": randn(c, c) * c ** -0.5, "proj_b": 0.1 * randn(c),
           "fc1_w": randn(c, hidden) * c ** -0.5, "fc1_b": 0.1 * randn(hidden),
           "fc2_w": randn(hidden, c) * hidden ** -0.5, "fc2_b": 0.1 * randn(c)}
    wts = {k: v if k in swin_block.F32_KEYS else v.to(dtype).contiguous()
           for k, v in wts.items()}
    wts["packed"] = swin_block.pack_block_weights(wts, heads)
    return wts


def _swin_kernel_records(torch, randn):
    """K4, K5 and K6 at SwinIR-M's shapes on a 1024^2 crop (embed 180, 6
    heads of 30, window 8, MLP 360; 16,384 windows), float32 and bfloat16,
    unshifted and shifted by 4 (the caller's roll), K5 also with the shift
    inside the kernel against roll -> plain -> roll. Each is held against its
    plain version in the same dtype: float32 differs in summation order and
    by 3xTF32's error (about 2^-21 of sum |a||b| per product, 2e-6 at
    K = 360: well inside the same bounds); in bfloat16 the order can flip the
    rounding of an intermediate by one ulp (2^-8), which the later steps
    carry on (one attention: 2^-7 of the largest output; a whole block:
    2^-5). Library yardstick for K4 and K6:
    F.scaled_dot_product_attention on partitioned q, k, v with the bias and
    the shift mask as a float attn_mask (made outside the timing); none for
    K5."""
    import torch.nn.functional as F

    from e4s2024_torch.models.swinir import shift_labels
    from e4s2024_torch.ops import swin_block
    from e4s2024_torch.ops import window_attention as wa

    size, c, heads, ws, hidden = 1024, 180, 6, 8, 360
    n, tokens = ws * ws, size * size
    labels3 = torch.from_numpy(shift_labels(size, size, ws, ws // 2).astype(np.int32).reshape(
        size // ws, size // ws, n)).cuda()
    bias = 0.5 * randn(heads, n, n)
    records = []
    for dtype in (torch.float32, torch.bfloat16):
        es = 4 if dtype == torch.float32 else 2
        rate = TF32X3_OPS_PER_S if dtype == torch.float32 else BF16_OPS_PER_S
        dname = str(dtype).replace("torch.", "")
        att_tol = (1e-5, 1e-6) if dtype == torch.float32 else (2.0 ** -7, 1e-6)
        blk_tol = (1e-4, 1e-5) if dtype == torch.float32 else (2.0 ** -5, 1e-6)
        for shift in (0, 4):
            lab3 = labels3 if shift else None
            lab_bytes = 0 if lab3 is None else lab3.numel() * 4
            qkv = randn(1, size, size, 3 * c, dtype=dtype)
            q, k, v = wa.partition_qkv(qkv, ws, heads)
            lab2 = None if lab3 is None else wa.tile_labels(lab3, 1)
            mask = bias[None]
            if lab2 is not None:
                neq = lab2[:, :, None] != lab2[:, None, :]
                mask = mask + torch.where(neq, -100.0, 0.0)[:, None]
            mask = mask.to(dtype)
            att_bytes = (qkv.numel() + tokens * c) * es + bias.numel() * 4 + lab_bytes
            att_ops = 4 * n * c * tokens
            records.append(_case_record(
                torch, "swin_attention_nhwc", f"SwinIR-M qkv at 1024^2, shift {shift}",
                lambda: wa.swin_attention_nhwc(qkv, bias, lab3, window=ws, heads=heads),
                lambda: wa.swin_attention_nhwc_plain(qkv, bias, lab3, window=ws, heads=heads),
                lambda: wa.swin_attention_nhwc_plain(qkv, bias, lab3, window=ws, heads=heads),
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
                att_bytes, att_ops, *att_tol, ops_rate=rate, iters=10,
                previous_ms=PREVIOUS_MS["swin_attention_nhwc", dname, shift]))
            records.append(_case_record(
                torch, "fused_window_attention", f"SwinIR-M windows at 1024^2, shift {shift}",
                lambda: wa.fused_window_attention(q, k, v, bias, lab2),
                lambda: wa.window_attention_plain(q, k, v, bias, lab2),
                lambda: wa.window_attention_plain(q, k, v, bias, lab2),
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
                att_bytes, att_ops, *att_tol, ops_rate=rate, iters=10,
                previous_ms=PREVIOUS_MS["fused_window_attention", dname, shift]))
            del qkv, q, k, v, mask

            x = randn(1, size, size, c, dtype=dtype)
            wts = _swin_block_weights(torch, randn, c, heads, hidden, dtype)
            wt_bytes = sum(wts[k].numel() * wts[k].element_size() for k in swin_block.ORDER)
            blk_bytes = 2 * x.numel() * es + wt_bytes + lab_bytes
            blk_ops = (2 * (4 * c * c + 2 * c * hidden) + 4 * n * c) * tokens
            records.append(_case_record(
                torch, "fused_swin_block", f"SwinIR-M block at 1024^2, shift {shift}",
                lambda: swin_block.fused_swin_block(x, wts, lab3, window=ws, heads=heads),
                lambda: swin_block.fused_swin_block_plain(x, wts, lab3, window=ws, heads=heads),
                lambda: swin_block.fused_swin_block_plain(x, wts, lab3, window=ws, heads=heads),
                None, blk_bytes, blk_ops, *blk_tol, ops_rate=rate, iters=5,
                previous_ms=PREVIOUS_MS["fused_swin_block", dname, shift]))
            if shift:
                # the same block with the roll in the kernel's addressing,
                # against roll -> plain -> roll
                def plain_rolled():
                    return swin_block.fused_swin_block_plain(x, wts, lab3, window=ws,
                                                             heads=heads, shift=shift)

                records.append(_case_record(
                    torch, "fused_swin_block",
                    f"SwinIR-M block at 1024^2, shift {shift} inside the kernel",
                    lambda: swin_block.fused_swin_block(x, wts, lab3, window=ws, heads=heads,
                                                        shift=shift),
                    plain_rolled, plain_rolled, None, blk_bytes, blk_ops, *blk_tol,
                    ops_rate=rate, iters=5))
            del x
            torch.cuda.empty_cache()

    # K6 at B = 2: two crops' windows in one call, shifted
    q, k, v = (randn(2 * (size // ws) ** 2, heads, n, c // heads) for _ in range(3))
    lab2 = wa.tile_labels(labels3, 2)
    records.append(_case_record(
        torch, "fused_window_attention", "SwinIR-M windows of 2 crops at 1024^2, shift 4",
        lambda: wa.fused_window_attention(q, k, v, bias, lab2),
        lambda: wa.window_attention_plain(q, k, v, bias, lab2),
        lambda: wa.window_attention_plain(q, k, v, bias, lab2), None,
        (4 * q.numel()) * 4 + bias.numel() * 4 + lab2.numel() * 4,
        4 * n * c * 2 * tokens, 1e-5, 1e-6, ops_rate=TF32X3_OPS_PER_S, iters=10))
    del q, k, v
    torch.cuda.empty_cache()
    return records


def _rdb_kernel_records(torch, randn):
    """K7 at RRDBNet's shapes in the zoo (B=8 Blender outputs of 256^2): one
    case per shape class, conv1 (64 -> 32) and conv4 (160 -> 32) into the
    dense buffer with bias + LeakyReLU, conv5 (192 -> 64) with the block's
    residual, one whole residual dense block (5 launches) and conv_up2
    (64 -> 64, 512^2 -> 1024^2 through the x2 fold). Each is held against a
    float64 `F.conv2d` of the same float32 inputs: within 1e-5 of the
    largest output, and within twice cuDNN float32's own error there
    (`library_max_abs_err`; the library call is cuDNN float32 after a
    `torch.cat` of the block's pieces, as the plain module runs it). The
    bound is the 3xTF32 rate; `plain_ms` is `rdb_conv_plain` (cuDNN on NHWC
    slices)."""
    import torch.nn.functional as F

    from e4s2024_torch import kernels
    from e4s2024_torch.models.rrdb import RRDBNet, dense_block
    from e4s2024_torch.ops import rdb_conv as rc
    from e4s2024_torch.ops.resize import resize_nearest

    b, size, nf, ng = 8, 256, 64, 32
    width = nf + 4 * ng
    pixels = b * size * size
    buf = randn(b, size, size, width)
    nxt = torch.empty_like(buf)
    records = []

    def pieces(cin):
        """buf's channels [0, cin) as the plain module holds them: x and
        each conv's growth, NCHW."""
        cuts = [(0, nf)] + [(c, c + ng) for c in range(nf, cin, ng)]
        return [buf[..., a:z].permute(0, 3, 1, 2).contiguous() for a, z in cuts]

    def weights(cin, n):
        return (randn(n, cin, 3, 3) * (9 * cin) ** -0.5).contiguous(), 0.1 * randn(n)

    def f64_conv(xin, w, bias):
        return F.conv2d(xin.double(), w.double(), bias.double(), padding=1)

    def check(rec):
        lib = rec["library_max_abs_err"]
        rec["within_2x_library"] = rec["max_abs_err"] <= 2 * lib
        rec["ok"] = rec["ok"] and rec["within_2x_library"]
        log(f"[kernels] K7 {rec['case']}: max |err| {rec['max_abs_err']:.3e} against float64, "
            f"cuDNN float32 {lib:.3e}; {rec['ms']:.4f} ms, bound {rec['bound_ms']:.4f}")
        return rec

    for cin in (64, 160):
        w, bias = weights(cin, ng)
        packed = rc.pack_weights(w)
        parts = pieces(cin)
        whole = torch.cat(parts, 1)
        records.append(check(_case_record(
            torch, "rdb_conv", f"conv{1 + (cin - nf) // ng} {cin} -> {ng}, B={b} at {size}^2",
            lambda: rc.rdb_conv(buf, w, bias, buf, cin, packed=packed,
                                act=True)[..., cin:cin + ng],
            lambda: rc.rdb_conv_plain(buf, w, bias, buf, cin, act=True)[..., cin:cin + ng],
            lambda: F.leaky_relu(f64_conv(whole, w, bias), 0.2).permute(0, 2, 3, 1),
            lambda: F.leaky_relu(F.conv2d(torch.cat(parts, 1), w, bias, padding=1), 0.2)
            .permute(0, 2, 3, 1),
            (cin + ng) * 4 * pixels, 2 * 9 * cin * ng * pixels, 1e-5, 0.0,
            ops_rate=TF32X3_OPS_PER_S, iters=10, symbol="rdb_conv_kernel", library_err=True)))
        del parts, whole

    w, bias = weights(width, nf)
    packed = rc.pack_weights(w)
    parts = pieces(width)
    whole = torch.cat(parts, 1)
    records.append(check(_case_record(
        torch, "rdb_conv", f"conv5 {width} -> {nf} + 0.2 residual, B={b} at {size}^2",
        lambda: rc.rdb_conv(buf, w, bias, nxt, 0, packed=packed, res1=buf, s1=0.2)[..., :nf],
        lambda: rc.rdb_conv_plain(buf, w, bias, nxt, 0, res1=buf, s1=0.2)[..., :nf],
        lambda: (parts[0].double() + 0.2 * f64_conv(whole, w, bias)).permute(0, 2, 3, 1),
        lambda: (parts[0] + 0.2 * F.conv2d(torch.cat(parts, 1), w, bias, padding=1))
        .permute(0, 2, 3, 1),
        (width + 3 * nf) * 4 * pixels, 2 * 9 * width * nf * pixels, 1e-5, 0.0,
        ops_rate=TF32X3_OPS_PER_S, iters=10, symbol="rdb_conv_kernel", library_err=True)))
    del parts, whole

    # one whole block (buf's first 64 channels its input), the plain module
    # on NCHW beside it
    torch.manual_seed(SEED)
    rdb = RRDBNet(nf, 1, ng).cuda().eval().requires_grad_(False).body[0].rdb1
    rdb64 = RRDBNet(nf, 1, ng).cuda().double().eval().requires_grad_(False).body[0].rdb1
    rdb64.load_state_dict(rdb.state_dict())
    packs = {m: rc.pack_weights(m.weight) for m in rdb.modules()
             if isinstance(m, torch.nn.Conv2d)}
    x_nchw = buf[..., :nf].permute(0, 3, 1, 2).contiguous()

    def block(plain: bool):
        with kernels.plain_versions_on_card() if plain else contextlib.nullcontext():
            dense_block(rdb, buf, nxt, packs)
        return nxt[..., :nf]

    reads = nf + 96 + 128 + 160 + width + nf   # conv1-5 and the residual
    with torch.inference_mode():
        records.append(check(_case_record(
            torch, "rdb_conv", f"whole residual dense block (5 launches), B={b} at {size}^2",
            lambda: block(False), lambda: block(True),
            lambda: rdb64(x_nchw.double()).permute(0, 2, 3, 1),
            lambda: rdb(x_nchw).permute(0, 2, 3, 1),
            (reads + 4 * ng + nf) * 4 * pixels,
            2 * 9 * (ng * (nf + 96 + 128 + 160) + nf * width) * pixels, 1e-5, 0.0,
            ops_rate=TF32X3_OPS_PER_S, iters=10, library_err=True)))
    del buf, nxt, x_nchw, rdb, rdb64
    torch.cuda.empty_cache()

    # the tail's conv_up2: 512^2 -> 1024^2 through the x2 fold
    up = randn(b, 512, 512, nf)
    out = torch.empty(b, 1024, 1024, nf, device="cuda")
    up_nchw = up.permute(0, 3, 1, 2)
    up_big = up_nchw.repeat_interleave(2, 2).repeat_interleave(2, 3)
    w, bias = weights(nf, nf)
    packed = rc.pack_weights(w)
    records.append(check(_case_record(
        torch, "rdb_conv", f"conv_up2 {nf} -> {nf} with the x2 fold, B={b} 512^2 -> 1024^2",
        lambda: rc.rdb_conv(up, w, bias, out, 0, packed=packed, fold=2, act=True),
        lambda: rc.rdb_conv_plain(up, w, bias, out, 0, fold=2, act=True),
        lambda: F.leaky_relu(f64_conv(up_big, w, bias), 0.2).permute(0, 2, 3, 1),
        lambda: F.leaky_relu(F.conv2d(resize_nearest(up_nchw, (1024, 1024)), w, bias,
                                      padding=1), 0.2).permute(0, 2, 3, 1),
        (up.numel() + out.numel()) * 4, 2 * 9 * nf * out.numel(), 1e-5, 0.0,
        ops_rate=TF32X3_OPS_PER_S, iters=5, symbol="rdb_conv_kernel", library_err=True)))
    del up, out, up_nchw, up_big
    torch.cuda.empty_cache()
    return records


def _random_state_dicts(torch):
    from e4s2024_torch.models.bisenet import BiSeNet
    from e4s2024_torch.models.rgi import RGINet

    torch.manual_seed(SEED)
    return RGINet().state_dict(), BiSeNet().state_dict()


def _inputs(size: int):
    rng = np.random.default_rng(SEED)
    # smooth random images: a coarse grid upsampled, plus a little noise
    coarse = rng.random((2, 16, 16, 3))
    img = np.kron(coarse, np.ones((1, size // 16, size // 16, 1))) * 200
    img += rng.random(img.shape) * 55
    return img[:1].astype(np.uint8), img[1:].astype(np.uint8)


def phase_swap(torch, rgi_sd, bise_sd, compute_dtype: str):
    """Swaps at the default configuration in both regional modes. Returns
    per-mode latency, peak memory, launches and the comparison with the
    plain versions."""
    from e4s2024_torch import kernels
    from e4s2024_torch.pipelines.swap import FaceSwapper, SwapConfig

    results = {}
    for mode in ("exact", "fast"):
        cfg = SwapConfig(regional_mode=mode, compute_dtype=compute_dtype)
        swapper = FaceSwapper(rgi_sd, bise_sd, cfg, device="cuda")
        driven, target = _inputs(cfg.out_size)
        swapper.swap_aligned(driven, target)  # warm-up: cuDNN plans, allocator
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        kernels.reset_launch_counts()
        latencies, out = [], None
        for _ in range(REQUESTS):
            t0 = time.perf_counter()
            out = swapper.swap_aligned(driven, target)
            torch.cuda.synchronize()
            latencies.append((time.perf_counter() - t0) * 1e3)
        launches = kernels.launch_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

        want = dict.fromkeys(launches, 0)
        want.update({k: REQUESTS * v for k, v in PER_CALL[mode].items()})
        if launches != want:
            raise AssertionError(f"{compute_dtype} {mode}: launches {launches}, expected {want}")
        image = out["image"]
        if (image.shape != (1, cfg.out_size, cfg.out_size, 3) or image.dtype != torch.uint8
                or out["swapped_mask"].shape != (1, 512, 512)
                or out["swapped_style_vectors"].shape != (1, 12, 1280)
                or not bool(torch.isfinite(out["swapped_style_vectors"]).all())):
            raise AssertionError(f"{compute_dtype} {mode}: bad output "
                                 f"{ {k: tuple(v.shape) for k, v in out.items()} }")

        # the generator's image itself must be finite (before uint8)
        finite = []
        hook = swapper.rgi.G.register_forward_hook(
            lambda m, i, o: finite.append(bool(torch.isfinite(o[0]).all())))
        with kernels.plain_versions_on_card():
            plain = swapper.swap_aligned(driven, target)
        swapper.swap_aligned(driven, target)
        hook.remove()
        if not all(finite):
            raise AssertionError(f"{compute_dtype} {mode}: non-finite generator output")
        masks_equal = bool(torch.equal(plain["swapped_mask"], out["swapped_mask"])
                           and torch.equal(plain["hole_mask"], out["hole_mask"]))
        diff = (plain["image"].int() - image.int()).abs()
        # float32: the kernels and the plain versions differ in summation
        # order only, so the uint8 images agree within 2 levels; bfloat16
        # rounds at other places in the two, so only a gross fault is caught
        limit = (2, 0.05) if compute_dtype == "float32" else (255, 4.0)
        rec = {
            "dtype": compute_dtype, "mode": mode, "requests": REQUESTS,
            "latency_ms": latencies, "peak_mem_gib": peak_gib, "launches": launches,
            "vs_plain_max_abs": int(diff.max()), "vs_plain_mean_abs": float(diff.float().mean()),
            "masks_equal": masks_equal,
            "tolerance_max_abs": limit[0], "tolerance_mean_abs": limit[1],
            "mask_classes": int(torch.unique(out["swapped_mask"]).numel()),
        }
        log(f"[swap] {json.dumps(rec)}")
        if not masks_equal or rec["vs_plain_max_abs"] > limit[0] \
                or rec["vs_plain_mean_abs"] > limit[1]:
            raise AssertionError(f"{compute_dtype} {mode}: swap through the kernels differs "
                                 f"from the plain versions beyond {limit}: {rec}")
        results[mode] = rec
        del swapper, out, plain
        torch.cuda.empty_cache()
    return results


def _swinir_state_dict(torch):
    """SwinIR-M weights from a seed, drawn so that each layer keeps its
    input's scale (He-normal convolutions, unit-gain linear layers; PyTorch's
    default draws shrink the signal at every layer and leave the x4 output
    flat at the RGB mean), with conv_last scaled by 0.1 so that the x4 image
    stays mostly inside [0, 1]."""
    from e4s2024_torch.models.swinir import SwinIR

    torch.manual_seed(SEED + 1)
    sd = SwinIR().state_dict()
    for key, v in sd.items():
        if key.endswith(".weight") and v.ndim == 4:
            v.normal_(0.0, (2.0 / v[0].numel()) ** 0.5 * (0.1 if key == "conv_last.weight" else 1.0))
        elif key.endswith(".weight") and v.ndim == 2:
            v.normal_(0.0, v.shape[1] ** -0.5)
    return sd


def phase_enhance(torch, rgi_sd, bise_sd, sr_sd, compute_dtype: str):
    """The SwinIR-enhanced swap at the default configuration (B=1, 1024^2).
    Returns latency, peak memory, launches and, in float32, the comparisons
    with the plain versions and the launches of each upscaler route."""
    from e4s2024_torch import kernels
    from e4s2024_torch.models.swinir import SwinIREnhancer, SwinIRUpscaler
    from e4s2024_torch.pipelines.full_swap import (
        FullFaceSwapPipeline, FullSwapConfig, SwapComponents)
    from e4s2024_torch.pipelines.swap import FaceSwapper, SwapConfig

    cfg = SwapConfig(compute_dtype=compute_dtype)
    swapper = FaceSwapper(rgi_sd, bise_sd, cfg, device="cuda")
    up = SwinIRUpscaler(sr_sd, compute_dtype=compute_dtype, device="cuda")
    pipe = FullFaceSwapPipeline(
        swapper, SwapComponents(enhancers={"swinir": SwinIREnhancer(up).enhance_aligned}),
        FullSwapConfig(enhancement_mode="swinir"))
    driven, target = _inputs(cfg.out_size)
    src, tgt = driven[0], target[0]
    pipe(src, tgt)  # warm-up: cuDNN plans, allocator, cached labels and weights
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the fused route shifts inside K5: count every torch.roll of the run
    rolls, roll = [], torch.roll

    def counted_roll(*args, **kwargs):
        rolls.append(1)
        return roll(*args, **kwargs)

    kernels.reset_launch_counts()
    latencies, out = [], None
    torch.roll = counted_roll
    try:
        for _ in range(ENHANCE_REQUESTS):
            t0 = time.perf_counter()
            out = pipe(src, tgt, return_intermediates=True)
            torch.cuda.synchronize()
            latencies.append((time.perf_counter() - t0) * 1e3)
    finally:
        torch.roll = roll
    launches = kernels.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if rolls:
        raise AssertionError(f"enhance {compute_dtype}: the fused route ran {len(rolls)} "
                             f"torch.roll calls; K5 shifts in its addressing")

    want = dict.fromkeys(launches, 0)
    want.update({k: ENHANCE_REQUESTS * v for k, v in PER_CALL["exact"].items()})
    want["fused_swin_block"] = ENHANCE_REQUESTS * SWIN_BLOCKS
    if launches != want:
        raise AssertionError(f"enhance {compute_dtype}: launches {launches}, expected {want}")
    size = cfg.out_size
    if (out["image"].shape != (size, size, 3) or out["image"].dtype != torch.uint8
            or out["driven"].shape != (size, size, 3)
            or out["swapped_mask"].shape != (512, 512)):
        raise AssertionError(f"enhance {compute_dtype}: bad output "
                             f"{ {k: tuple(v.shape) for k, v in out.items()} }")
    x01 = torch.from_numpy(src).cuda().float()[None] / 255.0
    enhanced = up.forward(x01)
    if enhanced.shape != (1, 4 * size, 4 * size, 3) or not bool(torch.isfinite(enhanced).all()):
        raise AssertionError(f"enhance {compute_dtype}: bad upscaler output "
                             f"{tuple(enhanced.shape)}")
    rec = {"dtype": compute_dtype, "requests": ENHANCE_REQUESTS, "latency_ms": latencies,
           "peak_mem_gib": peak_gib, "launches": launches, "torch_roll_calls": len(rolls),
           "driven_changed_share": float((out["driven"] != torch.from_numpy(src).cuda())
                                         .float().mean()),
           "unclipped_min": float(enhanced.min()), "unclipped_max": float(enhanced.max())}
    if compute_dtype == "float32":
        rec.update(_enhance_vs_plain(torch, kernels, pipe, up, src, tgt, out, x01))
    log(f"[enhance] {json.dumps(rec)}")
    del swapper, up, pipe, out, enhanced
    torch.cuda.empty_cache()
    return rec


def _enhance_vs_plain(torch, kernels, pipe, up, src, tgt, out, x01):
    """The whole enhanced swap and the upscaler's unclipped output in each
    route, kernels against plain versions on the card (float32)."""
    with kernels.plain_versions_on_card():
        plain = pipe(src, tgt, return_intermediates=True)
    driven_diff = int((plain["driven"].int() - out["driven"].int()).abs().max())
    mask_share = float((plain["swapped_mask"] != out["swapped_mask"]).float().mean())
    img = (plain["image"].int() - out["image"].int()).abs()
    # the float enhanced crop is truncated to uint8; where kernel and plain
    # straddle an integer the driven crops differ by one level, which may
    # flip BiSeNet's argmax at a near-tie; the image, float32 on both sides,
    # then moves only where the masks or style vectors moved
    limits = {"driven_max": 1, "mask_share": 1e-3, "image_mean": 0.5, "route_rel": 1e-3}
    res = {"vs_plain_driven_max_abs": driven_diff, "vs_plain_mask_share": mask_share,
           "vs_plain_image_max_abs": int(img.max()),
           "vs_plain_image_mean_abs": float(img.float().mean()), "limits": limits,
           "routes": {}}
    ok = (driven_diff <= limits["driven_max"] and mask_share <= limits["mask_share"]
          and res["vs_plain_image_mean_abs"] <= limits["image_mean"])
    # the unclipped x4 output of the same crop through each route, against
    # the spread of the plain output around its mean, so that neither clipping
    # nor the added RGB mean can hide a mismatch (float32 summation order
    # through 36 blocks and 11 convolutions)
    for route, kernel in ROUTE_KERNEL.items():
        up.fused, up.model.use_kernel = route == "fused", route == "nhwc"
        up.forward(x01)  # warm-up of this route
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        got = up.forward(x01)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = kernels.launch_counts()
        with kernels.plain_versions_on_card():
            ref = up.forward(x01)
        rel = float((got - ref).abs().max() / (ref - ref.mean()).abs().max())
        want = dict.fromkeys(launches, 0)
        want[kernel] = SWIN_BLOCKS
        res["routes"][route] = {"launches": launches, "upscaler_ms": ms, "vs_plain_rel": rel}
        ok = ok and launches == want and rel <= limits["route_rel"] \
            and bool(torch.isfinite(got).all())
        del got, ref
    up.fused, up.model.use_kernel = True, False
    if not ok:
        raise AssertionError(f"enhanced swap through the kernels differs from the plain "
                             f"versions beyond {limits}: {res}")
    return res


def _outside_quad(torch, swapper, lm, shape, quad=None):
    """(H, W) bool of the target pixels the paste-back of the face with
    landmarks `lm` (or of `quad`) leaves alone (its warped alpha is 0)."""
    from e4s2024_torch.pipelines.alignment import (
        as_f32, compute_transform_from_landmarks, paste_back_coefficients, quad_from_cxy,
        warp_perspective)

    s = swapper.cfg.out_size
    if quad is None:
        quad = quad_from_cxy(*compute_transform_from_landmarks(lm))
    alpha = warp_perspective(torch.ones(s, s, 1, device="cuda"),
                             as_f32(paste_back_coefficients(quad, s), "cuda"), shape[:2])
    return (alpha[..., 0] == 0).cpu().numpy()


def _raw_call(torch, kernels, label, fn, per_call, target, tol, outside=None,
              requests=1):
    """Run a raw-frame entry `requests` times after a warm-up with the launch
    counts set to 0 before and read after; check them against `per_call`,
    then hold the frame against the same call with the plain versions on the
    card and, where `outside` is given, the untouched pixels against the
    target. Returns the call's record."""
    fn()  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    latencies, out = [], None
    for _ in range(requests):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
    launches = kernels.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    want = dict.fromkeys(launches, 0)
    want.update({k: requests * v for k, v in per_call.items()})
    if launches != want:
        raise AssertionError(f"raw {label}: launches {launches}, expected {want}")
    if out.shape != target.shape or out.dtype != np.uint8:
        raise AssertionError(f"raw {label}: bad output {out.shape} {out.dtype}")
    with kernels.plain_versions_on_card():
        plain = fn()
    diff = np.abs(plain.astype(np.int16) - out.astype(np.int16))
    rec = {"call": label, "requests": requests, "latency_ms": latencies,
           "peak_mem_gib": peak_gib, "launches": launches,
           "launches_per_call": {k: v // requests for k, v in launches.items() if v},
           "vs_plain_max_abs": int(diff.max()), "vs_plain_mean_abs": float(diff.mean()),
           "tolerance_max_abs": tol[0], "tolerance_mean_abs": tol[1],
           "changed_share": float((out != target).any(-1).mean())}
    ok = rec["vs_plain_max_abs"] <= tol[0] and rec["vs_plain_mean_abs"] <= tol[1] \
        and rec["changed_share"] > 0
    if outside is not None:
        rec["outside_quad_pixels"] = int(outside.sum())
        rec["outside_quad_equal"] = bool(np.array_equal(out[outside], target[outside]))
        # (a quad from random landmarks may cover the whole frame: the count
        # is logged)
        ok = ok and rec["outside_quad_equal"]
    log(f"[raw] {json.dumps(rec)}")
    if not ok:
        raise AssertionError(f"raw {label}: failed its checks: {rec}")
    return rec


def phase_raw(torch, rgi_sd, bise_sd, sr_sd):
    """The raw-frame swap at the default stack, float32. Returns the
    records of its calls."""
    import warnings

    from e4s2024_torch import kernels
    from e4s2024_torch.models.swinir import SwinIREnhancer, SwinIRUpscaler
    from e4s2024_torch.pipelines.detect import default_landmarker
    from e4s2024_torch.pipelines.full_swap import (
        FullFaceSwapPipeline, FullSwapConfig, SwapComponents)
    from e4s2024_torch.pipelines.swap import FaceSwapper, SwapConfig
    from e4s2024_torch.profile_swap import raw_frames

    src, tgt = raw_frames()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        landmarker = default_landmarker(device="cuda")
    log(f"[raw] landmark stack built in {time.perf_counter() - t0:.1f} s; weights: "
        + ("; ".join(str(w.message) for w in caught) or "reference checkpoints"))

    # the landmarks: the detection stack holds no kernel, so the plain
    # versions must leave them bit for bit as they are
    lms = [landmarker(src), landmarker(tgt)]
    with kernels.plain_versions_on_card():
        plain_lms = [landmarker(src), landmarker(tgt)]
    if any(a is None for a in lms) or not all(np.array_equal(a, b)
                                              for a, b in zip(lms, plain_lms)):
        raise AssertionError("raw: the landmarks differ with the plain versions on the card")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    landmarker(tgt)
    log(f"[raw] landmarks of the target frame: {(time.perf_counter() - t0) * 1e3:.2f} ms "
        f"(detect + FAN, host clock)")

    records, swapper = {}, None
    for mode in ("exact", "fast"):
        swapper = FaceSwapper(rgi_sd, bise_sd, SwapConfig(regional_mode=mode),
                              landmark_fn=landmarker, device="cuda")
        outside = _outside_quad(torch, swapper, lms[1], tgt.shape)
        records[f"swap {mode}"] = _raw_call(
            torch, kernels, f"swap {mode}", lambda: swapper.swap(src, tgt), PER_CALL[mode],
            tgt, (2, 0.05), outside, REQUESTS)
        if mode == "exact":
            # swap_all: how many faces went through the batched swap
            sizes, swap_crops = [], swapper._swap_crops

            def counted(s, t, fn):
                sizes.append(t.shape[0])
                return swap_crops(s, t, fn)

            swapper._swap_crops = counted
            rec = _raw_call(torch, kernels, "swap_all exact",
                            lambda: swapper.swap_all(src, tgt), PER_CALL[mode], tgt, (2, 0.05))
            del swapper._swap_crops
            if not sizes or min(sizes) < 1:
                raise AssertionError(f"raw swap_all: no face was swapped ({sizes})")
            rec["faces_swapped"] = sizes[-1]
            log(f"[raw] swap_all swapped {sizes[-1]} face(s)")
            records["swap_all exact"] = rec

            up = SwinIRUpscaler(sr_sd, device="cuda")
            pipe = FullFaceSwapPipeline(
                swapper, SwapComponents(enhancers={"swinir": SwinIREnhancer(up).enhance_aligned}),
                FullSwapConfig(enhancement_mode="swinir"))
            per_call = dict(PER_CALL["exact"], fused_swin_block=SWIN_BLOCKS)
            # the enhanced swap's phase-4 tolerance: the float enhanced crop
            # is truncated to uint8, so a one-level straddle may flip a parse
            # pixel; the image mean stays within 0.5 levels
            records["swap_raw exact"] = _raw_call(
                torch, kernels, "swap_raw exact", lambda: pipe.swap_raw(src, tgt), per_call,
                tgt, (255, 0.5), outside)
            del up, pipe
        del swapper
        torch.cuda.empty_cache()
    return records


def _video_run(torch, kernels, pipe, rgi_sd, source, frames):
    """One clip through the pipeline from the weights `rgi_sd` (the pipeline
    writes its tuned weights back into the swapper), with the launch
    counts set to 0 just before and read just after. Returns (frames,
    record)."""
    from e4s2024_torch.pipelines.video import StageTimer

    pipe.swapper.rgi.load_state_dict(rgi_sd)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timer = StageTimer()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    outs = pipe(source, frames, timer=timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    hist = pipe.histories
    steps = {"pti": len(hist["pti"]), "stitching": len(hist["stitching"])}
    rec = {"clip_s": wall, "s_per_frame": wall / len(frames), "stage_ms": timer.times,
           "ms_per_pti_step": timer.times["pti_tune"] / steps["pti"],
           "ms_per_stitching_step": timer.times["stitching_tune"] / steps["stitching"],
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": launches, "losses": {k: [m["loss"] for m in v] for k, v in hist.items()}}
    return outs, rec, hist


def _clip_inputs(torch, pipe, frames):
    """The clip's aligned crops as uint8, their 12-class labels and style
    vectors, from the pipeline's stages."""
    with torch.no_grad():
        crops, _ = pipe.align_frames(frames)
        labels = pipe.parse_frames(crops)
        sv = pipe.style_vectors(crops, labels)
    return torch.clamp(torch.round(crops), 0, 255).to(torch.uint8), labels, sv


def _stitching_with_ring(torch, kernels, pipe, nets, u8, labels, sv,
                         compute_dtype="float32", limits=(1e-3, 1e-3)):
    """StitchingCoach at 1024^2 on two of the clip's crops whose labels are
    background in their outer eighth, so that the border ring is not empty
    and every step's gradient, the first included, holds the border term.
    The content targets are the generator's own synthesis, as in the
    pipeline. The kernels' run against the plain versions' from the same
    weights, the first step's loss within limits[0], the later ones' within
    limits[1]. Returns (record, problems)."""
    from e4s2024_torch.ops.morphology import dilation
    from e4s2024_torch.training.pti import StitchingCoach, StitchingConfig

    n, cfg = 2, StitchingConfig(compute_dtype=compute_dtype)
    m = labels.shape[-1] // 8
    inner = torch.zeros_like(labels[:n], dtype=torch.bool)
    inner[:, m:-m, m:-m] = True
    lab = torch.where(inner, labels[:n], torch.zeros_like(labels[:n]))
    fg = (~((lab == 0) | (lab == 4) | (lab == 11)))[:, None].float()
    ring = int((dilation(fg, 2 * cfg.outer_dilation + 1) > fg).sum())
    with torch.no_grad():
        content = pipe._gen_raw(sv[:n], lab)
    coach = StitchingCoach(pipe.swapper.rgi, nets, cfg)

    def run():
        kernels.reset_launch_counts()
        _, hist = coach.tune(None, content, u8[:n], lab.to(torch.uint8), sv[:n],
                             steps=STITCH_RING_STEPS)
        return hist, kernels.launch_counts()

    hist, launches = run()
    with kernels.plain_versions_on_card():
        phist, plain_launches = run()
    losses, plain_losses = [h["loss"] for h in hist], [h["loss"] for h in phist]
    rel = [abs(a - b) / max(abs(b), 1e-12) for a, b in zip(losses, plain_losses)]
    rec = {"frames": n, "steps": STITCH_RING_STEPS, "compute_dtype": compute_dtype,
           "ring_pixels": ring, "losses": losses, "plain_losses": plain_losses,
           "border_l2": [h["loss_border_l2"] for h in hist], "vs_plain_loss_rel": rel,
           "limits": limits, "launches": {k: launches[k] for k in ("fused_leaky_relu", "upfirdn2d",
                                                                  "regional_scale", *BACKWARD)}}
    problems = []
    if ring == 0 or not hist[0]["loss_border_l2"] > 0:
        problems.append(f"stitching check: empty border ring ({ring} pixels)")
    if not all(np.isfinite(v) for v in losses + plain_losses):
        problems.append("stitching check: non-finite losses")
    if rel[0] > limits[0] or max(rel[1:]) > limits[1]:
        problems.append(f"stitching check: losses differ from the plain versions' by {rel}")
    if any(launches[name] == 0 for name in BACKWARD) or any(plain_launches.values()):
        problems.append(f"stitching check: launches {launches}, plain run {plain_launches}")
    return rec, problems


def phase_video(torch, rgi_sd, bise_sd):
    """The video swap at the default stack, float32 exact: a warm-up clip
    (one step of each tune), the measured clip, the same clip with the
    plain versions forced on the card, a stitching run whose border ring is
    not empty against its plain-version run (`_stitching_with_ring`), then
    one PTI step at each chunk size of CHUNK_SWEEP. Returns the measured
    clip's record."""
    import warnings

    from e4s2024_torch import kernels
    from e4s2024_torch.pipelines.detect import default_landmarker
    from e4s2024_torch.pipelines.swap import FaceSwapper, SwapConfig
    from e4s2024_torch.pipelines.video import FaceSwapVideoPipeline, VideoSwapConfig
    from e4s2024_torch.profile_swap import loss_nets, video_clip
    from e4s2024_torch.training.pti import PTICoach, PTIConfig, StitchingConfig

    source, frames = video_clip()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # random landmark weights, said in phase 5
        landmarker = default_landmarker(device="cuda")
    swapper = FaceSwapper(rgi_sd, bise_sd, SwapConfig(), landmark_fn=landmarker, device="cuda")
    nets = loss_nets("cuda")

    def pipeline(pti_steps, stitching_steps):
        cfg = VideoSwapConfig(pti=PTIConfig(max_pti_steps=pti_steps),
                              stitching=StitchingConfig(max_steps=stitching_steps),
                              frames_per_batch=4)
        return FaceSwapVideoPipeline(swapper, cfg, loss_params=nets)

    t0 = time.perf_counter()
    _video_run(torch, kernels, pipeline(1, 1), rgi_sd, source, frames)  # warm-up
    log(f"[video] warm-up clip (1 PTI step, 1 stitching step): "
        f"{time.perf_counter() - t0:.1f} s")
    pipe = pipeline(VIDEO_PTI_STEPS, VIDEO_STITCHING_STEPS)
    outs, rec, hist = _video_run(torch, kernels, pipe, rgi_sd, source, frames)
    with kernels.plain_versions_on_card():
        plain, prec, phist = _video_run(torch, kernels, pipe, rgi_sd, source, frames)

    problems = []
    if len(outs) != len(frames) or any(o.shape != f.shape or o.dtype != np.uint8
                                       for o, f in zip(outs, frames)):
        problems.append(f"bad frames {[(o.shape, o.dtype) for o in outs]}")
    losses = rec["losses"]
    if not all(np.isfinite(v) for vs in losses.values() for v in vs):
        problems.append("non-finite losses")
    if not min(losses["pti"]) < losses["pti"][0]:
        problems.append("PTI's lowest loss is not below its first")
    for name in ("fused_leaky_relu", "upfirdn2d", "regional_scale"):
        if rec["launches"][name] == 0 or rec["launches"][name + "_backward"] == 0:
            problems.append(f"{name} or its backward never launched: {rec['launches']}")
    if any(prec["launches"].values()):
        problems.append(f"the plain run launched kernels: {prec['launches']}")
    # against the plain versions: the per-step total losses, frames,
    # untouched pixels. Stitching's content target is the tuned generator's
    # own synthesis, so its first gradient is only the border ring's (empty
    # where the random parse has no background): rounding noise, which
    # Adam turns into lr-sized steps of either sign; from its second step
    # on, the stitching losses of two runs are held to STITCH_LATER_REL.
    def rel_diffs(name):
        return [abs(a["loss"] - b["loss"]) / max(abs(b["loss"]), 1e-12)
                for a, b in zip(hist[name], phist[name])]

    pti_rel, stitch_rel = rel_diffs("pti"), rel_diffs("stitching")
    rel = max(pti_rel + stitch_rel[:1])
    diff = np.abs(np.stack(outs).astype(np.int16) - np.stack(plain).astype(np.int16))
    _, quads = pipe.align_frames(frames)
    outside = [_outside_quad(torch, swapper, None, f.shape, q) for f, q in zip(frames, quads)]
    outside_equal = all(np.array_equal(o[m], f[m]) for o, f, m in zip(outs, frames, outside))
    limits = {"loss_rel": 1e-3, "stitching_later_loss_rel": STITCH_LATER_REL,
              "frame_mean_abs": 0.5}
    rec.update({
        "frames": len(frames), "frame_hw": list(frames[0].shape[:2]),
        "pti_steps": VIDEO_PTI_STEPS, "stitching_steps": VIDEO_STITCHING_STEPS,
        "vs_plain_loss_max_rel": rel, "vs_plain_pti_loss_rel": pti_rel,
        "vs_plain_stitching_loss_rel": stitch_rel,
        "stitching_metrics": hist["stitching"], "vs_plain_max_abs": int(diff.max()),
        "vs_plain_mean_abs": float(diff.mean()), "limits": limits,
        "plain_clip_s": prec["clip_s"],
        "outside_quad_pixels": [int(m.sum()) for m in outside],
        "outside_quad_equal": outside_equal,
        "changed_share": float((np.stack(outs) != np.stack(frames)).any(-1).mean())})
    if (rel > limits["loss_rel"] or max(stitch_rel) > STITCH_LATER_REL
            or rec["vs_plain_mean_abs"] > limits["frame_mean_abs"]):
        problems.append("the clip differs from the plain-version clip beyond the limits")
    if not outside_equal or rec["changed_share"] == 0:
        problems.append("pixels outside the pasted quads changed, or none inside did")
    log(f"[video] {json.dumps(rec)}")
    log(f"[video] plain versions: {json.dumps(prec)}")

    u8, labels, sv = _clip_inputs(torch, pipe, frames)
    ring_rec, ring_problems = _stitching_with_ring(torch, kernels, pipe, nets, u8, labels, sv)
    problems += ring_problems
    log(f"[video] stitching with a border ring: {json.dumps(ring_rec)}")

    # one PTI step over the 8 crops at each chunk size: time and peak memory
    for chunk in CHUNK_SWEEP:
        coach = PTICoach(swapper.rgi, nets, PTIConfig(frames_per_chunk=chunk))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() / 2 ** 30
        sweep = {"frames_per_chunk": chunk, "frames": len(frames), "base_mem_gib": base}
        t0 = time.perf_counter()
        coach.tune(None, u8, labels.to(torch.uint8), sv, u8, steps=1)
        torch.cuda.synchronize()
        sweep.update(pti_step_ms=(time.perf_counter() - t0) * 1e3,
                     peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        del coach
        log(f"[video] pti step {json.dumps(sweep)}")
    del swapper, pipe, nets, labels, sv, u8
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError(f"video: {problems}")
    return rec


def _zoo_inputs(n: int, size: int = 1024):
    """n seeded smooth aligned pairs, as `_inputs` makes one."""
    rng = np.random.default_rng(SEED + 7)
    coarse = rng.random((2, n, 16, 16, 3))
    img = np.kron(coarse, np.ones((1, 1, size // 16, size // 16, 1))) * 200
    img += rng.random(img.shape) * 55
    return img[0].astype(np.uint8), img[1].astype(np.uint8)


def _zoo_call(torch, kernels, fn, requests=1):
    """fn() after a warm-up, `requests` times, the launch counts set to 0
    before and read after. Returns (last output, ms per call, launches,
    peak GiB)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    ms, out = [], None
    for _ in range(requests):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return out, ms, kernels.launch_counts(), torch.cuda.max_memory_allocated() / 2 ** 30


def phase_zoo(torch, rgi_sd, bise_sd):
    """The zoo-enhanced swap at the reference's default FullSwapConfig with
    face_inpainting on: GPEN-512, the phase-3 float32 exact swapper, the
    Blender recolor with RealESRGAN x4 and the edge-aware blend, GCFSR
    inpainting (`profile_swap.zoo_components`, seeded random weights), B=1
    on 1024^2 crops. Timed calls with the launch counts, the stage times of
    the `timer` hook, the call against the same call with the plain
    versions on the card (image mean within 0.5 levels, as phase 4), the
    inpaint composite's pixels where its soft mask is 0 against its input
    (equal), also on a synthetic hole since the random parse may leave
    none, `swap_batch` at B=4 against four single calls with its time and
    peak memory (and at B=8, 16 and 24 for the memory line), one `swap_raw` on phase
    5's frames, and one call in each classical ct_mode of ZOO_CT_MODES.
    Returns the record of the timed calls."""
    import warnings

    from e4s2024_torch import kernels
    from e4s2024_torch.pipelines.detect import default_landmarker
    from e4s2024_torch.pipelines.full_swap import FullFaceSwapPipeline, FullSwapConfig
    from e4s2024_torch.pipelines.swap import FaceSwapper, SwapConfig
    from e4s2024_torch.pipelines.video import StageTimer
    from e4s2024_torch.profile_swap import raw_frames, zoo_components

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # random landmark weights, said in phase 5
        landmarker = default_landmarker(device="cuda")
    swapper = FaceSwapper(rgi_sd, bise_sd, SwapConfig(), landmark_fn=landmarker, device="cuda")
    comps = zoo_components("cuda")
    pipe = FullFaceSwapPipeline(swapper, comps, FullSwapConfig(face_inpainting=True))
    if not pipe._fused():
        raise AssertionError("zoo: the default config should take JAX's fused semantics")
    driven, target = _inputs(1024)
    src, tgt = driven[0], target[0]
    problems = []

    # capture what the inpaint composite reads and writes
    seen = []
    composite = pipe._inpaint_composite

    def recording(img, out, hole):
        res = composite(img, out, hole)
        seen.append((img, hole, res))
        return res

    pipe._inpaint_composite = recording
    out, ms, launches, peak = _zoo_call(
        torch, kernels, lambda: pipe(src, tgt, return_intermediates=True), ZOO_REQUESTS)
    want = dict.fromkeys(launches, 0)
    want.update({k: ZOO_REQUESTS * v for k, v in ZOO_PER_CALL.items()})
    if launches != want:
        problems.append(f"launches {launches}, expected {want}")
    image = out["image"]
    if image.shape != (1024, 1024, 3) or image.dtype != torch.uint8:
        problems.append(f"bad output {tuple(image.shape)} {image.dtype}")
    img_in, hole, res = seen[-1]
    soft = pipe._inpaint_soft_mask(hole, 1024)[:, 0]
    outside = soft == 0
    outside_equal = bool(torch.equal(res[outside], img_in[outside]))
    pipe._inpaint_composite = composite

    timer = StageTimer()
    pipe(src, tgt, timer=timer)
    with kernels.plain_versions_on_card():
        plain = pipe(src, tgt, return_intermediates=True)
    diff = (plain["image"].int() - image.int()).abs()
    driven_diff = (plain["driven"].int() - out["driven"].int()).abs()

    # the inpaint stage on a synthetic hole: a disc over the face's centre
    yy, xx = torch.meshgrid(torch.arange(512, device="cuda"), torch.arange(512, device="cuda"),
                            indexing="ij")
    disc = (((yy - 300) ** 2 + (xx - 256) ** 2) < 60 ** 2)[None]
    with torch.inference_mode():
        swapped = image[None].float()
        filled = pipe._inpaint(swapped, disc)
    disc_soft = pipe._inpaint_soft_mask(disc, 1024)[0, 0]
    disc_outside = disc_soft == 0
    disc_equal = bool(torch.equal(filled[0][disc_outside], swapped[0][disc_outside]))
    disc_changed = float((filled[0][~disc_outside] - swapped[0][~disc_outside]).abs().mean())

    rec = {"requests": ZOO_REQUESTS, "latency_ms": ms, "peak_mem_gib": peak,
           "launches": launches, "launches_per_call": ZOO_PER_CALL,
           "stage_ms": timer.times,
           "vs_plain_max_abs": int(diff.max()), "vs_plain_mean_abs": float(diff.float().mean()),
           "vs_plain_driven_max_abs": int(driven_diff.max()),
           "vs_plain_mask_share": float((plain["swapped_mask"] != out["swapped_mask"])
                                        .float().mean()),
           "tolerance_mean_abs": 0.5,
           "hole_pixels_512": int(hole.sum()), "outside_soft_mask_pixels": int(outside.sum()),
           "outside_hole_equal": outside_equal,
           "disc_outside_pixels": int(disc_outside.sum()), "disc_outside_equal": disc_equal,
           "disc_inside_mean_change": disc_changed,
           "driven_changed_share": float((out["driven"] != torch.from_numpy(src).cuda())
                                         .float().mean()),
           "changed_vs_target_share": float((image != torch.from_numpy(tgt).cuda())
                                            .float().mean())}
    if rec["vs_plain_mean_abs"] > 0.5:
        problems.append("the call differs from the plain-version call beyond 0.5 levels mean")
    if not outside_equal or not disc_equal or disc_changed <= 0:
        problems.append("the inpaint composite changed pixels outside its mask, or none inside")
    log(f"[zoo] {json.dumps(rec)}")

    # swap_batch at B=4 against four single calls; then larger Bs for memory
    srcs, tgts = _zoo_inputs(ZOO_BATCH)
    batch, bms, blaunch, bpeak = _zoo_call(torch, kernels, lambda: pipe.swap_batch(srcs, tgts))
    singles = torch.stack([pipe(s, t)["image"] for s, t in zip(srcs, tgts)])
    bdiff = (batch.int() - singles.int()).abs()
    brec = {"batch": ZOO_BATCH, "ms": bms[0], "swaps_per_s": ZOO_BATCH / bms[0] * 1e3,
            "peak_mem_gib": bpeak, "vs_single_max_abs": int(bdiff.max()),
            "vs_single_mean_abs": float(bdiff.float().mean()),
            "launches": {k: v for k, v in blaunch.items() if v}}
    if {k: blaunch[k] for k in ZOO_PER_CALL} != ZOO_PER_CALL \
            or brec["vs_single_mean_abs"] > 0.5 \
            or batch.shape != (ZOO_BATCH, 1024, 1024, 3):
        problems.append(f"swap_batch: {brec}")
    # larger batches: time and peak memory; the largest B under the card's
    # 80 GB by the slope between the last two (an extrapolation)
    peaks = {ZOO_BATCH: bpeak}
    for b in ZOO_BATCH_MEMORY:
        srcs_b, tgts_b = _zoo_inputs(b)
        _, ms_b, _, peaks[b] = _zoo_call(torch, kernels, lambda: pipe.swap_batch(srcs_b, tgts_b))
        brec[f"batch_{b}"] = {"ms": ms_b[0], "swaps_per_s": b / ms_b[0] * 1e3,
                              "peak_mem_gib": peaks[b]}
        del srcs_b, tgts_b
        torch.cuda.empty_cache()
    (b1, p1), (b2, p2) = sorted(peaks.items())[-2:]
    slope = (p2 - p1) / (b2 - b1)
    brec["peak_gib_per_pair"] = slope
    brec["largest_batch_in_80gb"] = b2 + int((80e9 / 2 ** 30 - p2) // slope)
    log(f"[zoo] swap_batch {json.dumps(brec)}")

    # one raw-frame call: detection, the zoo swap of the crops, paste-back
    raw_src, raw_tgt = raw_frames()
    frame, rms, rlaunch, rpeak = _zoo_call(torch, kernels, lambda: pipe.swap_raw(raw_src, raw_tgt))
    lm = landmarker(raw_tgt)
    outside_quad = _outside_quad(torch, swapper, lm, raw_tgt.shape)
    rrec = {"ms": rms[0], "peak_mem_gib": rpeak, "launches": {k: v for k, v in rlaunch.items()
                                                              if v},
            "outside_quad_pixels": int(outside_quad.sum()),
            "outside_quad_equal": bool(np.array_equal(frame[outside_quad],
                                                      raw_tgt[outside_quad])),
            "changed_share": float((frame != raw_tgt).any(-1).mean())}
    if {k: rlaunch[k] for k in ZOO_PER_CALL} != ZOO_PER_CALL or frame.shape != raw_tgt.shape \
            or not rrec["outside_quad_equal"] or rrec["changed_share"] == 0:
        problems.append(f"swap_raw: {rrec}")
    log(f"[zoo] swap_raw {json.dumps(rrec)}")

    # the classical colour transfers in place of Blender
    for mode in ZOO_CT_MODES:
        ct = FullFaceSwapPipeline(swapper, comps,
                                  FullSwapConfig(ct_mode=mode, face_inpainting=True))
        cout, cms, claunch, _ = _zoo_call(torch, kernels, lambda: ct(src, tgt)["image"])
        crec = {"ct_mode": mode, "ms": cms[0], "launches": {k: v for k, v in claunch.items() if v},
                "vs_blender_mean_abs": float((cout.int() - image.int()).abs().float().mean())}
        if cout.shape != (1024, 1024, 3) \
                or {k: claunch[k] for k in ZOO_CT_PER_CALL} != ZOO_CT_PER_CALL:
            problems.append(f"ct_mode {mode}: {crec}")
        log(f"[zoo] ct_mode {json.dumps(crec)}")
    problems += _zoo_extras(torch, kernels, swapper, src, tgt)
    del swapper, pipe, comps, out, plain, batch, singles
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError(f"zoo: {problems}")
    return rec


def _zoo_extras(torch, kernels, swapper, src, tgt):
    """The zoo's other members once each at published widths (seeded random
    weights): the CodeFormer and GFPGAN enhancers on the 1024^2 crop, MISF
    through the inpainting registry on a 256^2 crop with a hole, and the
    W-space refinement (OPTIMIZE_W_STEPS steps per crop, K1-K3 and their
    backwards). Returns the problems found."""
    from e4s2024_torch.models.codeformer import CodeFormer, CodeFormerEnhancer
    from e4s2024_torch.models.gfpgan import GFPGANEnhancer, GFPGANv1Clean
    from e4s2024_torch.models.misf import MISFGenerator
    from e4s2024_torch.pipelines.full_swap import FullFaceSwapPipeline, FullSwapConfig
    from e4s2024_torch.pipelines.inpaint_registry import make_inpainter

    problems = []
    torch.manual_seed(SEED + 8)
    crop = torch.from_numpy(src).cuda()[None].float()
    for name, enh in (("codeformer", CodeFormerEnhancer(CodeFormer().state_dict(),
                                                        device="cuda")),
                      ("gfpgan", GFPGANEnhancer(GFPGANv1Clean().state_dict(), device="cuda"))):
        out, ms, launches, peak = _zoo_call(torch, kernels, lambda: enh.enhance_aligned(crop))
        erec = {"enhancer": name, "ms": ms[0], "peak_mem_gib": peak,
                "launches": {k: v for k, v in launches.items() if v},
                "finite": bool(torch.isfinite(out).all())}
        log(f"[zoo] extra {json.dumps(erec)}")
        if out.shape != crop.shape or not erec["finite"]:
            problems.append(f"enhancer {name}: {erec}")
        del enh
    inp = make_inpainter("misf", MISFGenerator().state_dict(), device="cuda")
    img01 = crop[:, ::4, ::4] / 255.0
    hole = torch.zeros(1, 256, 256, 1, device="cuda")
    hole[:, 80:170, 70:190] = 1.0
    out, ms, _, _ = _zoo_call(torch, kernels, lambda: inp(img01, hole))
    kept = bool(torch.equal(out[hole[..., 0] == 0], img01[hole[..., 0] == 0]))
    log(f"[zoo] extra {json.dumps({'inpainter': 'misf', 'ms': ms[0], 'outside_equal': kept})}")
    if not kept or not bool(torch.isfinite(out).all()):
        problems.append("misf: the hole's outside changed, or non-finite output")
    del inp
    pipe = FullFaceSwapPipeline(swapper, None, FullSwapConfig(
        ct_mode="none", optimize_w_steps=OPTIMIZE_W_STEPS))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = pipe(src, tgt, verbose=True)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    wrec = {"optimize_w_steps": OPTIMIZE_W_STEPS, "ms": (time.perf_counter() - t0) * 1e3,
            "stage_ms": out["stage_times"], "launches": {k: v for k, v in launches.items() if v}}
    log(f"[zoo] extra {json.dumps(wrec)}")
    if out["image"].shape != (1024, 1024, 3) or not all(
            launches[k] for k in ("fused_leaky_relu_backward", "upfirdn2d_backward",
                                  "regional_scale_backward")):
        problems.append(f"optimize_w: {wrec}")
    torch.cuda.empty_cache()
    return problems


def _busy_share(torch, fn):
    """The device's busy share over one fn() call: the summed self device
    time of the CUDA events torch.profiler records, over the call's wall
    time (one stream, so no event counts twice)."""
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e6
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy * 1e3, "busy_share": busy / wall}


def _gate(pipe):
    return {"gaps": pipe.last_gate["gaps"], "driven": pipe.last_gate["driven"]}


def phase_reenact(torch, rgi_sd, bise_sd):
    """The reenacted zoo swap (see the module docstring, phase 8). Returns
    the record of the timed calls, with the LIA run's launches under
    "lia_launches"."""
    from e4s2024_torch import kernels
    from e4s2024_torch.pipelines.full_swap import FullFaceSwapPipeline, FullSwapConfig
    from e4s2024_torch.pipelines.swap import FaceSwapper, SwapConfig
    from e4s2024_torch.pipelines.video import StageTimer
    from e4s2024_torch.profile_swap import reenact_components

    swapper = FaceSwapper(rgi_sd, bise_sd, SwapConfig(), device="cuda")
    comps = reenact_components("cuda")
    pipe = FullFaceSwapPipeline(swapper, comps, FullSwapConfig(face_inpainting=True,
                                                               pose_gap_threshold=0.0))
    if pipe._fused():
        raise AssertionError("reenact: a pose driver should take JAX's staged semantics")
    driven, target = _inputs(1024)
    src, tgt = driven[0], target[0]
    problems = []
    gates = []

    def call():
        out = pipe(src, tgt, return_intermediates=True)
        gates.append(_gate(pipe))
        return out

    out, ms, launches, peak = _zoo_call(torch, kernels, call, REENACT_REQUESTS)
    want = dict.fromkeys(launches, 0)
    want.update({k: REENACT_REQUESTS * v for k, v in ZOO_PER_CALL.items()})
    if launches != want:
        problems.append(f"launches {launches}, expected {want}")
    image = out["image"]
    if image.shape != (1024, 1024, 3) or image.dtype != torch.uint8:
        problems.append(f"bad output {tuple(image.shape)} {image.dtype}")
    if not all(g["driven"] == [True] for g in gates):
        problems.append(f"threshold 0 left a call undriven: {gates}")
    timer = StageTimer()
    pipe(src, tgt, timer=timer)
    busy = _busy_share(torch, lambda: pipe(src, tgt))
    with kernels.plain_versions_on_card():
        plain = pipe(src, tgt, return_intermediates=True)
        plain_gate = _gate(pipe)
    diff = (plain["image"].int() - image.int()).abs()
    driven_diff = (plain["driven"].int() - out["driven"].int()).abs()
    kept = comps.enhancers["gpen"](torch.from_numpy(driven).cuda().float())
    default = FullFaceSwapPipeline(swapper, comps, FullSwapConfig(face_inpainting=True))
    t0 = time.perf_counter()
    default(src, tgt)
    torch.cuda.synchronize()
    default_ms = (time.perf_counter() - t0) * 1e3
    rec = {"requests": REENACT_REQUESTS, "latency_ms": ms, "peak_mem_gib": peak,
           "launches": launches, "launches_per_call": ZOO_PER_CALL, "gates": gates,
           "stage_ms": timer.times, "traced_call": busy,
           "vs_plain_max_abs": int(diff.max()), "vs_plain_mean_abs": float(diff.float().mean()),
           "vs_plain_driven_max_abs": int(driven_diff.max()),
           "plain_gate": plain_gate, "tolerance_mean_abs": 0.5,
           "driven_vs_enhanced_source_mean_abs": float(
               (out["driven"].float() - kept[0]).abs().mean()),
           "changed_vs_target_share": float((image != torch.from_numpy(tgt).cuda())
                                            .float().mean()),
           "default_threshold": {"threshold": default.cfg.pose_gap_threshold,
                                 "gate": _gate(default), "ms": default_ms}}
    if rec["vs_plain_mean_abs"] > 0.5:
        problems.append("the call differs from the plain-version call beyond 0.5 levels mean")
    if plain_gate["driven"] != gates[-1]["driven"]:
        problems.append("the plain-version call's gate decided otherwise")
    if rec["driven_vs_enhanced_source_mean_abs"] <= 0.0:
        problems.append("the drive left the source crop as it was")
    log(f"[reenact] {json.dumps(rec)}")

    # swap_batch at B=4, the threshold between the pairs' gaps
    srcs, tgts = _zoo_inputs(REENACT_BATCH)
    gaps = sorted(comps.pose_estimator.pose_gaps(srcs, tgts).tolist())
    threshold = (gaps[1] + gaps[2]) / 2
    bpipe = FullFaceSwapPipeline(swapper, comps, FullSwapConfig(face_inpainting=True,
                                                                pose_gap_threshold=threshold))
    batch, bms, blaunch, bpeak = _zoo_call(torch, kernels, lambda: bpipe.swap_batch(srcs, tgts))
    bgate = _gate(bpipe)
    singles, sgates = [], []
    for s_, t_ in zip(srcs, tgts):
        singles.append(bpipe(s_, t_)["image"])
        sgates.append(bpipe.last_gate["driven"][0])
    bdiff = (batch.int() - torch.stack(singles).int()).abs()
    brec = {"batch": REENACT_BATCH, "threshold": threshold, "gate": bgate,
            "single_gates": sgates, "ms": bms[0], "swaps_per_s": REENACT_BATCH / bms[0] * 1e3,
            "peak_mem_gib": bpeak, "vs_single_max_abs": int(bdiff.max()),
            "vs_single_mean_abs": float(bdiff.float().mean()),
            "launches": {k: v for k, v in blaunch.items() if v}}
    if bgate["driven"] != sgates or brec["vs_single_mean_abs"] > 0.5 \
            or batch.shape != (REENACT_BATCH, 1024, 1024, 3):
        problems.append(f"swap_batch: {brec}")
    if len(set(gaps)) == REENACT_BATCH and sorted(sgates) != [False, False, True, True]:
        problems.append(f"swap_batch: the threshold between the gaps should split the batch "
                        f"{gaps} {sgates}")
    log(f"[reenact] swap_batch {json.dumps(brec)}")
    del swapper, pipe, bpipe, default, comps, out, plain, batch, singles
    torch.cuda.empty_cache()
    lia_launches = _registry_drivers(torch, kernels, problems)
    problems += _dcn_check(torch)
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError(f"reenact: {problems}")
    rec["lia_launches"] = lia_launches
    return rec


def _registry_drivers(torch, kernels, problems):
    """TPSMM, DaGAN and LIA through `make_pose_driver` at their published
    widths (PyTorch's seeded default initialisation) on a 256^2 source and
    driving frame: ms per driven frame over DRIVER_FRAMES calls after a
    warm-up, finite output in range; LIA also against its plain versions
    (bound: LIA_ULP_FACTOR), with its K1/K2 launches counted over the timed
    calls. Returns LIA's launches."""
    from e4s2024_torch.models import dagan, lia, tpsmm
    from e4s2024_torch.pipelines.pose_drive import make_pose_driver

    torch.manual_seed(SEED + 9)
    rng = np.random.default_rng(SEED + 9)
    src01, drv01 = (torch.from_numpy(rng.random((1, 256, 256, 3), np.float32)).cuda()
                    for _ in range(2))
    weights = {
        "TPSMM": {"kp_detector": tpsmm.TPSKPDetector().state_dict(),
                  "dense_motion_network": tpsmm.TPSDenseMotion().state_dict(),
                  "inpainting_network": tpsmm.TPSInpainting().state_dict()},
        "DaGAN": {"generator": dagan.DepthAwareGenerator().state_dict(),
                  "kp_detector": dagan.DaGANKPDetector().state_dict(),
                  "depth_encoder": dagan.DepthResnetEncoder().state_dict(),
                  "depth_decoder": dagan.DepthDecoder().state_dict()},
        "LIA": lia.LIAGenerator().state_dict()}
    lia_launches = None
    for name, sd in weights.items():
        drv = make_pose_driver(name, sd, device="cuda")
        s, d = (src01 * 2 - 1, drv01 * 2 - 1) if name == "LIA" else (src01, drv01)
        out, ms, launches, peak = _zoo_call(torch, kernels, lambda: drv(s, d), DRIVER_FRAMES)
        lo, hi = (-np.inf, np.inf) if name == "LIA" else (0.0, 1.0)
        rec = {"driver": name, "ms_per_frame": ms, "peak_mem_gib": peak,
               "shape": list(out.shape), "finite": bool(torch.isfinite(out).all()),
               "min": float(out.min()), "max": float(out.max()),
               "launches": {k: v for k, v in launches.items() if v}}
        if name == "LIA":
            eps = torch.finfo(torch.float32).eps
            gen = torch.Generator(device="cuda").manual_seed(SEED)

            def ulp(x):
                return x * (1 + eps * torch.randn(x.shape, generator=gen, device="cuda").sign())

            with kernels.plain_versions_on_card():
                plain = drv(s, d)
                response = max(float((drv(ulp(s), ulp(d)) - plain).abs().max())
                               for _ in range(LIA_ULP_DRAWS))
            rec["vs_plain_max_abs"] = float((plain - out).abs().max())
            rec["one_ulp_input_response"] = response
            rec["tolerance"] = max(LIA_REL_TOL * max(1.0, float(plain.abs().max())),
                                   LIA_ULP_FACTOR * response)
            lia_launches = launches
            if rec["vs_plain_max_abs"] > rec["tolerance"] or not all(
                    launches[k] for k in ("fused_leaky_relu", "upfirdn2d")):
                problems.append(f"LIA against its plain versions: {rec}")
        log(f"[reenact] driver {json.dumps(rec)}")
        if out.shape != (1, 256, 256, 3) or not rec["finite"] or rec["min"] < lo \
                or rec["max"] > hi:
            problems.append(f"driver {name}: {rec}")
        del drv, out
        torch.cuda.empty_cache()
    return lia_launches


def _dcn_check(torch):
    """DCNv2Pack at DCN_SHAPE (offsets from a random offset conv, reaching
    past the frame's edge) on the card against the same call on the CPU."""
    from e4s2024_torch.ops.deform_conv import DCNv2Pack

    torch.manual_seed(SEED + 10)
    mod = DCNv2Pack(DCN_SHAPE[1], DCN_SHAPE[1])
    with torch.no_grad():
        mod.conv_offset.weight.normal_(0, 0.05)
        mod.conv_offset.bias.normal_(0, 2.0)
    x = torch.randn(DCN_SHAPE)
    with torch.inference_mode():
        want = mod(x, x)
        mod.cuda()
        xc = x.cuda()
        got = mod(xc, xc)
        ms = time_ms(torch, lambda: mod(xc, xc), iters=5, warmup=1)
    err = float((got.cpu() - want).abs().max())
    rec = {"dcnv2pack": list(DCN_SHAPE), "max_abs_err_vs_cpu": err, "tolerance": DCN_TOL,
           "ms": ms}
    log(f"[reenact] {json.dumps(rec)}")
    return [] if err <= DCN_TOL else [f"DCNv2Pack: {rec}"]


def _train_batches(n: int, b: int = 2, size: int = 1024, label_size: int = 512):
    """n seeded batches for the trainer: smooth images in [-1, 1] (a coarse
    grid upsampled, plus a little noise) and smooth 12-class label maps (a
    coarse grid of classes upsampled), NCHW float32 numpy."""
    rng = np.random.default_rng(SEED + 11)
    out = []
    for _ in range(n):
        coarse = rng.random((b, 3, 16, 16)) * 1.6 - 0.8
        img = np.kron(coarse, np.ones((1, 1, size // 16, size // 16)))
        img = np.clip(img + rng.standard_normal(img.shape) * 0.05, -1, 1).astype(np.float32)
        lbl = np.kron(rng.integers(0, 12, (b, 16, 16)), np.ones((1, label_size // 16,
                                                                  label_size // 16), np.int64))
        onehot = np.eye(12, dtype=np.float32)[lbl].transpose(0, 3, 1, 2)
        out.append((img, np.ascontiguousarray(onehot)))
    return out


def _reference_discriminator(torch, size: int, channel_multiplier: int):
    """A seeded Discriminator, as a reference file holds it: its weights
    plus each ResBlock's Blur `kernel` buffers."""
    from e4s2024_torch.models.stylegan2 import Discriminator
    from e4s2024_torch.ops.upfirdn import make_kernel

    torch.manual_seed(SEED + 12)
    sd = Discriminator(size, channel_multiplier).state_dict()
    for key in [k for k in sd if k.endswith(".conv1.0.weight")]:
        stem = key[: -len(".conv1.0.weight")]
        sd[f"{stem}.conv2.0.kernel"] = sd[f"{stem}.skip.0.kernel"] = make_kernel([1, 3, 3, 1])
    return sd


def _timed_steps(torch, kernels, coach):
    """Wrap the coach's d_step and g_step so that each call is timed (host
    clock, synchronised) and its launches recorded by step kind, from the
    counts' differences (the counts are never reset here). Returns the list
    the records go to."""
    calls = []

    def wrap(kind, fn):
        def timed(state, img, onehot, *rest):
            torch.cuda.synchronize()
            before, t0 = kernels.launch_counts(), time.perf_counter()
            out = fn(state, img, onehot, *rest)
            torch.cuda.synchronize()
            after = kernels.launch_counts()
            name = "d_r1" if kind == "d" and rest and rest[0] else kind
            calls.append({"kind": name, "ms": (time.perf_counter() - t0) * 1e3,
                          "launches": {k: after[k] - before[k] for k in after}})
            return out
        return timed

    coach.d_step = wrap("d", coach.d_step)
    coach.g_step = wrap("g", coach.g_step)
    return calls


def _train_setup(torch):
    """Phase 9's TrainConfig, loss nets, reference-style Discriminator
    state dict and batches on the card."""
    from e4s2024_torch.profile_swap import loss_nets
    from e4s2024_torch.training.coach import TrainConfig

    cfg = TrainConfig(d_every=TRAIN_D_EVERY, d_reg_every=TRAIN_D_REG_EVERY)
    d_sd = _reference_discriminator(torch, cfg.out_size, cfg.channel_multiplier)
    batches = [tuple(torch.from_numpy(a).cuda() for a in batch)
               for batch in _train_batches(TRAIN_STEPS)]
    return cfg, loss_nets("cuda"), d_sd, batches


def _train_start(torch, coach, rgi_sd, d_sd):
    """The coach's state from the seeded RGI and Discriminator weights."""
    state = coach.init_state(torch.Generator().manual_seed(SEED))
    return coach.load_pretrained(state, rgi_sd, d_sd)


def _train_fit(torch, setup, rgi_sd, plain: bool):
    """A fresh Coach's fit of TRAIN_STEPS steps from the starting weights,
    through the kernels or (`plain`) their plain versions. Returns (coach,
    state, per-step metrics, per-step timings, the run's record)."""
    from e4s2024_torch import kernels
    from e4s2024_torch.training.coach import Coach

    cfg, nets, d_sd, batches = setup
    coach = Coach(cfg, nets, device="cuda")
    state = _train_start(torch, coach, rgi_sd, d_sd)
    calls = _timed_steps(torch, kernels, coach)
    logs = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with kernels.plain_versions_on_card() if plain else contextlib.nullcontext():
        state = coach.fit(batches, state, TRAIN_STEPS, callback=lambda s, m: logs.append(m))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return coach, state, logs, calls, {"wall_s": wall, "launches": kernels.launch_counts(),
                                       "peak_mem_gib": torch.cuda.max_memory_allocated()
                                       / 2 ** 30}


def _train_compare(logs, plogs):
    """Each step's metrics against the plain versions': (relative
    differences, the problems found). Step 0 within TRAIN_STEP0_REL, later
    steps within TRAIN_LATER_REL, R1 after step 0 within
    TRAIN_R1_LATER_REL."""
    rel, problems = [], []
    for step, (a, b) in enumerate(zip(logs, plogs)):
        rel.append({k: abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for k in TRAIN_METRICS if k in b})
        if set(a) != set(b) or not all(np.isfinite(v) for v in a.values()):
            problems.append(f"step {step}: metrics {sorted(a)} vs {sorted(b)}, or not finite")
        for k, r in rel[-1].items():
            limit = (TRAIN_STEP0_REL if step == 0 else
                     TRAIN_R1_LATER_REL if k == "r1_loss" else TRAIN_LATER_REL)
            if r > limit:
                problems.append(f"step {step}: {k} differs from the plain versions' by {r} "
                                f"(limit {limit})")
    return rel, problems


def phase_train(torch, rgi_sd):
    """The trainer at the default TrainConfig (see the module docstring,
    phase 9). Returns the measured fit's record, its launches under
    "launches"."""
    import dataclasses
    import socket

    import torch.distributed as dist

    from e4s2024_torch.parallel.ddp import make_process_group
    from e4s2024_torch.training.coach import EMA_ACCUM, Coach

    setup = _train_setup(torch)
    cfg, nets, d_sd, batches = setup
    t0 = time.perf_counter()
    coach, state, logs, calls, run = _train_fit(torch, setup, rgi_sd, plain=False)
    log(f"[train] fit of {TRAIN_STEPS} steps (with set-up): {time.perf_counter() - t0:.1f} s")
    frozen = [k for k, flag in coach._mask.items() if not flag]
    frozen_equal = all(torch.equal(state.params[k].detach().cpu(), rgi_sd[k]) for k in frozen)
    _, _, plogs, pcalls, prun = _train_fit(torch, setup, rgi_sd, plain=True)

    # per step kind, after the warm-up step 0
    by_kind = {}
    for c in calls[2:]:
        by_kind.setdefault(c["kind"], []).append(c["ms"])
    ms = {k: float(np.mean(v)) for k, v in by_kind.items()}
    rel, problems = _train_compare(logs, plogs)
    if not frozen or not frozen_equal:
        problems.append(f"frozen tensors changed ({len(frozen)} frozen)")
    if [c["kind"] for c in calls] != ["d_r1", "g", "d", "g", "d_r1", "g"]:
        problems.append(f"step kinds {[c['kind'] for c in calls]}")
    needed = ("fused_leaky_relu", "upfirdn2d", "regional_scale", *BACKWARD, *DOUBLE_BACKWARD)
    if any(run["launches"][k] == 0 for k in needed) or any(prun["launches"].values()):
        problems.append(f"launches {run['launches']}, plain run {prun['launches']}")
    step_launches = {c["kind"]: {k: v for k, v in c["launches"].items() if v}
                     for c in calls[:4]}
    b = batches[0][0].shape[0]
    rec = {"config": {"out_size": cfg.out_size, "batch_size": b,
                      "regional_mode": cfg.regional_mode, "d_every": cfg.d_every,
                      "d_reg_every": cfg.d_reg_every, "optim_name": cfg.optim_name,
                      "learning_rate": cfg.learning_rate},
           "steps": TRAIN_STEPS, "ms_per_step_kind": ms,
           "step_ms": [{"kind": c["kind"], "ms": c["ms"]} for c in calls],
           "plain_step_ms": [{"kind": c["kind"], "ms": c["ms"]} for c in pcalls],
           "images_per_s": b * 1e3 / (ms["g"] + ms["d"]),
           "images_per_s_with_r1": b * 1e3 / (ms["g"] + ms["d_r1"]),
           "wall_s": run["wall_s"], "plain_wall_s": prun["wall_s"],
           "peak_mem_gib_fit_remat_off": run["peak_mem_gib"], "launches": run["launches"],
           "launches_per_step_kind": step_launches, "frozen_tensors": len(frozen),
           "frozen_equal": frozen_equal, "metrics": logs, "plain_metrics": plogs,
           "vs_plain_rel": rel, "limits": {"step0": TRAIN_STEP0_REL, "later": TRAIN_LATER_REL,
                                           "r1_later": TRAIN_R1_LATER_REL}}
    del state, coach

    # a G step's peak memory with remat off and on, and the EMA's formula
    (img, onehot) = batches[0]
    for remat in (False, True):
        rcoach = Coach(dataclasses.replace(cfg, remat=remat), nets, device="cuda")
        rstate = _train_start(torch, rcoach, rgi_sd, d_sd)
        ema0 = {k: v.clone() for k, v in rstate.ema_params.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() / 2 ** 30
        rstate, _ = rcoach.g_step(rstate, img, onehot)
        torch.cuda.synchronize()
        rec[f"g_step_peak_mem_gib_remat_{'on' if remat else 'off'}"] = (
            torch.cuda.max_memory_allocated() / 2 ** 30)
        rec[f"g_step_base_mem_gib_remat_{'on' if remat else 'off'}"] = base
        if not remat:
            worst = max(float((rstate.ema_params[k] - (ema0[k] * EMA_ACCUM + p.detach()
                                                       * (1 - EMA_ACCUM))).abs().max())
                        / max(float(ema0[k].abs().max()), 1e-30)
                        for k, p in rstate.params.items())
            rec["ema_formula_max_rel"] = worst
            if worst > 1e-6:
                problems.append(f"EMA off its formula by {worst}")
        del rcoach, rstate, ema0
        torch.cuda.empty_cache()

    # one G step over a process group at world size 1 (NCCL) against the same step
    # outside it, from the same weights, and a second step outside it for
    # the two runs' own difference: cuDNN's deterministic algorithms, but the
    # encoder's bilinear-resize backward still adds with atomics, and Adam's
    # first step moves every element by lr * sign(gradient), so an element
    # whose gradient is rounding noise can step either way (at most 2 lr
    # apart); the losses are held at TRAIN_DDP_REL, the parameters within
    # 2 lr and, in norm over all of them, within 1e-2 of the step's move
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    results = []
    try:
        for with_group in (False, False, True):
            group = None
            try:
                if with_group:
                    group = make_process_group(1, 0, device="cuda",
                                               init_method=f"tcp://localhost:{port}")
                dcoach = Coach(cfg, nets, process_group=group, device="cuda")
                dstate = _train_start(torch, dcoach, rgi_sd, d_sd)
                dstate, metrics = dcoach.g_step(dstate, img, onehot)
                results.append(({k: float(v) for k, v in metrics.items()},
                                {k: p.detach().clone() for k, p in dstate.params.items()}))
                del dcoach, dstate
            finally:
                if group is not None:
                    dist.destroy_process_group()
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (m0, p0), (m_again, p_again), (m1, p1) = results
    init = {k: rgi_sd[k].to(p.device) for k, p in p0.items()}

    def param_diff(p):
        diff = sum(float((p[k] - p0[k]).square().sum()) for k in p0) ** 0.5
        moved = sum(float((p0[k] - init[k]).square().sum()) for k in p0) ** 0.5
        return max(float((p[k] - p0[k]).abs().max()) for k in p0) / cfg.learning_rate, diff / moved

    ddp_rel = max(abs(m1[k] - m0[k]) / max(abs(m0[k]), 1e-12) for k in m0)
    ddp_lr, ddp_norm = param_diff(p1)
    again_lr, again_norm = param_diff(p_again)
    rec.update(ddp_metrics_max_rel=ddp_rel, ddp_params_max_abs_in_lr=ddp_lr,
               ddp_params_norm_rel_to_move=ddp_norm,
               repeat_metrics_max_rel=max(abs(m_again[k] - m0[k]) / max(abs(m0[k]), 1e-12)
                                          for k in m0),
               repeat_params_max_abs_in_lr=again_lr, repeat_params_norm_rel_to_move=again_norm,
               ddp_limits={"metrics_rel": TRAIN_DDP_REL, "params_max_abs_in_lr": 2.0,
                           "params_norm_rel_to_move": 1e-2})
    if ddp_rel > TRAIN_DDP_REL or ddp_lr > 2.0 or ddp_norm > 1e-2:
        problems.append(f"the group at world size 1 differs: metrics {ddp_rel}, params {ddp_lr} lr, "
                        f"{ddp_norm} of the move")
    del results, p0, p1, p_again, init, nets, batches, setup
    torch.cuda.empty_cache()
    log(f"[train] {json.dumps(rec)}")
    if problems:
        raise AssertionError(f"train: {problems}")
    return rec


def _to_u8(torch, img):
    """(B, S, S, 3) float in [-1, 1] -> uint8, as the apps convert."""
    return torch.clamp((img + 1.0) * 127.5, 0, 255).to(torch.uint8)


def _edits(torch, editor, sv, label):
    """The editor's five edits of one face, each as the (style vectors,
    label map) the re-render takes: b's hair, nose and lip styles (b: the
    components rotated by one), skin and eyes half way to b's, a seeded
    latent direction, b's nose shape (b: the map moved 40 rows, 30
    columns), the nose moved 12 rows and -8 columns."""
    from e4s2024_torch.pipelines.editor import Editor

    other = torch.roll(sv, 1, dims=1)
    direction = np.random.default_rng(SEED + 10).standard_normal(1280).astype(np.float32)
    label_b = np.roll(label, (40, -30), axis=(-2, -1))
    return [
        ("swap_component_style", editor.swap_component_style(sv, other, ["hair", "nose", "lip"]),
         label),
        ("interpolate_styles", editor.interpolate_styles(sv, other, 0.5, ["skin", "eyes"]), label),
        ("apply_latent_direction", editor.apply_latent_direction(sv, direction, 0.5), label),
        ("swap_component_mask", sv, Editor.swap_component_mask(label, label_b, "nose")),
        ("translate_component", sv, Editor.translate_component(label, 5, dy=12, dx=-8)),
    ]


def _editor_config(torch, kernels, editor, img, label, mode):
    """One configuration of the editor: invert the face, then each of the
    five edits re-rendered through the kernels and with the plain versions
    forced, the launches of each re-render, then EDIT_RENDERS timed
    re-renders after a warm-up and their peak memory. Returns (record,
    the last edit's inputs, problems)."""
    sv = editor.invert(img.astype(np.float32)[None] / 127.5 - 1.0, label)
    limit = (2, 0.05) if editor.dtype == torch.float32 else (255, 4.0)  # phase 3's bounds
    edits, problems = {}, []
    for name, sv_e, lbl_e in _edits(torch, editor, sv, label):
        kernels.reset_launch_counts()
        out = editor.generate_from_label(sv_e, lbl_e, regional_mode=mode)
        torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.launch_counts().items() if v}
        with kernels.plain_versions_on_card():
            plain = editor.generate_from_label(sv_e, lbl_e, regional_mode=mode)
        diff = (_to_u8(torch, out).int() - _to_u8(torch, plain).int()).abs()
        edits[name] = {"vs_plain_max_abs": int(diff.max()),
                       "vs_plain_mean_abs": float(diff.float().mean()), "launches": launches}
        if (out.shape != (1, 1024, 1024, 3) or not bool(torch.isfinite(out).all())
                or launches != PER_CALL[mode] or int(diff.max()) > limit[0]
                or float(diff.float().mean()) > limit[1]):
            problems.append(f"{editor.dtype} {mode} {name}: {edits[name]}, shape "
                            f"{tuple(out.shape)}, limits {limit}")
    editor.generate_from_label(sv_e, lbl_e, regional_mode=mode)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    latencies = []
    for _ in range(EDIT_RENDERS):
        t0 = time.perf_counter()
        editor.generate_from_label(sv_e, lbl_e, regional_mode=mode)
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
    rec = {"dtype": str(editor.dtype)[6:], "mode": mode, "render_ms": latencies,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "edits": edits, "limits": {"max_abs": limit[0], "mean_abs": limit[1]}}
    return rec, (sv_e, lbl_e), problems


def _edit_apps(torch, kernels, swapper, editor, img, label):
    """The apps and eval over the phase-3 swapper and the float32 editor:
    a stroke and `editor_resynthesize`, `recon_cli` over EDIT_RECON_ITEMS
    synthetic faces into a temporary directory, `interpolation_strip` and
    `mouth_transfer` at 1024^2. Returns (record, launches, problems)."""
    import tempfile

    from e4s2024_torch import app, research

    problems = []
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    stroke = np.zeros((1024, 1024), np.float32)
    stroke[300:520, 380:700] = 1.0
    edited = app.editor_apply_stroke(label[0], stroke, 4)
    out = app.editor_resynthesize(swapper, img, edited)
    rec = {"resynthesize_ms": (time.perf_counter() - t0) * 1e3,
           "stroke_pixels": int((edited != label[0]).sum())}
    if out.shape != (1024, 1024, 3) or out.dtype != np.uint8 or rec["stroke_pixels"] == 0:
        problems.append(f"editor_resynthesize: {out.shape} {out.dtype}, {rec}")

    faces = _zoo_inputs(EDIT_RECON_ITEMS)[0]
    items = [(f.astype(np.float32) / 127.5 - 1.0, app.editor_parse(swapper, f)) for f in faces]
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        metrics = app.recon_cli(swapper, items, d)
        rec["recon_cli_s"] = time.perf_counter() - t0
        pngs = sorted(p.name for p in Path(d).glob("*_recon.png"))
        rec["recon_png_bytes"] = [(Path(d) / p).stat().st_size for p in pngs]
        rec["recon_metrics"] = metrics
        if (len(pngs) != EDIT_RECON_ITEMS or not (Path(d) / "metrics.txt").exists()
                or not all(np.isfinite(v) for v in metrics.values())):
            problems.append(f"recon_cli: {pngs}, {metrics}")

    t0 = time.perf_counter()
    strip = research.interpolation_strip(editor, faces[0], faces[1], items[0][1], items[1][1],
                                         steps=EDIT_STRIP_STEPS)
    rec["strip_ms"] = (time.perf_counter() - t0) * 1e3
    want = (1024, (EDIT_STRIP_STEPS + 2) * 1024 + (EDIT_STRIP_STEPS + 1) * 4, 3)
    if strip.shape != want or strip.dtype != np.uint8:
        problems.append(f"interpolation_strip: {strip.shape}, expected {want}")
    # the aligned crop's mouth region at 512^2 (a random parse has no mouth
    # classes), resized to the faces inside
    mouth = np.zeros((512, 512), np.float32)
    mouth[330:390, 190:322] = 1.0
    combined, m, seam = research.mouth_transfer(faces[1], faces[0], mouth, device="cuda")
    rec["mouth_pixels"], rec["seam_pixels"] = int((m > 0).sum()), int((seam > 0).sum())
    if (combined.shape != (1024, 1024, 3) or m.shape != seam.shape != (1024, 1024)
            or rec["seam_pixels"] == 0):
        problems.append(f"mouth_transfer: {combined.shape} {m.shape} {seam.shape}, {rec}")
    launches = kernels.launch_counts()
    return rec, launches, problems


def _tune_setup(torch, rgi_sd, bise_sd):
    """Phase 6's clip, landmark stack, float32 exact swapper and loss nets."""
    import warnings

    from e4s2024_torch.pipelines.detect import default_landmarker
    from e4s2024_torch.pipelines.swap import FaceSwapper, SwapConfig
    from e4s2024_torch.profile_swap import loss_nets, video_clip

    source, frames = video_clip()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # random landmark weights, said in phase 5
        landmarker = default_landmarker(device="cuda")
    swapper = FaceSwapper(rgi_sd, bise_sd, SwapConfig(), landmark_fn=landmarker, device="cuda")
    return swapper, loss_nets("cuda"), source, frames


def _tune_pipeline(swapper, nets, pti_steps, stitching_steps):
    """The video pipeline with bfloat16 PTI and stitching steps."""
    from e4s2024_torch.pipelines.video import FaceSwapVideoPipeline, VideoSwapConfig
    from e4s2024_torch.training.pti import PTIConfig, StitchingConfig

    cfg = VideoSwapConfig(
        pti=PTIConfig(max_pti_steps=pti_steps, compute_dtype="bfloat16"),
        stitching=StitchingConfig(max_steps=stitching_steps, compute_dtype="bfloat16"),
        frames_per_batch=4)
    return FaceSwapVideoPipeline(swapper, cfg, loss_params=nets)


def _tune_compare(hist, phist):
    """Each step's loss through the kernels against the plain versions'
    (relative), PTI and stitching; PTI's steps over TUNE_BF16_PTI_LIMITS. The
    clip's stitching is recorded only: the random parse leaves its border
    ring empty, so its first gradient is bfloat16 rounding noise, which
    Adam's lr-1e-2 steps of either sign turn into differences of order 1
    (the ring run of `_stitching_with_ring` holds stitching instead)."""
    rel = {name: [abs(a["loss"] - b["loss"]) / max(abs(b["loss"]), 1e-12)
                  for a, b in zip(hist[name], phist[name])] for name in ("pti", "stitching")}
    problems = []
    first, later = TUNE_BF16_PTI_LIMITS
    if rel["pti"][0] > first or max(rel["pti"][1:]) > later:
        problems.append(f"PTI losses differ from the plain versions' by {rel['pti']}")
    if not all(np.isfinite(m["loss"]) for h in (hist, phist) for v in h.values() for m in v):
        problems.append("non-finite tuning losses")
    return rel, problems


def _tune_bf16(torch, kernels, rgi_sd, bise_sd, video):
    """The phase-6 clip with bfloat16 PTI and stitching steps: a warm-up
    clip (one step each), the measured clip, the same clip with the plain
    versions forced on from the same weights. Returns (record, launches,
    problems)."""
    swapper, nets, source, frames = _tune_setup(torch, rgi_sd, bise_sd)
    _video_run(torch, kernels, _tune_pipeline(swapper, nets, 1, 1), rgi_sd, source, frames)
    pipe = _tune_pipeline(swapper, nets, TUNE_BF16_PTI_STEPS, TUNE_BF16_STITCHING_STEPS)
    written = []
    write_back = pipe._write_back
    pipe._write_back = lambda state: (written.append(sorted({
        str(v.dtype) for v in state.values() if v.is_floating_point()})), write_back(state))
    outs, rec, hist = _video_run(torch, kernels, pipe, rgi_sd, source, frames)
    with kernels.plain_versions_on_card():
        _, prec, phist = _video_run(torch, kernels, pipe, rgi_sd, source, frames)
    rel, problems = _tune_compare(hist, phist)
    # the ring run from the clip's starting weights: the clip's stitching
    # leaves them wherever its noise-driven steps went
    swapper.rgi.load_state_dict(rgi_sd)
    u8, labels, sv = _clip_inputs(torch, pipe, frames)
    ring, ring_problems = _stitching_with_ring(torch, kernels, pipe, nets, u8, labels, sv,
                                               "bfloat16", TUNE_BF16_RING_LIMITS)
    problems += ring_problems
    rec.update(vs_plain_loss_rel=rel, limits=TUNE_BF16_PTI_LIMITS, master_dtypes=written,
               stitching_with_ring=ring,
               plain_clip_s=prec["clip_s"], plain_losses=prec["losses"],
               float32_ms_per_pti_step=video["ms_per_pti_step"],
               float32_ms_per_stitching_step=video["ms_per_stitching_step"],
               float32_peak_mem_gib=video["peak_mem_gib"])
    if any(dtypes != ["torch.float32"] for dtypes in written) or not written:
        problems.append(f"master weights not float32: {written}")
    if not min(rec["losses"]["pti"]) < rec["losses"]["pti"][0]:
        problems.append("bfloat16 PTI's lowest loss is not below its first")
    if len(outs) != len(frames) or any(o.shape != f.shape for o, f in zip(outs, frames)):
        problems.append("bad frames from the bfloat16-tuned clip")
    for name in ("fused_leaky_relu", "upfirdn2d", "regional_scale"):
        if rec["launches"][name] == 0 or rec["launches"][name + "_backward"] == 0:
            problems.append(f"{name} or its backward never launched: {rec['launches']}")
    if any(prec["launches"].values()):
        problems.append(f"the plain run launched kernels: {prec['launches']}")
    launches = {k: rec["launches"][k] + ring["launches"].get(k, 0) for k in rec["launches"]}
    del swapper, nets, pipe, u8, labels, sv
    torch.cuda.empty_cache()
    return rec, launches, problems


def phase_edit(torch, rgi_sd, bise_sd, video):
    """The editor, the apps and eval, and bfloat16 tuning (see the module
    docstring, phase 10). Returns the record, its launches under
    "launches"."""
    from e4s2024_torch import app, kernels
    from e4s2024_torch.pipelines.editor import Editor
    from e4s2024_torch.pipelines.swap import FaceSwapper, SwapConfig
    from e4s2024_torch.utils.mfu import program_mfu

    t_phase = time.perf_counter()
    swapper = FaceSwapper(rgi_sd, bise_sd, SwapConfig(), device="cuda")
    img = _inputs(1024)[0][0]
    label = app.editor_parse(swapper, img)[None]
    problems, configs, launches = [], [], {}
    f32_exact = None
    for dtype, mode in EDIT_CONFIGS:
        editor = (Editor(swapper.rgi) if dtype == "float32" else
                  Editor.from_state_dict(rgi_sd, device="cuda", compute_dtype=dtype))
        rec, last, probs = _editor_config(torch, kernels, editor, img, label, mode)
        problems += probs
        for name, e in rec["edits"].items():
            for k, v in e["launches"].items():
                launches[k] = launches.get(k, 0) + v
        if (dtype, mode) == ("float32", "exact"):
            f32_exact = editor
            seconds = float(np.mean(rec["render_ms"])) / 1e3
            rec["mfu"] = program_mfu(lambda: editor.generate_from_label(*last, "exact"), seconds,
                                     kind=torch.cuda.get_device_name(0))
            log(f"[edit] mfu of the float32 exact re-render against the bf16 dense peak: "
                f"{json.dumps(rec['mfu'])}")
        log(f"[edit] {json.dumps(rec)}")
        configs.append(rec)
        del editor
        torch.cuda.empty_cache()

    apps, app_launches, probs = _edit_apps(torch, kernels, swapper, f32_exact, img, label)
    problems += probs
    log(f"[edit] apps: {json.dumps(apps)}")
    del swapper, f32_exact
    torch.cuda.empty_cache()

    tune, tune_launches, probs = _tune_bf16(torch, kernels, rgi_sd, bise_sd, video)
    problems += probs
    log(f"[edit] bfloat16 tuning: {json.dumps(tune)}")
    for counts in (app_launches, tune_launches):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    log(f"[edit] phase 10: {time.perf_counter() - t_phase:.1f} s")
    if problems:
        raise AssertionError(f"edit: {problems}")
    return {"configs": configs, "apps": apps, "tune": tune, "launches": launches}


# ------------------------------------------------------------ phase 11


def _twin(torch, kernels, run, group, setup=None, made=None):
    """run(g, setup(g)) for g None and g `group` in turns (ungrouped,
    grouped, grouped, ungrouped; each side's two runs share one setup),
    each timed (host clock, synchronised; `setup`, untimed, builds what the
    runs need; `made`, if given, serves the ungrouped runs instead) with its
    peak memory and its launches (the counts set to 0 just before each run
    and read just after). Returns {"ungrouped": [...], "grouped": [...]},
    each run {"out", "ms", "peak_mem_gib", "launches"}, in the order run."""
    objs = {"ungrouped": made if made is not None else setup(None) if setup else None,
            "grouped": setup(group) if setup else None}
    runs = {"ungrouped": [], "grouped": []}
    for name in ("ungrouped", "grouped", "grouped", "ungrouped"):
        g = group if name == "grouped" else None
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = run(g, objs[name])
        torch.cuda.synchronize()
        runs[name].append({"out": out, "ms": (time.perf_counter() - t0) * 1e3,
                           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                           "launches": kernels.launch_counts()})
    del objs
    return runs


def _twin_record(runs, **extra):
    rec = {}
    for name, rs in runs.items():
        rec[name] = {"ms": [r["ms"] for r in rs], "peak_mem_gib": [r["peak_mem_gib"] for r in rs],
                     "launches": {k: v for k, v in rs[0]["launches"].items() if v}}
    rec.update(extra)
    return rec


def _forward_launches(launches):
    return all(launches[k] > 0 for k in ("fused_leaky_relu", "upfirdn2d", "regional_scale"))


def _group_train(torch, kernels, rgi_sd, group):
    """One D+R1 step of phase 9's TrainConfig from phase 9's weights and
    first batch, with and without the group. Returns (record, launches,
    problems)."""
    from e4s2024_torch.training.coach import Coach

    cfg, nets, d_sd, batches = _train_setup(torch)
    img, onehot = batches[0]

    def setup(g):
        coach = Coach(cfg, nets, process_group=g, device="cuda")
        return coach, _train_start(torch, coach, rgi_sd, d_sd)

    def step(g, made):
        coach, state = made
        state, metrics = coach.d_step(state, img, onehot, with_r1=True)
        return coach._host(metrics)

    # a warm-up step; the ungrouped run then restarts from the same weights
    # (the D step's metrics come before its update, so the optimizer state
    # the warm-up moved does not enter them)
    coach, state = setup(None)
    step(None, (coach, state))
    runs = _twin(torch, kernels, step, group, setup,
                 made=(coach, _train_start(torch, coach, rgi_sd, d_sd)))
    # the first run of each side from the same weights; each side's second
    # run steps on from its first (the grouped one without the first step's
    # broadcast of the weights)
    m0, m1 = runs["ungrouped"][0]["out"], runs["grouped"][0]["out"]
    rel = {k: abs(m1[k] - m0[k]) / max(abs(m0[k]), 1e-12) for k in m0}
    rec = _twin_record(runs, metrics=m1, ungrouped_metrics=m0, vs_ungrouped_rel=rel,
                       limits={"metrics": TRAIN_STEP0_REL, "r1_loss": TRAIN_R1_LATER_REL},
                       config={"out_size": cfg.out_size, "batch_size": img.shape[0],
                               "regional_mode": cfg.regional_mode})
    problems = []
    if set(m0) != set(m1) or "r1_loss" not in m1 or not all(np.isfinite(v) for v in m1.values()):
        problems.append(f"D+R1 metrics {m1} against {m0}")
    for k, r in rel.items():
        if r > (TRAIN_R1_LATER_REL if k == "r1_loss" else TRAIN_STEP0_REL):
            problems.append(f"D+R1 {k} differs from the ungrouped step's by {r}")
    launches = runs["grouped"][0]["launches"]
    if not _forward_launches(launches) or any(launches[k] == 0 for k in DOUBLE_BACKWARD):
        problems.append(f"D+R1 launches {launches}")
    del nets, batches
    torch.cuda.empty_cache()
    return rec, launches, problems


def _group_tune(torch, kernels, rgi_sd, bise_sd, group):
    """2 PTI steps and 2 stitching steps over phase 6's clip, with and without
    the group. Returns (record, launches, problems, the swapper)."""
    from e4s2024_torch.pipelines.video import FaceSwapVideoPipeline, VideoSwapConfig
    from e4s2024_torch.training.pti import PTICoach, PTIConfig, StitchingCoach, StitchingConfig

    swapper, nets, _, frames = _tune_setup(torch, rgi_sd, bise_sd)
    pipe = FaceSwapVideoPipeline(swapper, VideoSwapConfig(), loss_params=nets)
    u8, labels, sv = _clip_inputs(torch, pipe, frames)
    # stitching on labels with a background band, as phase 6's ring run
    m = labels.shape[-1] // 8
    inner = torch.zeros_like(labels, dtype=torch.bool)
    inner[:, m:-m, m:-m] = True
    ring = torch.where(inner, labels, torch.zeros_like(labels))
    with torch.no_grad():
        content = pipe._gen_raw(sv, ring)
    labels, ring = labels.to(torch.uint8), ring.to(torch.uint8)

    def pti(g, _):
        return PTICoach(swapper.rgi, nets, PTIConfig(), process_group=g).tune(
            None, u8, labels, sv, u8, steps=GROUP_TUNE_STEPS)[1]

    def stitching(g, _):
        return StitchingCoach(swapper.rgi, nets, StitchingConfig(), process_group=g).tune(
            None, content, u8, ring, sv, steps=GROUP_TUNE_STEPS)[1]

    rec, problems, launches = {"frames": len(frames), "steps": GROUP_TUNE_STEPS}, [], {}
    for name, fn in (("pti", pti), ("stitching", stitching)):
        runs = _twin(torch, kernels, fn, group)
        h0 = runs["ungrouped"][0]["out"]
        hists = [r["out"] for r in runs["grouped"] + runs["ungrouped"][1:]]
        rel = [max(abs(a["loss"] - b["loss"]) / max(abs(b["loss"]), 1e-12)
                   for a, b in zip(h, h0)) for h in hists]
        rec[name] = _twin_record(runs, losses=[[m["loss"] for m in h] for h in hists],
                                 ungrouped_losses=[m["loss"] for m in h0],
                                 vs_ungrouped_max_rel=rel, limit=GROUP_TUNE_REL)
        if any(len(h) != GROUP_TUNE_STEPS for h in hists) or max(rel) > GROUP_TUNE_REL \
                or not all(np.isfinite(m["loss"]) for h in hists for m in h):
            problems.append(f"{name} over the group: losses {rec[name]['losses']} against "
                            f"{rec[name]['ungrouped_losses']}")
        counts = runs["grouped"][0]["launches"]
        if not _forward_launches(counts) or any(counts[k] == 0 for k in BACKWARD):
            problems.append(f"{name} over the group launched {counts}")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    del nets, pipe, u8, labels, sv, content, ring
    torch.cuda.empty_cache()
    return rec, launches, problems, swapper


def _group_serve(torch, kernels, swapper, group):
    """`swap_batch` at B=ZOO_BATCH of phase 7's zoo pipeline, then the same
    batch after `shard_inference(group)`. Returns (record, launches,
    problems)."""
    from e4s2024_torch.pipelines.full_swap import FullFaceSwapPipeline, FullSwapConfig
    from e4s2024_torch.profile_swap import zoo_components

    pipe = FullFaceSwapPipeline(swapper, zoo_components("cuda"),
                                FullSwapConfig(face_inpainting=True))
    srcs, tgts = _zoo_inputs(ZOO_BATCH)
    pipe.swap_batch(srcs, tgts)  # warm-up

    def serve(g, _):
        pipe.process_group = None
        if g is not None:
            pipe.shard_inference(g)
        return pipe.swap_batch(srcs, tgts)

    runs = _twin(torch, kernels, serve, group)
    pipe.process_group = None
    a, b = runs["grouped"][0]["out"], runs["ungrouped"][0]["out"]
    diff = (a.int() - b.int()).abs()
    launches = runs["grouped"][0]["launches"]
    rec = _twin_record(runs, batch=ZOO_BATCH, vs_ungrouped_max_abs=int(diff.max()),
                       vs_ungrouped_mean_abs=float(diff.float().mean()),
                       limit_mean_abs=0.5)
    problems = []
    if a.shape != (ZOO_BATCH, 1024, 1024, 3) or a.dtype != torch.uint8 \
            or rec["vs_ungrouped_mean_abs"] > 0.5:
        problems.append(f"sharded swap_batch {tuple(a.shape)} {a.dtype}, "
                        f"{rec['vs_ungrouped_mean_abs']} levels from the ungrouped batch")
    if {k: launches[k] for k in ZOO_PER_CALL} != ZOO_PER_CALL:
        problems.append(f"sharded swap_batch launched {launches}, expected {ZOO_PER_CALL}")
    del pipe
    torch.cuda.empty_cache()
    return rec, launches, problems


def phase_group(torch, rgi_sd, bise_sd, card: str):
    """The multi-rank paths at world size 1 over NCCL (see the module
    docstring, phase 11). Returns the record, the grouped runs' launches
    under "launches"."""
    import socket

    import torch.distributed as dist

    from e4s2024_torch import kernels
    from e4s2024_torch.parallel.ddp import make_process_group

    t_phase = time.perf_counter()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    group = make_process_group(1, 0, device="cuda", init_method=f"tcp://localhost:{port}")
    # NCCL makes its communicator at the first collective: once, here, timed
    # apart from the runs
    t0 = time.perf_counter()
    dist.all_reduce(torch.ones(1, device="cuda"), group=group)
    torch.cuda.synchronize()
    launches, problems, rec = {}, [], {"card": card, "world_size": dist.get_world_size(group),
                                       "backend": dist.get_backend(group),
                                       "first_collective_ms": (time.perf_counter() - t0) * 1e3}
    try:
        r, counts, probs = _group_train(torch, kernels, rgi_sd, group)
        rec["d_r1_step"], problems = r, problems + probs
        log(f"[group] d_r1_step ({card}): {json.dumps(r)}")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        r, counts, probs, swapper = _group_tune(torch, kernels, rgi_sd, bise_sd, group)
        rec["tune"], problems = r, problems + probs
        log(f"[group] tune ({card}): {json.dumps(r)}")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        r, counts, probs = _group_serve(torch, kernels, swapper, group)
        rec["serve"], problems = r, problems + probs
        log(f"[group] serve ({card}): {json.dumps(r)}")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        del swapper
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t_phase
    rec["launches"] = launches
    log(f"[group] phase 11: {rec['phase_s']:.1f} s (budget {GROUP_PHASE_S:.0f} s), "
        f"launches {json.dumps({k: v for k, v in launches.items() if v})}")
    if problems:
        raise AssertionError(f"group: {problems}")
    return rec


# ------------------------------------------------------------ phase 12


def _grid_rank(rank: int, world: int, run: str) -> None:
    """One rank of phase 12 (a spawned process): phase 9's fit over the
    grid, its record written to `run`/grid{rank}.json (or its traceback to
    `run`/error{rank}.txt)."""
    import traceback

    sys.path.insert(0, str(ROOT))
    try:
        import torch
        import torch.distributed as dist

        from e4s2024_torch import kernels
        from e4s2024_torch.models.rgi import RGINet
        from e4s2024_torch.parallel.ddp import make_process_grid
        from e4s2024_torch.training.coach import Coach

        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", store=dist.FileStore(f"{run}/store", world),
                                world_size=world, rank=rank)
        try:
            grid = make_process_grid(*GRID)
            torch.manual_seed(SEED)  # phase 9's RGI weights (_random_state_dicts)
            rgi_sd = RGINet().state_dict()
            setup = _train_setup(torch)
            cfg, nets, d_sd, batches = setup
            coach = Coach(cfg, nets, process_group=grid, device="cuda")
            state = _train_start(torch, coach, rgi_sd, d_sd)
            calls = _timed_steps(torch, kernels, coach)
            logs = []
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            coach.fit(batches, state, TRAIN_STEPS, callback=lambda s, m: logs.append(m))
            torch.cuda.synchronize()
            rec = {"rank": rank, "wall_s": time.perf_counter() - t0, "metrics": logs,
                   "step_ms": [{"kind": c["kind"], "ms": c["ms"]} for c in calls],
                   "launches": kernels.launch_counts(),
                   "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        finally:
            dist.destroy_process_group()
        Path(run, f"grid{rank}.json").write_text(json.dumps(rec))
    except BaseException:
        Path(run, f"error{rank}.txt").write_text(traceback.format_exc())
        raise


def phase_grid(torch, train, card: str):
    """Phase 9's fit over the (1, 2) grid on two spawned ranks (see the
    module docstring, phase 12), held against phase 9's record `train`.
    Returns the record, rank 0's launches under "launches"."""
    import multiprocessing
    import tempfile

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    world = GRID[0] * GRID[1]
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as run:
        procs = [ctx.Process(target=_grid_rank, args=(r, world, run)) for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.perf_counter() + GRID_TIMEOUT_S
        for p in procs:
            p.join(max(deadline - time.perf_counter(), 0.0))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        errors = [Path(run, f"error{r}.txt").read_text() for r in range(world)
                  if Path(run, f"error{r}.txt").exists()]
        if hung or errors or any(p.exitcode for p in procs):
            raise AssertionError(f"grid: ranks {hung} still running after {GRID_TIMEOUT_S} s, "
                                 f"exit codes {[p.exitcode for p in procs]}\n"
                                 + "\n".join(errors))
        ranks = [json.loads(Path(run, f"grid{r}.json").read_text()) for r in range(world)]
    problems, rec = [], {"card": card, "grid": list(GRID), "backend": "gloo",
                         "ungrouped_peak_mem_gib": train["peak_mem_gib_fit_remat_off"],
                         "limits": {"step0": TRAIN_STEP0_REL, "later": TRAIN_LATER_REL,
                                    "r1_later": TRAIN_R1_LATER_REL}, "ranks": []}
    needed = ("fused_leaky_relu", "upfirdn2d", "regional_scale", *BACKWARD, *DOUBLE_BACKWARD)
    for r in ranks:
        by_kind = {}
        for c in r["step_ms"][2:]:
            by_kind.setdefault(c["kind"], []).append(c["ms"])
        rel, probs = _train_compare(r["metrics"], train["metrics"])
        prel, pprobs = _train_compare(r["metrics"], train["plain_metrics"])
        problems += [f"rank {r['rank']} vs phase 9: {p}" for p in probs]
        problems += [f"rank {r['rank']} vs phase 9's plain versions: {p}" for p in pprobs]
        if [c["kind"] for c in r["step_ms"]] != ["d_r1", "g", "d", "g", "d_r1", "g"]:
            problems.append(f"rank {r['rank']} step kinds {r['step_ms']}")
        # the split runs phase 9's kernels on windows: each launch once, as
        # there (a kernel whose module the rank never imported launched none)
        names = set(r["launches"]) | set(train["launches"])
        if any(r["launches"][k] == 0 for k in needed) or any(
                r["launches"].get(k, 0) != train["launches"].get(k, 0) for k in names):
            problems.append(f"rank {r['rank']} launches {r['launches']}, phase 9's "
                            f"{train['launches']}")
        rec["ranks"].append({
            "rank": r["rank"], "wall_s": r["wall_s"], "step_ms": r["step_ms"],
            "ms_per_step_kind": {k: float(np.mean(v)) for k, v in by_kind.items()},
            "peak_mem_gib": r["peak_mem_gib"], "vs_phase9_rel": rel, "vs_plain_rel": prel,
            "launches": {k: v for k, v in r["launches"].items() if v}})
        if not r["peak_mem_gib"] < rec["ungrouped_peak_mem_gib"]:
            problems.append(f"rank {r['rank']} peak {r['peak_mem_gib']} GiB is not under the "
                            f"ungrouped {rec['ungrouped_peak_mem_gib']} GiB")
    rec["phase_s"] = time.perf_counter() - t_phase
    rec["launches"] = ranks[0]["launches"]
    log(f"[grid] {json.dumps(rec)}")
    log(f"[grid] phase 12: {rec['phase_s']:.1f} s; per rank peak "
        f"{[round(r['peak_mem_gib'], 3) for r in ranks]} GiB against the ungrouped "
        f"{rec['ungrouped_peak_mem_gib']:.3f} GiB ({card})")
    if problems:
        raise AssertionError(f"grid: {problems}")
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import e4s2024_torch

    if Path(e4s2024_torch.__file__).resolve().parent != ROOT / "e4s2024_torch":
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"[setup] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"float32_matmul_precision={torch.get_float32_matmul_precision()}")

    t0 = time.perf_counter()
    card = phase_build(torch)
    records = phase_kernels(torch)
    rgi_sd, bise_sd = _random_state_dicts(torch)
    main_path = phase_swap(torch, rgi_sd, bise_sd, "float32")
    phase_swap(torch, rgi_sd, bise_sd, "bfloat16")
    sr_sd = _swinir_state_dict(torch)
    enhance = phase_enhance(torch, rgi_sd, bise_sd, sr_sd, "float32")
    phase_enhance(torch, rgi_sd, bise_sd, sr_sd, "bfloat16")
    raw = phase_raw(torch, rgi_sd, bise_sd, sr_sd)
    video = phase_video(torch, rgi_sd, bise_sd)
    zoo = phase_zoo(torch, rgi_sd, bise_sd)
    reenact = phase_reenact(torch, rgi_sd, bise_sd)
    train = phase_train(torch, rgi_sd)
    edit = phase_edit(torch, rgi_sd, bise_sd, video)
    group = phase_group(torch, rgi_sd, bise_sd, card)
    grid = phase_grid(torch, train, card)

    # launches: K1-K3 on the aligned swaps of phase 3, the raw-frame calls of
    # phase 5, the video clip of phase 6, the zoo swaps of phase 7, the
    # reenacted swaps and the LIA drive of phase 8, the trainer's fit of
    # phase 9, the editor, apps and bfloat16-tuned clip of phase 10 and the
    # grouped runs of phase 11 and rank 0's grid fit of phase 12; the
    # backwards on the clips, the fits and the grouped D+R1 step and tunes,
    # the double backwards (R1's) on the fits and the grouped D+R1 step; K5
    # on the enhanced swaps of phases 4 and 5, K4 and K6 on the upscaler
    # runs of their routes
    launches = {name: sum(main_path[m]["launches"][name] for m in main_path)
                + sum(r["launches"].get(name, 0) for r in raw.values())
                + video["launches"][name] + zoo["launches"][name]
                + reenact["launches"][name] + reenact["lia_launches"][name]
                + train["launches"][name] + edit["launches"].get(name, 0)
                + group["launches"].get(name, 0) + grid["launches"].get(name, 0)
                for name in PER_CALL["exact"]}
    launches.update({name: video["launches"][name] + train["launches"][name]
                     + edit["launches"].get(name, 0) + group["launches"].get(name, 0)
                     + grid["launches"].get(name, 0)
                     for name in BACKWARD})
    launches.update({name: train["launches"][name] + group["launches"].get(name, 0)
                     + grid["launches"].get(name, 0)
                     for name in DOUBLE_BACKWARD})
    launches["rdb_conv"] = (zoo["launches"]["rdb_conv"] + reenact["launches"]["rdb_conv"]
                            + group["launches"].get("rdb_conv", 0))
    launches["fused_swin_block"] = (enhance["launches"]["fused_swin_block"]
                                    + raw["swap_raw exact"]["launches"]["fused_swin_block"])
    for route in ("nhwc", "windowed"):
        kernel = ROUTE_KERNEL[route]
        launches[kernel] = enhance["routes"][route]["launches"][kernel]

    # each kernel's first case (the double backwards' are their
    # DOUBLE_BACKWARD_CASES), then the cases phases 7 and 10 add
    picked = [next(r for r in records if r["name"] == name) for name in KERNEL_INFO]
    picked += [next(r for r in records if (r["name"], r["case"]) == case)
               for case in ZOO_CASES + BF16_BACKWARD_CASES]
    summary = []
    for rec in picked:
        source, replaces = KERNEL_INFO[rec["name"]]
        summary.append({
            "name": rec["name"], "case": rec["case"], "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[rec["name"]],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
        })
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
