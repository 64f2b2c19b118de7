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
   generator's shapes, against torch.autograd.grad of the plain version.

The second-to-last line is a JSON object with one entry per kernel; the last
line is {"ok": true, "device": {...}}. Float32 convolutions and matrix
products of PyTorch run in full float32 (TF32 off) throughout; the float32
products inside K4-K6 are error-compensated 3xTF32, as accurate as float32
to within 2e-6.
"""

from __future__ import annotations

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

# kernels whose bfloat16 instances must hold tensor-core instructions
TENSOR_CORE_KERNELS = ("swin_block_kernel", "window_attention_kernel")

# the backward kernels replace no TPU kernel (the JAX package differentiates
# XLA ops); `replaces` names the TPU kernel whose gradient they compute
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
    "swin_attention_nhwc": ("e4s2024_torch/kernels/csrc/window_attention.cu",
                            "e4s2024_tpu/ops/window_attention.py:131"),
    "fused_swin_block": ("e4s2024_torch/kernels/csrc/swin_block.cu",
                         "e4s2024_tpu/ops/swin_block.py:126"),
    "fused_window_attention": ("e4s2024_torch/kernels/csrc/window_attention.cu",
                               "e4s2024_tpu/ops/window_attention.py:55"),
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

    records += _backward_records(torch, randn, gen)
    records += _swin_kernel_records(torch, randn)
    failed = [r for r in records if not r["ok"]]
    if failed:
        raise AssertionError(f"kernels disagree with their plain versions: {failed}")
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


def _stitching_with_ring(torch, kernels, pipe, nets, u8, labels, sv):
    """StitchingCoach at 1024^2 on two of the clip's crops whose labels are
    background in their outer eighth, so that the border ring is not empty
    and every step's gradient, the first included, holds the border term.
    The content targets are the generator's own synthesis, as in the
    pipeline. The kernels' run against the plain versions' from the same
    weights. Returns (record, problems)."""
    from e4s2024_torch.ops.morphology import dilation
    from e4s2024_torch.training.pti import StitchingCoach, StitchingConfig

    n, cfg = 2, StitchingConfig()
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
    rec = {"frames": n, "steps": STITCH_RING_STEPS, "ring_pixels": ring,
           "losses": losses, "plain_losses": plain_losses,
           "border_l2": [h["loss_border_l2"] for h in hist], "vs_plain_loss_rel": rel,
           "limit": 1e-3, "launches": {k: launches[k] for k in ("fused_leaky_relu", "upfirdn2d",
                                                                 "regional_scale", *BACKWARD)}}
    problems = []
    if ring == 0 or not hist[0]["loss_border_l2"] > 0:
        problems.append(f"stitching check: empty border ring ({ring} pixels)")
    if not all(np.isfinite(v) for v in losses + plain_losses):
        problems.append("stitching check: non-finite losses")
    if max(rel) > 1e-3:
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

    with torch.no_grad():
        crops, _ = pipe.align_frames(frames)
        labels = pipe.parse_frames(crops)
        sv = pipe.style_vectors(crops, labels)
    u8 = torch.clamp(torch.round(crops), 0, 255).to(torch.uint8)
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
    del swapper, pipe, nets, crops, labels, sv, u8
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError(f"video: {problems}")
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
    phase_build(torch)
    records = phase_kernels(torch)
    rgi_sd, bise_sd = _random_state_dicts(torch)
    main_path = phase_swap(torch, rgi_sd, bise_sd, "float32")
    phase_swap(torch, rgi_sd, bise_sd, "bfloat16")
    sr_sd = _swinir_state_dict(torch)
    enhance = phase_enhance(torch, rgi_sd, bise_sd, sr_sd, "float32")
    phase_enhance(torch, rgi_sd, bise_sd, sr_sd, "bfloat16")
    raw = phase_raw(torch, rgi_sd, bise_sd, sr_sd)
    video = phase_video(torch, rgi_sd, bise_sd)

    # launches: K1-K3 on the aligned swaps of phase 3, the raw-frame calls of
    # phase 5 and the video clip of phase 6 (which alone runs the backward
    # kernels), K5 on the enhanced swaps of phases 4 and 5, K4 and K6 on the
    # upscaler runs of their routes
    launches = {name: sum(main_path[m]["launches"][name] for m in main_path)
                + sum(r["launches"].get(name, 0) for r in raw.values())
                + video["launches"][name]
                for name in PER_CALL["exact"]}
    launches.update({name: video["launches"][name] for name in BACKWARD})
    launches["fused_swin_block"] = (enhance["launches"]["fused_swin_block"]
                                    + raw["swap_raw exact"]["launches"]["fused_swin_block"])
    for route in ("nhwc", "windowed"):
        kernel = ROUTE_KERNEL[route]
        launches[kernel] = enhance["routes"][route]["launches"][kernel]

    summary = []
    for name, (source, replaces) in KERNEL_INFO.items():
        first = next(r for r in records if r["name"] == name)
        summary.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": first["max_abs_err"], "ms": first["ms"],
            "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"], "library_ms": first["library_ms"],
        })
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
