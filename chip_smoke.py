#!/usr/bin/env python3
"""Drive the PyTorch port (e4s2024_torch) on one NVIDIA card.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero:

1. build: compile the six CUDA kernels from e4s2024_torch/kernels/csrc/
   for sm_90a (one nvcc per source, in parallel) and print the card's name
   and power limit as nvidia-smi reports them;
2. kernels: at the shapes the 1024^2 generator and the SwinIR-M enhancer
   give them, run each kernel and its plain PyTorch version on the same
   inputs, check the difference against a stated bound, and time kernel,
   plain version and (where one PyTorch call computes the same function)
   that call with CUDA events;
3. swap: build FaceSwapper at the reference's default configuration
   (1024^2 output, full IR-SE encoder, full BiSeNet, float32) with seeded
   random weights, run B=1 aligned swaps in exact and fast regional mode,
   check the output and the kernels' launch counts, and hold one swap per
   mode against the same swap with the plain versions forced on the card;
   then time the bfloat16 configuration;
4. enhance: FullFaceSwapPipeline over that FaceSwapper with a full-width
   SwinIR-M "swinir" enhancer (seeded random weights), B=1 at 1024^2: check
   the output and the launch counts of two requests through the default
   fused route (K5), hold the whole call and the upscaler's unclipped output
   against the plain versions, run the upscaler once through K4 and once
   through K6 against their plain versions, then time bfloat16.

The second-to-last line is a JSON object with one entry per kernel; the last
line is {"ok": true, "device": {...}}. Float32 convolutions and matrix
products run in full float32 (TF32 off) throughout.
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
SEED = 0
REQUESTS = 3
ENHANCE_REQUESTS = 2

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

KERNEL_INFO = {
    "fused_leaky_relu": ("e4s2024_torch/kernels/csrc/fused_act.cu",
                         "e4s2024_tpu/ops/pallas/kernels.py:58"),
    "upfirdn2d": ("e4s2024_torch/kernels/csrc/upfirdn2d.cu",
                  "e4s2024_tpu/ops/pallas/kernels.py:96"),
    "regional_scale": ("e4s2024_torch/kernels/csrc/regional_scale.cu",
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


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_build(torch):
    from e4s2024_torch.kernels import build

    t0 = time.perf_counter()
    build.library()
    log(f"[build] kernels ready in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {build.build_info['seconds']:.1f} s, {' '.join(build.NVCC_FLAGS[:1])})")
    for line in build.build_info.get("report", "").splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"[build] {line.strip()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    return card


def _case_record(torch, name, label, kernel_fn, plain_fn, ref_fn, library_fn,
                 bytes_moved, ops, rtol, atol, ops_rate=F32_OPS_PER_S, iters=20):
    """`ops_rate` is the card's peak for the case's work: float32 outside the
    tensor cores, or the bf16 tensor-core rate for bf16 products."""
    got = kernel_fn()
    ref = ref_fn()
    torch.cuda.synchronize()
    err = float((got.float() - ref.float()).abs().max())
    bound = atol + rtol * float(ref.float().abs().max())
    ok = err <= bound and bool(torch.isfinite(got).all())
    dtype, shape = str(got.dtype).replace("torch.", ""), list(got.shape)
    del got, ref
    rec = {
        "name": name, "case": label, "dtype": dtype, "shape": shape,
        "max_abs_err": err, "err_bound": bound,
        "ms": time_ms(torch, kernel_fn, iters), "plain_ms": time_ms(torch, plain_fn, iters),
        "library_ms": None if library_fn is None else time_ms(torch, library_fn, iters),
        "bound_ms": max(bytes_moved / HBM_BYTES_PER_S, ops / ops_rate) * 1e3,
        "bound_by": "bytes" if bytes_moved / HBM_BYTES_PER_S >= ops / ops_rate
        else "operations",
        "ok": ok,
    }
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
    cases = [
        # (label, input shape, up, pad, gain, dtype, library call or None)
        ("blur after transposed conv, 1024^2", (1, 32, 1025, 1025), 1, (1, 1), 4.0,
         torch.float32, lambda x: F.conv2d(x, k_dev.expand(x.shape[1], 1, 4, 4),
                                           padding=1, groups=x.shape[1])),
        ("blur after transposed conv, 1024^2", (1, 32, 1025, 1025), 1, (1, 1), 4.0,
         torch.bfloat16, None),
        ("exact-mode blur, 12 regions at 256^2", (12, 128, 257, 257), 1, (1, 1), 4.0,
         torch.float32, None),
        ("ToRGB skip upsample to 1024^2", (1, 3, 512, 512), 2, (2, 1), 4.0, torch.float32,
         lambda x: F.conv_transpose2d(x, (blur * 4).to(dev).expand(3, 1, 4, 4), stride=2,
                                      padding=1, groups=3)),
        ("blur3x3_tpu's case, pad (2, 1)", (1, 64, 512, 512), 1, (2, 1), 1.0, torch.float32,
         None),
    ]
    for label, shape, up, pad, gain, dtype, lib in cases:
        x = randn(*shape, dtype=dtype)
        k = blur * gain
        out_elems = (shape[0] * shape[1] * upfirdn.out_size(shape[2], 4, up, 1, pad)
                     * upfirdn.out_size(shape[3], 4, up, 1, pad))
        rtol, atol = rel(dtype)
        records.append(_case_record(
            torch, "upfirdn2d", label,
            lambda: upfirdn.upfirdn2d(x, k, up=up, pad=pad),
            lambda: upfirdn.upfirdn2d_plain(x, k, up=up, pad=pad),
            lambda: upfirdn.upfirdn2d_plain(x.float(), k, up=up, pad=pad),
            None if lib is None else (lambda: lib(x)),
            (x.numel() + out_elems) * x.element_size(), 2 * 16 // (up * up) * out_elems,
            rtol, atol))

    # K3: per-pixel regional scale, fast-mode demodulation at 256^2 and the
    # last masked ToRGB's modulation at 128^2
    for label, (c, hw), dtype in [("fast-mode StyledConv at 256^2", (128, 256), torch.float32),
                                  ("fast-mode StyledConv at 256^2", (128, 256), torch.bfloat16),
                                  ("masked ToRGB at 128^2", (256, 128), torch.float32)]:
        x = randn(1, c, hw, hw, dtype=dtype)
        lbl = torch.randint(0, 12, (1, hw, hw), generator=gen, device=dev)
        seg = F.one_hot(lbl, 12).permute(0, 3, 1, 2).to(dtype).contiguous()
        s = randn(1, 12, c, dtype=dtype)
        es = x.element_size()
        rtol, atol = rel(dtype)
        records.append(_case_record(
            torch, "regional_scale", label,
            lambda: modulate.regional_scale(x, seg, s),
            lambda: modulate.regional_scale_plain(x, seg, s),
            lambda: modulate.regional_scale_plain(x.float(), seg.float(), s.float()),
            None, (2 * x.numel() + seg.numel() + s.numel()) * es, 25 * x.numel(), rtol, atol))

    records += _swin_kernel_records(torch, randn)
    failed = [r for r in records if not r["ok"]]
    if failed:
        raise AssertionError(f"kernels disagree with their plain versions: {failed}")
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
    return {k: v if k in swin_block.F32_KEYS else v.to(dtype).contiguous()
            for k, v in wts.items()}


def _swin_kernel_records(torch, randn):
    """K4, K5 and K6 at SwinIR-M's shapes on a 1024^2 crop (embed 180, 6
    heads of 30, window 8, MLP 360; 16,384 windows), float32 and bfloat16,
    unshifted and shifted by 4. Each is held against its plain version in the
    same dtype: float32 differs in summation order only; in bfloat16 that
    order can flip the rounding of an intermediate by one ulp (2^-8), which
    the later steps carry on (one attention: 2^-7 of the largest output; a
    whole block: 2^-5). Library yardstick for K4 and K6:
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
        rate = F32_OPS_PER_S if dtype == torch.float32 else BF16_OPS_PER_S
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
                att_bytes, att_ops, *att_tol, ops_rate=rate, iters=10))
            records.append(_case_record(
                torch, "fused_window_attention", f"SwinIR-M windows at 1024^2, shift {shift}",
                lambda: wa.fused_window_attention(q, k, v, bias, lab2),
                lambda: wa.window_attention_plain(q, k, v, bias, lab2),
                lambda: wa.window_attention_plain(q, k, v, bias, lab2),
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
                att_bytes, att_ops, *att_tol, ops_rate=rate, iters=10))
            del qkv, q, k, v, mask

            x = randn(1, size, size, c, dtype=dtype)
            wts = _swin_block_weights(torch, randn, c, heads, hidden, dtype)
            wt_bytes = sum(t.numel() * t.element_size() for t in wts.values())
            records.append(_case_record(
                torch, "fused_swin_block", f"SwinIR-M block at 1024^2, shift {shift}",
                lambda: swin_block.fused_swin_block(x, wts, lab3, window=ws, heads=heads),
                lambda: swin_block.fused_swin_block_plain(x, wts, lab3, window=ws, heads=heads),
                lambda: swin_block.fused_swin_block_plain(x, wts, lab3, window=ws, heads=heads),
                None, 2 * x.numel() * es + wt_bytes + lab_bytes,
                (2 * (4 * c * c + 2 * c * hidden) + 4 * n * c) * tokens, *blk_tol,
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
        4 * n * c * 2 * tokens, 1e-5, 1e-6, iters=10))
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

    kernels.reset_launch_counts()
    latencies, out = [], None
    for _ in range(ENHANCE_REQUESTS):
        t0 = time.perf_counter()
        out = pipe(src, tgt, return_intermediates=True)
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
    launches = kernels.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

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
           "peak_mem_gib": peak_gib, "launches": launches,
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

    # launches: K1-K3 on the aligned swaps of phase 3, K5 on the enhanced
    # swaps, K4 and K6 on the upscaler runs of their routes
    launches = {name: sum(main_path[m]["launches"][name] for m in main_path)
                for name in PER_CALL["exact"]}
    launches["fused_swin_block"] = enhance["launches"]["fused_swin_block"]
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
