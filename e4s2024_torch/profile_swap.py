"""Where the time of one swap goes, on a CUDA card.

    python -m e4s2024_torch.profile_swap [--mode exact|fast] [--dtype float32|bfloat16]
                                         [--enhance | --raw]

Builds FaceSwapper at the default configuration (1024^2 output, full
encoder and parser) with seeded random weights (with --enhance, inside
FullFaceSwapPipeline with a full-width SwinIR-M "swinir" enhancer, the
enhanced swap; with --raw, over the default RetinaFace + 2DFAN4 landmark
stack with seeded random weights, the raw-frame swap `FaceSwapper.swap` of
a 1280x960 source onto a 1920x1080 target), warms it up, then:

1. runs the swap's stages one by one, each between two synchronisations, and
   reports per stage the host time and the device time (CUDA events); the
   raw swap's stages are upload, detect (x2), FAN (x2), crop (x2), the
   aligned swap and the paste-back;
2. traces whole swaps with torch.profiler and reports the device's busy
   share (the summed time of device-side events over wall time; overlapping
   streams would count twice, the swap uses one), the kernels that take
   the most device time, and the calls and device time per swap of K2
   (`upfirdn2d_kernel`) and K3 (`regional_scale_kernel`).

Prints one JSON object per line; the last line holds the totals.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.autograd import DeviceType

from e4s2024_torch.data.labels import FFHQ_TO_12, map_labels
from e4s2024_torch.models.bisenet import BiSeNet
from e4s2024_torch.models.rgi import RGINet
from e4s2024_torch.models.swinir import SwinIR, SwinIREnhancer, SwinIRUpscaler
from e4s2024_torch.pipelines.full_swap import FullFaceSwapPipeline, FullSwapConfig, SwapComponents
from e4s2024_torch.pipelines import detect
from e4s2024_torch.pipelines.alignment import compute_transform_from_landmarks, quad_from_cxy
from e4s2024_torch.pipelines.mask_merge import swap_comp_style_vector, swap_head_mask
from e4s2024_torch.pipelines.swap import FaceSwapper, SwapConfig


def _timed(stages: dict, name: str, fn):
    """Run fn between synchronisations; add its host and device ms."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3
    rec = stages.setdefault(name, {"host_ms": 0.0, "device_ms": 0.0})
    rec["host_ms"] += host
    rec["device_ms"] += start.elapsed_time(end)
    return out


def staged_swap(sw: FaceSwapper, driven, target, stages: dict):
    """FaceSwapper.swap_aligned, stage by stage (same calls, same order)."""
    with torch.inference_mode():
        pair = _timed(stages, "upload", lambda: torch.cat([sw._as_u8(driven), sw._as_u8(target)]))
        img01 = pair.permute(0, 3, 1, 2).float() / 255.0
        labels = _timed(stages, "parse (BiSeNet, 2 crops)", lambda: sw._parse19(img01))
        masks = map_labels(labels, FFHQ_TO_12)
        onehot = sw._onehot_for_model(masks)
        sv, _ = _timed(stages, "invert (IR-SE-50, 2 crops)", lambda: sw.rgi.get_style_vectors(
            (img01 * 2.0 - 1.0).to(sw.dtype), onehot))
        t255 = pair[1:]
        merged = _timed(stages, "mask merge + style mix", lambda: (
            swap_head_mask(masks[:1], masks[1:]),
            swap_comp_style_vector(sv[1:], sv[:1], sw._comp)))
        (merged, swapped_sv) = merged
        codes = sw.rgi.cal_style_codes(swapped_sv.to(sw.dtype))
        seg = sw._onehot_for_model(merged["mask"])
        image = _timed(stages, "synthesis (generator)", lambda: sw.rgi.gen_img(
            None, codes, seg, regional_mode=sw.cfg.regional_mode)[0])
        t_pm1 = t255.permute(0, 3, 1, 2).float() / 127.5 - 1.0
        return _timed(stages, "composite", lambda: sw._composite(
            image.float(), t_pm1, merged["mask"], merged["hole_mask"]))


def raw_frames():
    """A seeded smooth 1280x960 source photo and 1920x1080 target frame
    (coarse 40-pixel blocks plus a little noise, uint8), also chip_smoke.py's
    phase-5 frames."""
    rng = np.random.default_rng(2)
    out = []
    for h, w in ((960, 1280), (1080, 1920)):
        img = np.kron(rng.random((h // 40, w // 40, 3)), np.ones((40, 40, 1))) * 200
        out.append((img + rng.random(img.shape) * 55).astype(np.uint8))
    return out


def staged_raw_swap(sw: FaceSwapper, source, target, stages: dict):
    """FaceSwapper.swap with the package's landmark stack, stage by stage
    (same calls, same order)."""
    stack = sw.landmark_fn
    crops, quads, frame = [], [], None
    for img in (source, target):
        frame = _timed(stages, "upload (2 uint8 frames)", lambda: detect.upload(img, sw.device))
        boxes = _timed(stages, "detect (RetinaFace, 2 frames)",
                       lambda: stack.detector.detect(frame)[0])
        lm = _timed(stages, "landmarks (FAN, 2 faces)",
                    lambda: stack.landmarker.landmarks(frame, boxes[:1])[0])
        quads.append(quad_from_cxy(*compute_transform_from_landmarks(lm)))
        crops.append(_timed(stages, "crop (2 quads)", lambda: sw._crop(frame, quads[-1])[None]))
    swapped = _timed(stages, "aligned swap", lambda: sw._swap_crops(crops[0], crops[1], None))
    return _timed(stages, "paste-back (1920x1080)",
                  lambda: sw._paste_back(frame, swapped, quads[1:]))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="exact", choices=("exact", "fast"))
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--trace", default="", help="write a chrome trace here")
    ap.add_argument("--enhance", action="store_true",
                    help="the SwinIR-enhanced swap (FullFaceSwapPipeline)")
    ap.add_argument("--raw", action="store_true",
                    help="the raw-frame swap (FaceSwapper.swap with the default landmark stack)")
    args = ap.parse_args()
    if args.enhance and args.raw:
        ap.error("--enhance and --raw profile different swaps; pick one")
    if not torch.cuda.is_available():
        raise SystemExit("profile_swap: no CUDA device is available")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    torch.manual_seed(0)
    sw = FaceSwapper(RGINet().state_dict(), BiSeNet().state_dict(),
                     SwapConfig(regional_mode=args.mode, compute_dtype=args.dtype))
    rng = np.random.default_rng(0)
    driven, target = (rng.random((2, 1, 1024, 1024, 3)) * 255).astype(np.uint8)
    swap = lambda: sw.swap_aligned(driven, target)  # noqa: E731
    enhance = None
    if args.enhance:
        enhance = SwinIREnhancer(SwinIRUpscaler(SwinIR().state_dict(),
                                                compute_dtype=args.dtype)).enhance_aligned
        pipe = FullFaceSwapPipeline(sw, SwapComponents(enhancers={"swinir": enhance}),
                                    FullSwapConfig(enhancement_mode="swinir"))
        swap = lambda: pipe(driven[0], target[0])  # noqa: E731
    if args.raw:
        sw.landmark_fn = detect.default_landmarker()
        source, frame = raw_frames()
        swap = lambda: sw.swap(source, frame)  # noqa: E731
    for _ in range(2):
        swap()
    torch.cuda.synchronize()

    stages: dict = {}
    for _ in range(args.requests):
        d = driven
        if enhance is not None:
            with torch.inference_mode():
                d = _timed(stages, "enhance (SwinIR-M x4, resize back)",
                           lambda: enhance(torch.from_numpy(driven).cuda().float()))
        if args.raw:
            staged_raw_swap(sw, source, frame, stages)
        else:
            staged_swap(sw, d, target, stages)
    for name, rec in stages.items():
        print(json.dumps({"stage": name, "host_ms": rec["host_ms"] / args.requests,
                          "device_ms": rec["device_ms"] / args.requests}))

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.requests):
            swap()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.requests
    if args.trace:
        prof.export_chrome_trace(args.trace)
    # device-side events only (kernels, copies): the host ops that launch
    # them report the same time again
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    device_ms = sum(e.self_device_time_total for e in events) / 1e3 / args.requests
    for e in events[:15]:
        print(json.dumps({"kernel": e.key[:90], "calls_per_swap": e.count / args.requests,
                          "device_ms_per_swap": e.self_device_time_total / 1e3 / args.requests}))
    # K2 and K3 over the aligned swap; with --enhance also K5 and the rolls it
    # took over (the fused route runs none)
    groups = ["upfirdn2d_kernel", "regional_scale_kernel"]
    if args.enhance:
        groups += ["swin_block_kernel", "roll_cuda"]
    for group in groups:
        hits = [e for e in events if group in e.key]
        print(json.dumps({
            "kernel_group": group, "calls_per_swap": sum(e.count for e in hits) / args.requests,
            "device_ms_per_swap": sum(e.self_device_time_total for e in hits) / 1e3
            / args.requests}))
    print(json.dumps({"mode": args.mode, "dtype": args.dtype, "enhance": args.enhance,
                      "raw": args.raw,
                      "card": torch.cuda.get_device_name(0),
                      "wall_ms_per_swap_traced": wall_ms, "device_busy_ms_per_swap": device_ms,
                      "device_busy_share": device_ms / wall_ms}))


if __name__ == "__main__":
    main()
