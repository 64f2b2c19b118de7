"""Where the time of one swap goes, on a CUDA card.

    python -m e4s2024_torch.profile_swap [--mode exact|fast] [--dtype float32|bfloat16]
                                         [--enhance | --raw | --video | --zoo | --reenact]

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

With --zoo it profiles the zoo-enhanced swap, `FullFaceSwapPipeline` at
the reference's default configuration (`zoo_components`: GPEN-512, Blender
with RealESRGAN x4, GCFSR inpainting) over the float32 swapper: step 1
reports the device time of the pipeline's own stages from its `timer` hook
(pose_align, enhance, core_swap, parse19, recolor, inpaint, package), step
2 as above, with the peak device memory.

With --reenact it profiles the reenacted zoo swap: the --zoo pipeline
with `reenact_components` (faceVid2Vid at vox-256 and the Hopenet pose
estimator, seeded random weights) at pose_gap_threshold 0, so that every
call drives the source; the stage table splits pose_align into
pose_gate (Hopenet on both crops and the gate's host synchronisation) and
pose_drive (the 256^2 resizes, faceVid2Vid, the resize back).

With --video it runs the video swap instead, `FaceSwapVideoPipeline` over
the float32 swapper and the default landmark stack on `video_clip`'s 8-frame
1280x720 clip, with the three loss nets at their published widths (seeded
random weights) and PTI and stitching at the JAX package's defaults (80 and
100 steps), after a warm-up clip of one step each; it prints the stage times (the pipeline's `timer` hook),
the per-step times and the peak device memory.

Prints one JSON object per line; the last line holds the totals.
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import replace

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


def video_clip(frames: int = 8, size: tuple[int, int] = (720, 1280)):
    """A seeded smooth clip, each frame the same scene moved by 2 rows and 4
    columns from the last (coarse 40-pixel blocks plus a little noise,
    uint8), and `raw_frames`' 1280x960 source photo; chip_smoke.py's
    phase-6 clip."""
    h, w = size
    rng = np.random.default_rng(3)
    pad = 4 * frames
    scene = np.kron(rng.random(((h + pad) // 40 + 1, (w + pad) // 40 + 1, 3)),
                    np.ones((40, 40, 1))) * 200
    scene = (scene + rng.random(scene.shape) * 55).astype(np.uint8)
    clip = [np.ascontiguousarray(scene[2 * i:2 * i + h, 4 * i:4 * i + w]) for i in range(frames)]
    return raw_frames()[0], clip


def loss_nets(device, seed: int = 4) -> dict:
    """LPIPS AlexNet, IR-SE-50 ArcFace and the face-parsing U-Net at their
    published widths with PyTorch's default initialisation from a seed
    (LPIPS's lin heads made non-negative, as trained ones are), frozen on
    `device`: the video swap's criterion nets."""
    from e4s2024_torch.models.arcface import ArcFaceBackbone
    from e4s2024_torch.models.lpips import LPIPS
    from e4s2024_torch.models.parser_unet import ParsingUNet

    torch.manual_seed(seed)
    nets = {"lpips": LPIPS(), "arcface": ArcFaceBackbone(), "parser": ParsingUNet()}
    with torch.no_grad():
        for i in range(5):
            w = getattr(nets["lpips"], f"lin{i}").model[1].weight
            w.abs_()
    return {k: v.to(device).eval().requires_grad_(False) for k, v in nets.items()}


def zoo_components(device, seed: int = 5) -> SwapComponents:
    """The reference's default zoo at its published widths with PyTorch's
    seeded default initialisation: GPEN-512 (channel multiplier 2, narrow
    1; its concat-noise weights set to 0.1, so that the encoder's features
    reach the decoder as in a trained net) as the "gpen" enhancer, the
    Blender recolorer, RealESRGAN RRDBNet 64/23/32 and GCFSR at 256."""
    from e4s2024_torch.models.blender import Blender, BlenderRecolorer
    from e4s2024_torch.models.gcfsr import FaceInpainter, FaceInpainting
    from e4s2024_torch.models.gpen import GPENEnhancer, GPENFullGenerator
    from e4s2024_torch.models.rrdb import RealESRGANUpscaler, RRDBNet

    torch.manual_seed(seed)
    gpen = {k: v.fill_(0.1) if k.endswith("noise.weight") else v
            for k, v in GPENFullGenerator().state_dict().items()}
    return SwapComponents(
        enhancers={"gpen": GPENEnhancer(gpen, device=device).enhance_aligned},
        recolorer=BlenderRecolorer(Blender().state_dict(), device=device),
        upscaler=RealESRGANUpscaler(RRDBNet().state_dict(), device=device),
        inpainter=FaceInpainter(FaceInpainting().state_dict(), device=device))


def reenact_components(device, seed: int = 6) -> SwapComponents:
    """`zoo_components` plus the pose stage at published widths with
    PyTorch's seeded default initialisation: the faceVid2Vid driver at its
    vox-256 defaults and the Hopenet (ResNet-50) pose estimator."""
    from e4s2024_torch.models.facevid2vid import (
        FaceVid2VidDriver, HEEstimator, KPDetector, OcclusionAwareSPADEGenerator)
    from e4s2024_torch.models.hopenet import Hopenet, PoseEstimator

    comps = zoo_components(device)
    torch.manual_seed(seed)
    ckpt = {"kp_detector": KPDetector().state_dict(), "he_estimator": HEEstimator().state_dict(),
            "generator": OcclusionAwareSPADEGenerator().state_dict()}
    comps.pose_driver = FaceVid2VidDriver(ckpt, device=device)
    comps.pose_estimator = PoseEstimator(Hopenet().state_dict(), device=device)
    return comps


def profile_video(args) -> None:
    """The video swap at the JAX package's tuning defaults, stage by stage."""
    from e4s2024_torch.pipelines.video import FaceSwapVideoPipeline, StageTimer, VideoSwapConfig
    from e4s2024_torch.training.pti import PTIConfig, StitchingConfig

    torch.manual_seed(0)
    rgi_sd = RGINet().state_dict()
    sw = FaceSwapper(rgi_sd, BiSeNet().state_dict(), SwapConfig(regional_mode=args.mode),
                     landmark_fn=detect.default_landmarker())
    nets = loss_nets(sw.device)
    source, frames = video_clip()

    pti, stitching = PTIConfig(regional_mode=args.mode), StitchingConfig(regional_mode=args.mode)

    def pipeline(pti_steps, stitching_steps):
        cfg = VideoSwapConfig(pti=replace(pti, max_pti_steps=pti_steps),
                              stitching=replace(stitching, max_steps=stitching_steps))
        return FaceSwapVideoPipeline(sw, cfg, loss_params=nets)

    pipeline(1, 1)(source, frames)  # warm-up
    sw.rgi.load_state_dict(rgi_sd)  # undo the warm-up's write-back
    pipe = pipeline(pti.max_pti_steps, stitching.max_steps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timer = StageTimer()
    t0 = time.perf_counter()
    pipe(source, frames, timer=timer)
    wall_s = time.perf_counter() - t0
    for name, ms in timer.times.items():
        print(json.dumps({"stage": name, "device_ms": ms}))
    hist = pipe.histories
    print(json.dumps({
        "video": "FaceSwapVideoPipeline", "mode": args.mode, "frames": len(frames),
        "frame_hw": list(frames[0].shape[:2]), "pti_steps": pti.max_pti_steps,
        "stitching_steps": stitching.max_steps, "card": torch.cuda.get_device_name(0),
        "clip_s": wall_s, "s_per_frame": wall_s / len(frames),
        "ms_per_pti_step": timer.times["pti_tune"] / pti.max_pti_steps,
        "ms_per_stitching_step": timer.times["stitching_tune"] / stitching.max_steps,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "pti_loss_first_last": [hist["pti"][0]["loss"], hist["pti"][-1]["loss"]]
        if hist.get("pti") else None,
        "stitching_loss_first_last": [hist["stitching"][0]["loss"],
                                      hist["stitching"][-1]["loss"]]
        if hist.get("stitching") else None}))


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
    ap.add_argument("--video", action="store_true",
                    help="the video swap with PTI and stitching (FaceSwapVideoPipeline)")
    ap.add_argument("--zoo", action="store_true",
                    help="the zoo-enhanced swap at the default FullSwapConfig (GPEN, Blender + "
                         "RealESRGAN, GCFSR inpainting)")
    ap.add_argument("--reenact", action="store_true",
                    help="the reenacted zoo swap (--zoo with faceVid2Vid and the Hopenet gate)")
    args = ap.parse_args()
    if args.enhance + args.raw + args.video + args.zoo + args.reenact > 1:
        ap.error("--enhance, --raw, --video, --zoo and --reenact profile different swaps; "
                 "pick one")
    if not torch.cuda.is_available():
        raise SystemExit("profile_swap: no CUDA device is available")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.video:
        if args.dtype != "float32":
            ap.error("--video tunes in float32")
        profile_video(args)
        return

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
    if args.zoo or args.reenact:
        if args.dtype != "float32":
            ap.error("--zoo and --reenact run the float32 swapper (the zoo's nets are float32)")
        comps = reenact_components(sw.device) if args.reenact else zoo_components(sw.device)
        # threshold 0: every reenacted call drives the source
        pipe = FullFaceSwapPipeline(sw, comps, FullSwapConfig(face_inpainting=True,
                                                              pose_gap_threshold=0.0))
        swap = lambda: pipe(driven[0], target[0])  # noqa: E731
    for _ in range(2):
        swap()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    stages: dict = {}
    for _ in range(args.requests):
        d = driven
        if args.zoo or args.reenact:
            from e4s2024_torch.pipelines.video import StageTimer

            timer = StageTimer()
            pipe(driven[0], target[0], timer=timer)
            for name, ms in timer.times.items():
                stages.setdefault(name, {"host_ms": None, "device_ms": 0.0})["device_ms"] += ms
            continue
        if enhance is not None:
            with torch.inference_mode():
                d = _timed(stages, "enhance (SwinIR-M x4, resize back)",
                           lambda: enhance(torch.from_numpy(driven).cuda().float()))
        if args.raw:
            staged_raw_swap(sw, source, frame, stages)
        else:
            staged_swap(sw, d, target, stages)
    for name, rec in stages.items():
        print(json.dumps({"stage": name, **{
            k: None if rec[k] is None else rec[k] / args.requests
            for k in ("host_ms", "device_ms")}}))

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
    if args.zoo or args.reenact:
        groups += ["fused_leaky_relu_kernel"]
    for group in groups:
        hits = [e for e in events if group in e.key]
        print(json.dumps({
            "kernel_group": group, "calls_per_swap": sum(e.count for e in hits) / args.requests,
            "device_ms_per_swap": sum(e.self_device_time_total for e in hits) / 1e3
            / args.requests}))
    print(json.dumps({"mode": args.mode, "dtype": args.dtype, "enhance": args.enhance,
                      "raw": args.raw, "zoo": args.zoo, "reenact": args.reenact,
                      **({"last_gate": pipe.last_gate} if args.reenact else {}),
                      "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                      "card": torch.cuda.get_device_name(0),
                      "wall_ms_per_swap_traced": wall_ms, "device_busy_ms_per_swap": device_ms,
                      "device_busy_share": device_ms / wall_ms}))


if __name__ == "__main__":
    main()
