"""Running the port on several CPU ranks at once, for the world-size-2
tests (`tests/test_torch_{ddp_world2,pti_group,shard_serving}.py`).

`start_ranks` spawns one process per rank (the `spawn` start method: no
fork of a process that has started JAX), each on two torch threads; each
joins a gloo group over a `FileStore` in the test's temporary directory
and calls a rank function of this module with its inputs from a torch
file. It returns at once, so that the test process computes JAX's side
meanwhile; `.join()` brings each rank's result back through a torch file.
A rank that has not finished within the timeout is killed and the run
fails, so a deadlock fails its test instead of eating the suite's time.

This module imports torch and the port only: the children import it, and
JAX must not start in them.
"""

from __future__ import annotations

import multiprocessing
import os
import shutil
import time
import traceback
import uuid
from pathlib import Path

import torch

TIMEOUT_S = 240.0


def start_ranks(fn, inputs, tmp_path: Path, world: int = 2, timeout: float = TIMEOUT_S):
    """Start `fn(rank, group, inputs)` on `world` spawned ranks and return
    at once; `.join()` on the result waits for them (the caller may work
    meanwhile: the timeout runs from the start)."""
    return _Ranks(fn, inputs, tmp_path, world, timeout)


class _Ranks:
    def __init__(self, fn, inputs, tmp_path, world, timeout):
        self.run = tmp_path / f"ranks_{uuid.uuid4().hex[:8]}"
        self.run.mkdir()
        self.world, self.timeout = world, timeout
        torch.save(inputs, self.run / "inputs.pt")
        ctx = multiprocessing.get_context("spawn")
        self.procs = [ctx.Process(target=_child, args=(fn, rank, world, str(self.run)),
                                  daemon=True) for rank in range(world)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + timeout

    def join(self) -> list:
        """The ranks' results in rank order. Raises AssertionError with the
        children's tracebacks when a rank fails, or when the ranks have not
        all finished within the timeout (they are killed)."""
        run, procs = self.run, self.procs
        try:
            for p in procs:
                p.join(max(self.deadline - time.monotonic(), 0.0))
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            errors = [(run / f"error{r}.txt").read_text() for r in range(self.world)
                      if (run / f"error{r}.txt").exists()]
            if hung:
                raise AssertionError(f"ranks {hung} still running after {self.timeout} s "
                                     "(killed)\n" + "\n".join(errors))
            if errors or any(p.exitcode != 0 for p in procs):
                raise AssertionError(f"exit codes {[p.exitcode for p in procs]}\n"
                                     + "\n".join(errors))
            return [torch.load(run / f"result{r}.pt", weights_only=False)
                    for r in range(self.world)]
        finally:
            # the inputs and results are hundreds of MB each
            shutil.rmtree(run, ignore_errors=True)


def _child(fn, rank: int, world: int, run: str) -> None:
    import torch.distributed as dist

    from e4s2024_torch.parallel.ddp import make_process_group

    # one thread: a rank's ops are small, and the suite's other processes
    # share the cores (two threads cost a fifth more CPU time for the same
    # steps, spinning between ops)
    torch.set_num_threads(1)
    run = Path(run)
    try:
        inputs = torch.load(run / "inputs.pt", weights_only=False)
        group = make_process_group(world, rank, device="cpu",
                                   store=dist.FileStore(str(run / "store"), world))
        try:
            result = fn(rank, group, inputs)
        finally:
            dist.destroy_process_group()
        torch.save(result, run / f"result{rank}.pt")
    except BaseException:
        (run / f"error{rank}.txt").write_text(f"rank {rank}:\n{traceback.format_exc()}")
        os._exit(1)


def release_memory() -> None:
    """Give a finished test module's memory back to the system: Python's
    garbage, then the heap's free pages (glibc keeps them otherwise). A
    worker of the suite runs many modules; without this its resident size
    stays near its largest module's (5.1 GB after four of the port's
    heavier modules on an 8-core CPU, against 2.0 GB with it), and six such
    workers plus spawned ranks ran a 62 GB machine out of memory."""
    import ctypes
    import gc

    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):
        pass


# ------------------------------------------------------------ the trainer


def coach_steps(rank, group, inputs):
    """One G step and, from the same start, one D step with R1, of a Coach
    over the group on the global batch. Returns, for each, the group-mean
    metrics, the updated parameters (rank 0's only: the result files stay
    small) and whether they equal rank 0's."""
    from e4s2024_torch.training.coach import Coach, TrainConfig

    coach = Coach(TrainConfig(**inputs["cfg"]), process_group=group, device="cpu")
    state = coach.init_state(torch.Generator().manual_seed(0))
    img, onehot = inputs["batch"]
    out = {}
    for kind in ("g", "d_r1"):
        state = coach.load_tree(state, inputs["tree"])
        if kind == "g":
            state, metrics = coach.g_step(state, img, onehot)
            params = state.params
        else:
            state, metrics = coach.d_step(state, img, onehot, with_r1=True)
            params = state.d_params
        out[kind] = (coach._host(metrics),
                     {k: p.detach().clone() for k, p in params.items()} if rank == 0 else None,
                     _equal_to_rank0(params.values()))
    return out


def disc_forward(rank, group, inputs):
    """The Discriminator's logits over the group on this rank's rows of the
    global batch, and R1 of the global batch (the group mean of each
    rank's mean)."""
    from e4s2024_torch.losses.losses import r1_penalty
    from e4s2024_torch.models.stylegan2 import Discriminator
    from e4s2024_torch.parallel.ddp import gather_rows, mean_over_group, shard_rows

    disc = Discriminator(inputs["size"], 1)
    disc.load_state_dict(inputs["sd"])
    disc.process_group = group
    x = shard_rows(inputs["x"], group)
    with torch.no_grad():
        logits = gather_rows(disc(x), group)
    r1 = mean_over_group(r1_penalty(disc, x).detach().reshape(1), group)
    return {"logits": logits, "r1": float(r1)}



def trainer_world(rank, group, inputs):
    """`coach_steps` and `disc_forward`, and the refusal of a batch that
    the world does not divide."""
    from e4s2024_torch.parallel.ddp import shard_rows

    try:
        shard_rows(torch.zeros(3), group)
        refused = None
    except ValueError as err:
        refused = str(err)
    return {"coach": coach_steps(rank, group, inputs), "disc": disc_forward(rank, group, inputs),
            "refused": refused}


# ------------------------------------------------------------ the video tunes


def fake_landmarks(img):
    """tests/test_video_pipeline.py's hook: a fixed face in every frame."""
    import numpy as np

    h, w = img.shape[:2]
    lm = np.zeros((68, 2))
    lm[36:42] = [w * 0.35, h * 0.4]
    lm[42:48] = [w * 0.65, h * 0.4]
    lm[48] = [w * 0.4, h * 0.7]
    lm[54] = [w * 0.6, h * 0.7]
    return lm


def fingerprint(sd) -> list[tuple[float, float]]:
    """Each tensor's sum and sum of squares in float64: equal on two ranks
    that hold the same weights."""
    return [(float(v.double().sum()), float(v.double().square().sum())) for v in sd.values()]


def video_swapper(inputs):
    """The port's swapper of the clip test (`inputs["swapper"]`: the RGI and
    BiSeNet state dicts and the config), landmarks from `fake_landmarks`."""
    from e4s2024_torch.pipelines.swap import FaceSwapper, SwapConfig

    sw = inputs["swapper"]
    return FaceSwapper(sw["rgi"], sw["bisenet"], SwapConfig(**sw["cfg"]),
                       landmark_fn=fake_landmarks, device="cpu",
                       encoder_num_units=sw["units"])


def video_clip(swapper, inputs, group=None):
    """One clip through `FaceSwapVideoPipeline(process_group=group)`: (frames,
    histories, the swapper's tuned weights)."""
    from e4s2024_torch.pipelines.video import FaceSwapVideoPipeline, VideoSwapConfig
    from e4s2024_torch.pipelines.swap import SwapConfig
    from e4s2024_torch.training.pti import PTIConfig, StitchingConfig

    v = inputs["video"]
    cfg = VideoSwapConfig(swap=SwapConfig(**inputs["swapper"]["cfg"]),
                          pti=PTIConfig(**v["pti"]), stitching=StitchingConfig(**v["stitching"]),
                          frames_per_batch=v["frames_per_batch"])
    pipe = FaceSwapVideoPipeline(swapper, cfg, process_group=group)
    outs = pipe(v["source"], v["frames"])
    return outs, pipe.histories, pipe.is_output_rank


def tuning_world(rank, group, inputs):
    """PTICoach and StitchingCoach over the group from the same weights, the
    fingerprint of each rank's weights after each, and the refusal of a
    frame count that the world does not divide."""
    from e4s2024_torch.models.rgi import RGINet
    from e4s2024_torch.training.pti import PTICoach, PTIConfig, StitchingCoach, StitchingConfig

    net = RGINet(num_seg_cls=12, **inputs["net"])
    net.load_state_dict(inputs["sd"])
    net.eval()
    out = {}
    pti = PTICoach(net, {}, PTIConfig(**inputs["pti"]), process_group=group)
    tuned, hist = pti.tune(None, *inputs["pti_clip"], steps=inputs["steps"])
    out["pti"] = (tuned if rank == 0 else None, hist, fingerprint(tuned))
    stitch = StitchingCoach(net, {}, StitchingConfig(**inputs["stitching"]), process_group=group)
    tuned, hist = stitch.tune(None, *inputs["stitch_clip"], steps=inputs["steps"])
    out["stitching"] = (tuned if rank == 0 else None, hist, fingerprint(tuned))
    try:
        pti.tune(None, *(x[:3] for x in inputs["pti_clip"]), steps=1)
        out["refused"] = None
    except ValueError as err:
        out["refused"] = str(err)
    return out


# ------------------------------------------------------------ serving


def serving_world(rank, group, inputs):
    """`FullFaceSwapPipeline.swap_batch` after `shard_inference(group)` on
    the whole pair batch, the refusal of a batch that the world does not
    divide, then one clip through the video pipeline over the group (its
    swapper the serving one's: the clip writes its tuned weights back)."""
    from e4s2024_torch.pipelines.full_swap import (FullFaceSwapPipeline, FullSwapConfig,
                                                   SwapComponents)

    swapper = video_swapper(inputs)
    pipe = FullFaceSwapPipeline(swapper, SwapComponents(), FullSwapConfig(ct_mode="none"))
    pipe.shard_inference(group)
    src, tgt = inputs["pairs"]
    out = {"batch": pipe.swap_batch(src, tgt)}
    try:
        pipe.swap_batch(src[:3], tgt[:3])
        out["refused"] = None
    except ValueError as err:
        out["refused"] = str(err)
    frames, hist, is_output = video_clip(swapper, inputs, group)
    out["video"] = (frames, hist, is_output, fingerprint(swapper.rgi.state_dict()))
    return out


# ------------------------------------------------------------ the (dp, sp) grid


def _seeded(seed: int, *shape) -> torch.Tensor:
    import numpy as np

    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32))


def _onehot(seed: int, b: int, k: int, h: int, w: int) -> torch.Tensor:
    import numpy as np

    labels = np.random.default_rng(seed).integers(0, k, (b, h, w))
    return torch.from_numpy(np.eye(k, dtype=np.float32)[labels].transpose(0, 3, 1, 2).copy())


def _worst(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(largest |got - want|, largest |want|); shapes must agree (None for
    no gradient on either side agrees)."""
    if got is None or want is None:
        return (0.0, 0.0) if got is None and want is None else (float("inf"), 0.0)
    if got.shape != want.shape:
        return float("inf"), 0.0
    if not want.numel():
        return 0.0, 0.0
    return float((got - want).abs().max()), float(want.abs().max())


def split_case(split, fn, tensors, *, module=None, replicated=False, double=False,
               uneven=False, skip_params=()):
    """One op or net (`fn`) run whole and, under `split`, on this rank's
    slabs of the same 4-D tensors (`tensors`; others pass whole), with the
    same seeded weights on its output. `replicated`: fn's output is whole
    on every rank, and the backward runs from the rank's share of it;
    `double`: the loss is the input gradient's inner product with seeded
    weights (a second derivative, as R1 takes), and "grad" compares its
    gradient in the output weights; `uneven`: fn returns (its
    output, the output rows of every rank). Returns {"fwd", "grad",
    "params"} as (error, scale) pairs: this rank's rows of the output and
    of the first input's gradient, and the parameter gradients summed over
    the ranks against the whole run's (the worst relative one)."""
    import torch.distributed as dist

    from e4s2024_torch.parallel import spatial

    n, s = split.size, split.index

    def slab(t):
        h = t.shape[-2] // n
        return t.narrow(-2, s * h, h)

    shapes = {}

    def run(inputs, under):
        if module is not None:
            module.zero_grad()
        x = inputs[0].clone().requires_grad_(True)
        rows = None
        with spatial.row_split(under):
            out = fn(x, *inputs[1:])
            if uneven:
                out, owned = out
                rows = owned[s] if under is not None else None
            shapes.setdefault("y", out.shape)
            gy = _seeded(5, *shapes["y"])
            if under is not None and not replicated:
                gy = gy.narrow(-2, rows[0], rows[1] - rows[0]) if uneven else slab(gy)
            gy = gy.clone().requires_grad_(double)
            loss = (out * gy).sum()
            if under is not None and replicated:
                loss = spatial.share(loss)
            if double:
                (g,) = torch.autograd.grad(loss, x, create_graph=True)
                gg = _seeded(6, *tensors[0].shape)
                loss = (g * (gg if under is None else slab(gg))).sum()
            loss.backward()
        grads = {k: (p.grad.clone() if p.grad is not None else torch.zeros_like(p))
                 for k, p in (module.named_parameters() if module is not None else ())}
        return out.detach(), rows, gy.grad if double else x.grad, grads

    y, _, gx, gp = run(tensors, None)
    ys, rows, gxs, gps = run([slab(t) if t.ndim == 4 else t for t in tensors], split)
    def want_rows(t):
        return t if replicated else (t.narrow(-2, rows[0], rows[1] - rows[0]) if uneven
                                     else slab(t))

    want = want_rows(y)
    worst_params = (0.0, 1.0)
    for k, g in gp.items():
        if any(part in k for part in skip_params):
            continue
        total = gps[k].clone()
        dist.all_reduce(total, group=split.group)
        err, scale = _worst(total, g)
        if err / max(scale, 1e-30) > worst_params[0] / max(worst_params[1], 1e-30):
            worst_params = (err, scale)
    # a second derivative's gradient is that of the output weights (the
    # backward differentiated in its incoming gradient), shaped as the output
    if gx is not None:
        gx = want_rows(gx) if double else slab(gx)
    return {"fwd": _worst(ys, want), "grad": _worst(gxs, gx),
            "params": worst_params}


def split_ops_cases():
    """The partitioned ops and nets of tests/test_torch_sp_ops.py: name ->
    (fn, tensors, options of `split_case`). Seeded numpy tensors; the nets
    at narrow widths."""
    import torch.nn.functional as F

    from e4s2024_torch.losses.losses import multiscale_lpips, r1_penalty
    from e4s2024_torch.losses.recon import ReconCriterion
    from e4s2024_torch.models.arcface import ArcFaceBackbone
    from e4s2024_torch.models.encoders import FSEncoderPSP, instance_norm, masked_average_pool
    from e4s2024_torch.models.lpips import LPIPS
    from e4s2024_torch.models.parser_unet import ParsingUNet
    from e4s2024_torch.models.stylegan2 import ConvLayer, Discriminator, Generator
    from e4s2024_torch.ops.modconv import modulated_conv2d, regional_modulated_conv2d
    from e4s2024_torch.ops.resize import resize_bilinear, resize_nearest
    from e4s2024_torch.ops.upfirdn import blur, downsample_2x, make_kernel, upsample_2x
    from e4s2024_torch.parallel import spatial

    x = _seeded(1, 2, 4, 16, 12)
    w3, w1 = _seeded(2, 5, 4, 3, 3), _seeded(3, 5, 4, 1, 1)
    fir = make_kernel([1, 3, 3, 1])
    styles, style = _seeded(4, 2, 3, 4), _seeded(7, 2, 4)
    seg8 = _onehot(8, 2, 3, 8, 8)
    torch.manual_seed(0)
    conv_layer = ConvLayer(4, 5, 3, downsample=True)

    def regional(mode, up):
        return lambda t, sg: regional_modulated_conv2d(t, w3, styles, sg, up=up,
                                                       blur_kernel=fir, mode=mode)

    def alexnet_head(t):
        extents = spatial.even_extents(t.shape[-2])
        t, extents = spatial.conv2d_rows(t, lpips_net.features[0].weight,
                                         lpips_net.features[0].bias, 4, 2, extents)
        t, extents = spatial.max_pool2d(torch.relu(t), 3, 2, extents)
        return spatial.conv2d_rows(t, lpips_net.features[3].weight, lpips_net.features[3].bias,
                                   1, 2, extents)

    def alexnet_whole(t):
        f = lpips_net.features
        return f[3](f[2](f[1](f[0](t))))

    def alexnet(t):
        if spatial.active() is None:
            return alexnet_whole(t), [(0, 7)]
        return alexnet_head(t)

    def max_pool(t):
        if spatial.active() is None:
            return F.max_pool2d(t, 3, 2), [(0, 7)]
        return spatial.max_pool2d(t, 3, 2, spatial.even_extents(t.shape[-2]))

    torch.manual_seed(1)
    gen = Generator(16, channel_multiplier=1, remaining_layer_idx=5)
    latent = _seeded(9, 2, 3, gen.n_latent, 512)
    seg16 = _onehot(10, 2, 3, 16, 16)
    disc = Discriminator(16, 1)
    enc = FSEncoderPSP((1, 1, 1, 1))
    lpips_net = LPIPS()
    parser = ParsingUNet(feature_scale=16)
    with torch.no_grad():
        for i in range(5):
            getattr(lpips_net, f"lin{i}").model[1].weight.abs_()
    nets = {"lpips": lpips_net, "arcface": ArcFaceBackbone(), "parser": parser}
    criterion = ReconCriterion(nets)
    img64, recon64 = torch.tanh(_seeded(11, 2, 3, 64, 64)), torch.tanh(_seeded(12, 2, 3, 64, 64))
    img16 = torch.tanh(_seeded(13, 2, 3, 16, 16))
    img32 = torch.tanh(_seeded(14, 2, 3, 32, 32))

    w5 = _seeded(15, 5, 4, 5, 5)
    return {
        "conv3x3": (lambda t: spatial.conv2d(t, w3, None, 1, 1), [x], {"double": True}),
        # 4 rows: over 4 ranks the 5x5 halo reaches the neighbour's neighbour
        "conv5x5_far_halo": (lambda t: spatial.conv2d(t, w5, None, 1, 2), [x[:, :, :4]],
                             {"double": True}),
        "conv3x3_stride2": (lambda t: spatial.conv2d(t, w3, None, 2, 1), [x], {"double": True}),
        "conv1x1_stride2": (lambda t: spatial.conv2d(t, w1, None, 2, 0), [x], {}),
        "transposed_conv_blur": (lambda t: modulated_conv2d(t, w3, style, up=True,
                                                            blur_kernel=fir), [x], {}),
        "regional_exact": (regional("exact", False), [x, seg8], {}),
        "regional_exact_up": (regional("exact", True), [x, seg8], {}),
        "regional_fast": (regional("fast", False), [x, seg8], {}),
        "regional_fast_up": (regional("fast", True), [x, seg8], {}),
        "upfirdn_up": (lambda t: upsample_2x(t, fir), [x], {"double": True}),
        "upfirdn_down": (lambda t: downsample_2x(t, fir), [x], {"double": True}),
        "upfirdn_blur_pads_2_1": (lambda t: blur(t, fir, (2, 1), upsample_factor=2), [x],
                                  {"double": True}),
        "blur_conv_stride2": (conv_layer, [x], {"module": conv_layer, "double": True}),
        "nearest_down": (lambda t: resize_nearest(t, (t.shape[-2] // 2, 6)), [x], {}),
        "nearest_up": (lambda t: resize_nearest(t, (t.shape[-2] * 2, 24)), [x], {}),
        "nearest_16_to_6": (lambda t: resize_nearest(t, (t.shape[-2] * 3 // 8, 5)), [x], {}),
        "bilinear_1024_to_256_ratio": (lambda t: resize_bilinear(t, (t.shape[-2] // 4, 3)),
                                       [x], {}),
        "bilinear_up": (lambda t: resize_bilinear(t, (t.shape[-2] * 2, 24)), [x], {}),
        "instance_norm": (instance_norm, [x], {}),
        "masked_average_pool": (lambda t, sg: masked_average_pool(t, sg), [x, seg8],
                                {"replicated": True}),
        "max_pool_uneven": (max_pool, [x], {"uneven": True}),
        "alexnet_uneven_rows": (alexnet, [img64], {"uneven": True, "module": lpips_net}),
        "generator_exact": (lambda sg: gen(latent, None, sg, regional_mode="exact")[0],
                            [seg16], {"module": gen}),
        "generator_fast": (lambda sg: gen(latent, None, sg, regional_mode="fast")[0],
                           [seg16], {"module": gen}),
        "discriminator": (disc, [img16], {"module": disc, "replicated": True}),
        "discriminator_r1": (lambda t: r1_penalty(disc, t).reshape(1), [img16],
                             {"module": disc, "replicated": True}),
        # the SE MLPs read a zero mean: their gradients are rounding noise
        "encoder": (lambda t, sg: enc(t, sg)[0], [img32, seg16],
                    {"module": enc, "replicated": True, "skip_params": (".fc",)}),
        "lpips_multiscale": (lambda a, b: multiscale_lpips(lpips_net, a, b).reshape(1),
                             [recon64, img64], {"replicated": True}),
        "recon_criterion": (lambda a, b: torch.stack(
            [v for k, v in sorted(criterion(a, b)[1].items())]), [recon64, img64],
            {"replicated": True}),
    }


def sp_ops(rank, group, inputs):
    """Every case of `split_ops_cases` (or those named in `inputs`) at a
    height split over the whole group: {name: split_case's result}."""
    from e4s2024_torch.parallel.spatial import RowSplit

    split = RowSplit(group, dist_world(group), rank)
    cases = split_ops_cases()
    out = {}
    for name in inputs.get("names") or cases:
        fn, tensors, opts = cases[name]
        out[name] = split_case(split, fn, tensors, **opts)
    return out


def dist_world(group) -> int:
    import torch.distributed as dist

    return dist.get_world_size(group)


def _equal_to_rank0(tensors) -> bool:
    """Whether every tensor equals world rank 0's (broadcast, compared
    exactly)."""
    import torch.distributed as dist

    same = True
    for t in tensors:
        ref = t.detach().clone()
        dist.broadcast(ref, 0)
        same = same and torch.equal(ref, t.detach())
    return same


def grid_world(rank, group, inputs):
    """`Coach(process_group=make_process_grid(dp, sp))` on the global batch:
    for each step kind of `inputs["kinds"]` ("g", "g_remat": a G step with
    remat, "d_r1": a D step with R1), from the same weights, the metrics,
    the updated parameters (world rank 0's) and whether every rank's equal
    rank 0's; the refusals of an indivisible height and of a scale the
    nets reach that sp does not divide; and the `sp_ops` cases named in
    `inputs["world_split"]` at a split over the whole world."""
    from e4s2024_torch.parallel.ddp import make_process_grid
    from e4s2024_torch.parallel.spatial import RowSplit
    from e4s2024_torch.training.coach import Coach, TrainConfig

    grid = make_process_grid(*inputs["grid"])
    img, onehot = inputs["batch"]
    out, coaches = {}, {}
    for kind in inputs["kinds"]:
        # one Coach (and one set of nets) for each remat setting
        remat = kind == "g_remat"
        if remat not in coaches:
            coach = Coach(TrainConfig(**inputs["cfg"], remat=remat), process_group=grid,
                          device="cpu")
            coaches[remat] = (coach, coach.init_state(torch.Generator().manual_seed(0)))
        coach, state = coaches[remat]
        state = coach.load_tree(state, inputs["tree"])
        if kind.startswith("g"):
            state, metrics = coach.g_step(state, img, onehot)
            params = state.params
        else:
            state, metrics = coach.d_step(state, img, onehot, with_r1=True)
            params = state.d_params
        out[kind] = (coach._host(metrics),
                     {k: p.detach().clone() for k, p in params.items()} if rank == 0 else None,
                     _equal_to_rank0(params.values()))
    refused = []
    for cfg, x in ((inputs["cfg"], img[:, :, :-1]),
                   ({**inputs["cfg"], "encoder_input_size": 16}, img)):
        # the refusal reads the config and the grid; the nets are the steps'
        coach = Coach(TrainConfig(**cfg), process_group=grid, device="cpu")
        try:
            coach._local(state, x)
            refused.append(None)
        except ValueError as err:
            refused.append(str(err))
    out["refused"] = refused
    names = inputs.get("world_split")
    if names:
        cases = split_ops_cases()
        split = RowSplit(group, dist_world(group), rank)
        out["world_split"] = {name: split_case(split, cases[name][0], cases[name][1],
                                               **cases[name][2]) for name in names}
    return out
