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

TIMEOUT_S = 90.0


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

    torch.set_num_threads(2)
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


# ------------------------------------------------------------ the trainer


def coach_steps(rank, group, inputs):
    """One G step and, from the same start, one D step with R1, of a Coach
    over the group on the global batch. Returns the group-mean metrics and
    the updated parameters of each."""
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
        out[kind] = (coach._host(metrics), {k: p.detach().clone() for k, p in params.items()})
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
