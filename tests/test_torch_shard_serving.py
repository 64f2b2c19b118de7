"""The port's sharded serving at world size 2 (two spawned CPU ranks over
gloo): `FullFaceSwapPipeline.shard_inference(process_group)` then
`swap_batch` of 4 pairs on every rank, against the JAX package's
`shard_inference(make_mesh(2))`; the refusals (a batch the world does not
divide, a configuration that takes the staged path); and one tiny clip
through `FaceSwapVideoPipeline(process_group=)` against the port's own run
of the same clip without a group.

The swapper is tests/test_torch_clip.py's (64^2 output, remaining_layer_idx
7, 3 blend levels, one encoder unit a group, numpy-seeded weights, its
fixed landmark hook) in fast regional mode, with no enhancer and ct_mode
"none": the configuration of JAX's own sharded-serving test, whose fused
program is the core swap. The port's clip without a group runs in this
process while the ranks run theirs.
"""

import numpy as np
import pytest

from e4s2024_tpu.parallel import make_mesh
from e4s2024_tpu.pipelines.swap import FaceSwapper as JFaceSwapper
from e4s2024_tpu.pipelines.swap import SwapConfig as JSwapConfig
from e4s2024_tpu.pipelines.full_swap import FullFaceSwapPipeline as JFullFaceSwapPipeline
from e4s2024_tpu.pipelines.full_swap import FullSwapConfig as JFullSwapConfig
from e4s2024_tpu.pipelines.full_swap import SwapComponents as JSwapComponents

from e4s2024_torch.convert import bisenet_state_dict_from_jax, rgi_state_dict_from_jax
from e4s2024_torch.pipelines.full_swap import FullFaceSwapPipeline, FullSwapConfig, SwapComponents
from tests.test_torch_clip import LEVELS, REMAINING, SIZE, UNITS, fake_landmarks, make_weights
from tests.test_torch_clip import _clip as _video_clip
from tests.test_torch_coach import module_threads  # noqa: F401
from tests.test_torch_coaches import _assert_history
from tests.torch_ranks import serving_world, start_ranks, video_clip, video_swapper

SWAP = dict(out_size=SIZE, remaining_layer_idx=REMAINING, num_blend_levels=LEVELS,
            regional_mode="fast")


def _pairs(seed, b):
    """b smooth aligned 64^2 pairs, uint8."""
    rng = np.random.default_rng(seed)
    coarse = rng.random((2, b, 8, 8, 3))
    img = np.kron(coarse, np.ones((1, 1, SIZE // 8, SIZE // 8, 1))) * 200
    img += rng.random(img.shape) * 55
    return img[0].astype(np.uint8), img[1].astype(np.uint8)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, module_threads):
    weights = make_weights()
    _, rgi_vars, bise = weights
    src, tgt = _pairs(41, 4)
    source, frames = _video_clip(23, n=2)
    inputs = {
        "pairs": (src, tgt),
        "swapper": {"rgi": rgi_state_dict_from_jax(rgi_vars),
                    "bisenet": bisenet_state_dict_from_jax(bise), "units": UNITS,
                    "cfg": SWAP},
        "video": {"source": source, "frames": frames, "frames_per_batch": 2,
                  "pti": dict(max_pti_steps=1, regional_mode="fast", remat=False),
                  "stitching": dict(max_steps=0)}}
    ranks = start_ranks(serving_world, inputs, tmp_path_factory.mktemp("serving"))

    jrgi, rgi_vars, bise = weights
    jswap = JFaceSwapper(rgi_vars, bise, JSwapConfig(**SWAP), landmark_fn=fake_landmarks)
    jswap.rgi = jrgi  # the JAX swapper builds the full-depth encoder
    jpipe = JFullFaceSwapPipeline(jswap, JSwapComponents(), JFullSwapConfig(ct_mode="none"))
    jpipe.shard_inference(make_mesh(2))
    want = np.asarray(jpipe.swap_batch(src, tgt))
    solo = video_clip(video_swapper(inputs), inputs)[:2]
    return dict(inputs=inputs, ranks=ranks.join(), want=want, solo=solo)


def test_sharded_swap_batch_matches_jax_shard_inference(runs):
    """Every rank returns the whole (4, 64, 64, 3) uint8 batch, the same on
    both, within 2 levels of JAX's sharded program and 0.02 levels on
    average (tests/test_torch_full_swap.py's bounds for the port's swap
    against JAX's)."""
    want = runs["want"]
    got0, got1 = (r["batch"].numpy() for r in runs["ranks"])
    assert got0.dtype == np.uint8 and got0.shape == want.shape == (4, SIZE, SIZE, 3)
    assert np.array_equal(got0, got1)
    diff = np.abs(got0.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 2 and diff.mean() <= 0.02, (diff.max(), diff.mean())


def test_indivisible_batch_and_staged_config_are_refused(runs):
    for rank in runs["ranks"]:
        msg = rank["refused"]
        assert msg is not None and "3" in msg and "2" in msg, msg
    swapper = video_swapper(runs["inputs"])
    staged = FullFaceSwapPipeline(swapper, SwapComponents(), FullSwapConfig(ct_mode="rct"))
    with pytest.raises(RuntimeError, match="fused"):
        staged.shard_inference(None)
    assert staged.process_group is None


def test_video_pipeline_over_the_group_matches_one_process(runs):
    """A 2-frame clip with one PTI step, each rank tuning one frame, against
    the same clip without a group: PTI's losses within 1e-4 relative (the
    same frame mean, summed in another order) and the frames within 2
    levels and 0.05 levels on average; rank 0 alone is the output rank,
    and both ranks return the same frames and tuned weights. The clip runs
    no stitching: on random frames its border ring is empty and its
    content target is the generator's own synthesis, so its first gradient
    is rounding noise, which Adam's lr-1e-2 steps of either sign turn into
    frames that differ between any two summation orders (the stitching
    coach over the group is held against JAX above)."""
    frames, hist = runs["solo"]
    (f0, h0, out0, d0), (f1, h1, out1, d1) = (r["video"] for r in runs["ranks"])
    assert (out0, out1) == (True, False) and d0 == d1
    for a, b in zip(f0, f1):
        assert np.array_equal(a, b)
    assert set(h0) == set(hist) == {"pti"}
    for name in hist:
        _assert_history(h0[name], hist[name], (1e-4,) * len(hist[name]))
    got = np.stack(f0).astype(np.int16)
    want = np.stack(frames).astype(np.int16)
    assert got.shape == want.shape and np.abs(got - want).max() <= 2
    assert np.abs(got - want).mean() <= 0.05
