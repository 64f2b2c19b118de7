"""The port's video swap with the tunes off (e4s2024_torch.pipelines.video)
against the JAX package's pipeline, on the CPU, in tests/test_torch_clip.py's
configuration (split from tests/test_torch_video.py, so that each file
stays light).
"""

import pytest

from e4s2024_tpu.pipelines.video import FaceSwapVideoPipeline as JFaceSwapVideoPipeline

from e4s2024_torch.pipelines.video import FaceSwapVideoPipeline
from tests.test_torch_clip import _clip, _diff, _vcfg, jax_swapper, make_weights, port_swapper
from tests.test_torch_criterion import two_threads  # noqa: F401


@pytest.fixture(scope="module")
def weights():
    return make_weights()


def test_untuned_clip_matches_jax(weights):
    """The stages around the tunes (align, parse, invert, merge, synthesis,
    composite, paste-back) with PTI and stitching off, against JAX's
    pipeline: every frame within 1 level, mean under 1e-3 level (measured
    1.8e-4, CPU)."""
    source, frames = _clip(7)
    outs = FaceSwapVideoPipeline(port_swapper(weights), _vcfg("torch", 0, 0))(source, frames)
    jouts = JFaceSwapVideoPipeline(jax_swapper(weights), _vcfg("jax", 0, 0))(source, frames)
    for got, want in zip(outs, jouts):
        mx, mean, _ = _diff(got, want)
        assert mx <= 1 and mean <= 1e-3, (mx, mean)
