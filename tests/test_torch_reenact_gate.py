"""The port's reenacted zoo swap against the JAX package's on the side of
the gate that keeps the source crop, on the CPU: the pipeline of
tests/test_torch_reenact_swap.py with GPEN and GCFSR (face_inpainting), the
default configuration but its recolor, at a threshold 5 degrees above the
pair's gap. The pose driver still makes the call staged: GPEN's float crop
is truncated by the swap.
"""

import pytest

from tests.test_torch_criterion import two_threads  # noqa: F401  (autouse fixture)
from tests.test_torch_reenact_swap import build_pipelines, check_single_call


@pytest.fixture(scope="module")
def pipelines():
    return build_pipelines(("gpen", "gcfsr"))


def test_kept_side_matches_jax(pipelines):
    check_single_call(*pipelines, "kept")
