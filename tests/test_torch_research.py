"""The port's research drivers (e4s2024_torch.research) against the JAX
package's (e4s2024_tpu.research), on the CPU: the pair index, comparison
grids, the expansion seam, mouth transfer, and the comparison figures
written from PNG files (read back with PIL). The interpolation strip runs
on the editor and is held in tests/test_torch_editor.py, over the JAX
editor that file compiles."""

import numpy as np
import pytest
from PIL import Image

import jax.numpy as jnp

from e4s2024_tpu import research as jresearch

from e4s2024_torch import research
from tests.test_torch_criterion import nchw, nhwc, two_threads  # noqa: F401


def test_load_pair_index_matches_jax(tmp_path):
    p = tmp_path / "pairs.txt"
    p.write_text("src tgt\n28001 28002\n\n28003 28004 extra\n")
    assert research.load_pair_index(str(p)) == jresearch.load_pair_index(str(p)) == [
        ("28001", "28002"), ("28003", "28004")]


def test_comparison_grid_matches_jax(rng):
    """Panels of other heights resized bilinearly, a grey panel repeated
    to RGB, float panels clipped: equal to JAX's strip within one level
    (the rounding of float32 bilinear weights)."""
    panels = [(rng.random((32, 32, 3)) * 255).astype(np.uint8),
              (rng.random((16, 24, 3)) * 255).astype(np.uint8),
              (rng.random((32, 20)) * 255).astype(np.uint8),
              rng.random((8, 8, 3)).astype(np.float32) * 300 - 20]
    got = research.comparison_grid(panels, pad=3, pad_value=200)
    want = jresearch.comparison_grid(panels, pad=3, pad_value=200)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_expansion_seam_matches_jax():
    m = np.zeros((1, 32, 32, 1), np.float32)
    m[:, 8:24, 5:20] = 1.0
    m[:, 2:4, 28:31] = 1.0
    for radius in (1, 2, 5):
        got = nhwc(research.expansion_seam(nchw(m), radius=radius))
        want = np.asarray(jresearch.expansion_seam(jnp.asarray(m), radius=radius))
        np.testing.assert_array_equal(got, want)


def test_mouth_transfer_matches_jax(rng):
    """The composite, mouth mask and seam at 48x80, where the pyramid is
    capped at 5 levels (48 = 3 x 16) and the mouth mask, given at 24x40,
    is resized to the image: masks equal, the image within one level of
    JAX's (float32 pyramid rounding)."""
    src = (rng.random((48, 80, 3)) * 255).astype(np.float32)
    tgt = (rng.random((48, 80, 3)) * 255).astype(np.float32)
    mask = np.zeros((24, 40), np.float32)
    mask[12:18, 10:20] = 1.0
    got = research.mouth_transfer(src, tgt, mask, seam_radius=2, device="cpu")
    want = jresearch.mouth_transfer(src, tgt, mask, seam_radius=2)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[0].dtype == np.uint8 and got[0].shape == want[0].shape
    assert np.abs(got[0].astype(int) - want[0].astype(int)).max() <= 1


def test_run_comp_figs_matches_jax(tmp_path, rng):
    """Pairs read from .png and .jpg files, found in the second of two
    directories, swapped by a stand-in; the grids and panels the port
    writes (its own PNG writer) decode with PIL to JAX's (PIL-written)
    pixels exactly; a missing index raises."""
    d = tmp_path / "imgs"
    d.mkdir()
    Image.fromarray((rng.random((32, 32, 3)) * 255).astype(np.uint8)).save(d / "1.png")
    Image.fromarray((rng.random((32, 40, 3)) * 255).astype(np.uint8)).save(d / "2.jpg")
    pairs = [("1", "2"), ("2", "1")]

    def swap_fn(s, t):
        return ((s.astype(np.float32)[:, :32] + t[:, :32]) / 2).astype(np.uint8)

    dirs = [str(tmp_path / "empty"), str(d)]
    got = research.run_comp_figs(swap_fn, pairs, dirs, str(tmp_path / "port"), save_panels=True)
    want = jresearch.run_comp_figs(swap_fn, pairs, dirs, str(tmp_path / "jax"), save_panels=True)
    assert [p.split("/")[-1] for p in got] == [p.split("/")[-1] for p in want]
    for name in ("1_to_2.png", "2_to_1.png", "1_to_2_swap.png"):
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port" / name)),
                                      np.asarray(Image.open(tmp_path / "jax" / name)))
    with pytest.raises(FileNotFoundError):
        research.run_comp_figs(swap_fn, [("9", "1")], dirs, str(tmp_path / "o"))
