"""The port's apps (e4s2024_torch.app) against the JAX package's
(e4s2024_tpu.app), on the CPU: the brush stroke, the parse of the
mask-editing loop, the gradio gate, and the PNG writer the reconstruction
CLI uses in place of PIL. The loop's re-render is held in
tests/test_torch_app_resynth.py, the CLI in tests/test_torch_recon_cli.py
(each JAX program compiles in its own file, so that each file stays under
a minute of worker time); they share this file's swappers.

The swapper is tests/test_torch_clip.py's (64^2 output, remaining_layer_idx
7, one encoder unit per group, float32; weights from a numpy seed), in fast
regional mode; the parser runs at 512^2 whatever the image.
"""

import dataclasses
import sys

import numpy as np
import pytest
from PIL import Image

from e4s2024_tpu import app as japp

from e4s2024_torch import app
from e4s2024_torch.utils.image import save_png
from tests.test_torch_clip import jax_swapper, make_weights, port_swapper
from tests.test_torch_criterion import two_threads  # noqa: F401


@pytest.fixture(scope="module")
def swappers():
    """(the port's swapper, JAX's) in fast regional mode."""
    weights = make_weights()
    sw, jsw = port_swapper(weights), jax_swapper(weights)
    sw.cfg = dataclasses.replace(sw.cfg, regional_mode="fast")
    jsw.cfg = dataclasses.replace(jsw.cfg, regional_mode="fast")
    return sw, jsw


def _image(seed, size=64):
    rng = np.random.default_rng(seed)
    coarse = rng.random((8, 8, 3)) * 200
    return (np.kron(coarse, np.ones((size // 8, size // 8, 1))) + rng.random((size, size, 3)) * 55)


def test_editor_apply_stroke_matches_jax(rng):
    """A stroke on the label grid, and strokes at other sizes resized
    nearest onto it (integer and non-integer ratios): equal to JAX's; the
    caller's map is not modified."""
    lbl = rng.integers(0, 12, (16, 20)).astype(np.int32)
    before = lbl.copy()
    for shape in ((16, 20), (32, 40), (24, 7)):
        stroke = (rng.random(shape) > 0.6).astype(np.float32)
        got = app.editor_apply_stroke(lbl, stroke, 4)
        np.testing.assert_array_equal(got, japp.editor_apply_stroke(lbl, stroke, 4))
        assert got.dtype == lbl.dtype
    np.testing.assert_array_equal(lbl, before)  # the caller's map is left as it was


@pytest.fixture(scope="module")
def parsed(swappers):
    sw, jsw = swappers
    img = _image(1)
    return img, app.editor_parse(sw, img), japp.editor_parse(jsw, img.astype(np.float32))


def test_editor_parse_matches_jax(parsed):
    """The 512^2 12-class map of the whole image: the same labels as JAX's
    on all but 1e-3 of the pixels (argmax ties of float32 logits)."""
    _, got, want = parsed
    assert got.shape == want.shape == (512, 512) and got.dtype == np.int32
    assert (got != want).mean() <= 1e-3


def test_build_gradio_app_needs_gradio(monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)
    with pytest.raises(RuntimeError, match="gradio"):
        app.build_gradio_app(None)
    assert app.SEG12_NAMES == japp.SEG12_NAMES


@pytest.mark.parametrize("shape", [(5, 7, 3), (64, 33, 3), (9, 4)])
def test_save_png_round_trip(tmp_path, rng, shape):
    """The zlib-and-struct writer: RGB and grey images decode with PIL to
    the same pixels; other dtypes and shapes are refused."""
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    save_png(tmp_path / "a.png", img)
    with Image.open(tmp_path / "a.png") as im:
        assert im.mode == ("RGB" if len(shape) == 3 else "L")
        np.testing.assert_array_equal(np.asarray(im), img)
    with pytest.raises(ValueError):
        save_png(tmp_path / "b.png", img.astype(np.float32))
    with pytest.raises(ValueError):
        save_png(tmp_path / "c.png", np.zeros((4, 4, 4), np.uint8))
