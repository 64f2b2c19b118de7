"""The re-render of the port's mask-editing loop (e4s2024_torch.app
`editor_resynthesize`) against the JAX package's, on the CPU, with
tests/test_torch_app.py's swappers. JAX's loop parses with the port's
parse here (the parses are held against each other in
tests/test_torch_app.py), so that both packages invert and re-render from
the same labels and JAX compiles only its editor.
"""

import numpy as np

from e4s2024_tpu import app as japp

from e4s2024_torch import app
from tests.test_torch_app import _image, swappers  # noqa: F401
from tests.test_torch_criterion import two_threads  # noqa: F401


def test_editor_resynthesize_matches_jax(swappers, monkeypatch):  # noqa: F811
    """Invert with the image's own parse, re-render with a stroke painted
    onto it: uint8 within 2 levels of JAX's, mean under 0.05 level."""
    sw, jsw = swappers
    img = _image(1)
    lbl = app.editor_parse(sw, img)
    stroke = np.zeros((64, 64), np.float32)
    stroke[10:40, 20:50] = 1.0
    edited = app.editor_apply_stroke(lbl, stroke, 4)
    got = app.editor_resynthesize(sw, img, edited)
    monkeypatch.setattr(japp, "editor_parse", lambda _, im: app.editor_parse(sw, im))
    want = japp.editor_resynthesize(jsw, img.astype(np.float32), edited)
    assert got.shape == want.shape == (64, 64, 3) and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 2 and diff.mean() <= 0.05, (diff.max(), diff.mean())
