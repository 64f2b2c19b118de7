"""The port's editor re-render in fast regional mode against the JAX
package's, on the CPU, on tests/test_torch_editor.py's tiny RGINet and
inputs (its exact mode, inversion and edits are held there). Both packages
re-render from the port's style vectors, so JAX compiles its fast-mode
program alone.
"""

import numpy as np

import jax.numpy as jnp

from e4s2024_torch.pipelines.editor import Editor
from tests.test_torch_criterion import two_threads  # noqa: F401
from tests.test_torch_editor import editors, inputs  # noqa: F401


def test_generate_from_label_fast_matches_jax(editors, inputs):  # noqa: F811
    """The fast-mode re-render of a face, and of an edit (a component's
    style from another face, its region moved), against JAX's fast mode
    from the same style vectors: within 1e-4 of the image's largest
    value."""
    ed, jed = editors
    img, lbl = inputs
    sv = ed.invert(img, lbl)
    mixed = ed.swap_component_style(sv, sv.flip(1), ["nose"])
    moved = Editor.translate_component(lbl, 6, dy=4, dx=-3)
    for s, labels in ((sv, lbl), (mixed, moved)):
        got = ed.generate_from_label(s, labels, regional_mode="fast")
        want = np.asarray(jed.generate_from_label(jnp.asarray(s.numpy()),
                                                  jnp.asarray(np.asarray(labels)),
                                                  regional_mode="fast"))
        assert got.shape == (1, 64, 64, 3)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
