"""The port's editor (e4s2024_torch.pipelines.editor) against the JAX
package's, on the CPU, on tests/test_editor.py's tiny RGINet (64^2,
remaining_layer_idx 7, channel multiplier 1, encoder units (1, 1, 2, 1)),
weights from a numpy seed bridged by `rgi_state_dict_from_jax`: inversion,
re-synthesis in exact mode, every edit, and `research.interpolation_strip`
(over the same compiled JAX editor). Fast mode is held in
tests/test_torch_editor_fast.py (each JAX mode compiles a program of its
own, and each file stays under a minute of worker time).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from e4s2024_tpu import research as jresearch
from e4s2024_tpu.models.rgi import RGINet as JRGINet
from e4s2024_tpu.pipelines.editor import Editor as JEditor

from e4s2024_torch import research
from e4s2024_torch.convert import rgi_state_dict_from_jax
from e4s2024_torch.models.rgi import RGINet
from e4s2024_torch.pipelines.editor import Editor
from tests.test_torch_criterion import two_threads  # noqa: F401
from tests.test_torch_models import random_params

TINY = dict(out_size=64, remaining_layer_idx=7, channel_multiplier=1, encoder_input_size=64,
            encoder_num_units=(1, 1, 2, 1))


@pytest.fixture(scope="module")
def editors():
    """(the port's Editor, JAX's Editor) over the same seeded weights."""
    jnet = JRGINet(**TINY)
    variables = random_params(jax.eval_shape(
        jnet.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
        jnp.zeros((1, 64, 64, 12))), 11)
    net = RGINet(num_seg_cls=12, **TINY)
    net.load_state_dict(rgi_state_dict_from_jax(variables), strict=True)
    return Editor(net), JEditor(variables, jnet)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(3)
    img = (rng.standard_normal((1, 64, 64, 3)) * 0.3).astype(np.float32)
    base = rng.integers(0, 12, (1, 8, 8))
    lbl = np.repeat(np.repeat(base, 8, 1), 8, 2)
    return img, lbl


@pytest.fixture(scope="module")
def inverted(editors, inputs):
    ed, jed = editors
    img, lbl = inputs
    return ed.invert(img, lbl), jed.invert(jnp.asarray(img), jnp.asarray(lbl))


def test_invert_matches_jax(inverted):
    """Style vectors within 1e-4 of their largest element (float32 both
    sides, CPU)."""
    sv, jsv = inverted
    assert sv.shape == (1, 12, 1280) and sv.dtype == torch.float32
    want = np.asarray(jsv)
    np.testing.assert_allclose(sv.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_generate_from_label_matches_jax(editors, inputs, inverted):
    """The exact-mode re-render against JAX's, from JAX's style vectors:
    within 1e-4 of the image's largest value."""
    ed, jed = editors
    _, lbl = inputs
    jsv = inverted[1]
    got = ed.generate_from_label(torch.from_numpy(np.array(jsv)), lbl, regional_mode="exact")
    want = np.asarray(jed.generate_from_label(jsv, jnp.asarray(lbl), regional_mode="exact"))
    assert got.shape == (1, 64, 64, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_style_edits_match_jax(editors, inverted):
    """swap_component_style, interpolate_styles (whole and per component)
    and apply_latent_direction ((1280,) and (K, 1280)): equal to JAX's
    within float32 rounding."""
    ed, jed = editors
    jsv_a = inverted[1]
    jsv_b = jsv_a * 2.0 + 0.5
    sv_a, sv_b = (torch.from_numpy(np.array(x)) for x in (jsv_a, jsv_b))
    rng = np.random.default_rng(4)
    d1 = rng.standard_normal(1280).astype(np.float32)
    d2 = rng.standard_normal((12, 1280)).astype(np.float32)
    pairs = [
        (ed.swap_component_style(sv_a, sv_b, ["hair", 5]),
         jed.swap_component_style(jsv_a, jsv_b, ["hair", 5])),
        (ed.interpolate_styles(sv_a, sv_b, 0.3), jed.interpolate_styles(jsv_a, jsv_b, 0.3)),
        (ed.interpolate_styles(sv_a, sv_b, 0.3, components=["nose", 2]),
         jed.interpolate_styles(jsv_a, jsv_b, 0.3, components=["nose", 2])),
        (ed.apply_latent_direction(sv_a, d1, 2.5), jed.apply_latent_direction(jsv_a, d1, 2.5)),
        (ed.apply_latent_direction(sv_a, d2, -1.0), jed.apply_latent_direction(jsv_a, d2, -1.0)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_mask_edits_match_jax():
    """translate_component (the vacated region to skin, wrapping as
    jnp.roll), swap_component_mask by name and index, component_index and
    onehot: equal to JAX's."""
    rng = np.random.default_rng(5)
    lbl = rng.integers(0, 12, (1, 16, 16))
    lbl[:, 4:7, 3:6] = 5
    lbl_b = rng.integers(0, 12, (1, 16, 16))
    for comp, dy, dx in ((5, 3, 2), (5, -6, 13), (4, 0, -1)):
        got = Editor.translate_component(lbl, comp, dy=dy, dx=dx)
        want = JEditor.translate_component(jnp.asarray(lbl), comp, dy=dy, dx=dx)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for comp in ("nose", 2):
        got = Editor.swap_component_mask(lbl, lbl_b, comp)
        want = JEditor.swap_component_mask(jnp.asarray(lbl), jnp.asarray(lbl_b), comp)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert [Editor.component_index(n) for n in ("hair", "skin", "ear_rings")] == \
        [JEditor.component_index(n) for n in ("hair", "skin", "ear_rings")]
    net = RGINet(num_seg_cls=12, **TINY)
    np.testing.assert_array_equal(Editor(net).onehot(lbl).permute(0, 2, 3, 1).numpy(),
                                  np.asarray(JEditor.onehot(jnp.asarray(lbl))))


def test_edited_render_matches_jax(editors, inputs, inverted):
    """The UI's loop: a component's style from another face, its region
    moved, then the re-render, against JAX doing the same (within 1e-4 of
    the image's largest value)."""
    ed, jed = editors
    _, lbl = inputs
    jsv = inverted[1]
    sv = torch.from_numpy(np.array(jsv))
    mixed = ed.swap_component_style(sv, sv.flip(1), ["nose"])
    moved = Editor.translate_component(lbl, 6, dy=4, dx=-3)
    got = ed.generate_from_label(mixed, moved)
    jmixed = jed.swap_component_style(jsv, jsv[:, ::-1], ["nose"])
    jmoved = JEditor.translate_component(jnp.asarray(lbl), 6, dy=4, dx=-3)
    want = np.asarray(jed.generate_from_label(jmixed, jmoved))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_interpolation_strip_matches_jax(editors, rng):
    """`research.interpolation_strip`: two interpolants of the hair and
    skin styles between two tiny-net faces on A's geometry, within 2
    levels of JAX's strip (uint8 rounding of float32 images that agree
    within 1e-4)."""
    ed, jed = editors
    a = (rng.random((64, 64, 3)) * 255).astype(np.uint8)
    b = (rng.random((64, 64, 3)) * 255).astype(np.uint8)
    la = np.repeat(np.repeat(rng.integers(0, 12, (8, 8)), 8, 0), 8, 1)
    lb = np.repeat(np.repeat(rng.integers(0, 12, (8, 8)), 8, 0), 8, 1)
    got = research.interpolation_strip(ed, a, b, la, lb, steps=2, components=["hair", 6])
    want = jresearch.interpolation_strip(jed, a, b, la, lb, steps=2, components=["hair", 6])
    assert got.shape == want.shape == (64, 4 * 64 + 3 * 4, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 2
