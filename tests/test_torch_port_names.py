"""The last public names of the JAX package to gain a counterpart in the
port, each against JAX's on the CPU on the same numpy-seeded inputs, as
cases of one parametrised test: `opening` and `closing`
(`ops/morphology.py`), `gaussian_blur`, `sharpen` and
`facial_mask_from_seg12` (`ops/blend.py`), the two earlier mask merges
(`pipelines/mask_merge.py`), `face_parsing` (`models/bisenet.py`, BiSeNet
with numpy-seeded weights on a 64^2 crop, upsampled to 512^2 inside) and
the two video containers (`data/datasets.py`). The JAX functions take
NHWC or single maps; the port's NCHW or batched maps.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from e4s2024_tpu.data import datasets as jdatasets
from e4s2024_tpu.models import bisenet as jbisenet
from e4s2024_tpu.ops import blend as jblend
from e4s2024_tpu.ops import morphology as jmorph
from e4s2024_tpu.pipelines import mask_merge as jmerge

from e4s2024_torch.convert import bisenet_state_dict_from_jax
from e4s2024_torch.data import datasets
from e4s2024_torch.models import bisenet
from e4s2024_torch.ops import blend, morphology
from e4s2024_torch.pipelines import mask_merge
from tests.test_torch_criterion import two_threads  # noqa: F401  (autouse fixture)
from tests.test_torch_models import random_params


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.numpy().transpose(0, 2, 3, 1)


def _masks(seed):
    """Two smooth 12-class 64^2 maps a batch, a source and a target."""
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 12, (2, 2, 8, 8))
    return np.kron(coarse, np.ones((1, 1, 8, 8), np.int64))


def _images(seed, c=3):
    return np.random.default_rng(seed).random((2, 32, 40, c)).astype(np.float32)


def _morphology(name):
    x = (_images(1, 1) > 0.6).astype(np.float32)
    x[:, 10:14, 10:14] = 1.0
    for size in (3, 4, 5):
        want = np.asarray(getattr(jmorph, name)(jnp.asarray(x), size))
        yield _nhwc(getattr(morphology, name)(_nchw(x), size)), want, 0.0


def _blur(name):
    x = _images(2) * 255
    for kw in ({"sigma": 1.5}, {"sigma": 2.0, "ksize": 5}) if name == "gaussian_blur" else \
            ({"sigma": 3.0}, {}):
        want = np.asarray(getattr(jblend, name)(jnp.asarray(x), **kw))
        yield _nhwc(getattr(blend, name)(_nchw(x), **kw)), want, 1e-4


def _facial_mask():
    seg = _masks(3)[:, 0]
    for hw in (None, (48, 40)):
        want = np.asarray(jblend.facial_mask_from_seg12(jnp.asarray(seg), hw))
        yield _nhwc(blend.facial_mask_from_seg12(torch.from_numpy(seg), hw)), want, 1e-6


def _merge(name):
    maps = _masks(4)
    src, tgt = torch.from_numpy(maps[:, 0]), torch.from_numpy(maps[:, 1])
    got = getattr(mask_merge, name)(src, tgt)
    got = got if isinstance(got, tuple) else (got,)
    for b in range(2):
        want = getattr(jmerge, name)(jnp.asarray(maps[b, 0]), jnp.asarray(maps[b, 1]))
        want = want if isinstance(want, tuple) else (want,)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            yield g[b].numpy(), np.asarray(w), 0.0


def _face_parsing():
    jnet = jbisenet.BiSeNet()
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    params = random_params(shapes["params"], 5)
    net = bisenet.BiSeNet()
    net.load_state_dict(bisenet_state_dict_from_jax(params), strict=True)
    img = np.random.default_rng(6).random((1, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jbisenet.face_parsing)(params, jnp.asarray(img)))
    with torch.no_grad():
        got = bisenet.face_parsing(net.eval(), _nchw(img)).numpy()
    assert got.shape == want.shape == (1, 512, 512)
    # argmax over float32 logits: a near-tie may flip a label
    yield np.array((got == want).mean()), np.array(1.0), 1e-3


def _containers():
    rng = np.random.default_rng(7)
    frames = dict(driven=rng.random((3, 8, 8, 3)), driven_labels=rng.integers(0, 12, (3, 8, 8)),
                  style_vectors=rng.random((3, 12, 1280)), recolor=rng.random((3, 8, 8, 3)))
    stitch = dict(content=rng.random((2, 8, 8, 3)), border=rng.random((2, 8, 8, 3)),
                  swapped_labels=rng.integers(0, 12, (2, 8, 8)),
                  style_vectors=rng.random((2, 12, 1280)))
    for cls, kw in (("VideoSwapFramesDataset", frames), ("VideoStitchingDataset", stitch)):
        got, want = getattr(datasets, cls)(**kw), getattr(jdatasets, cls)(**kw)
        assert len(got) == len(want) == len(next(iter(kw.values())))
        assert [f for f in vars(got)] == [f for f in vars(want)]
        for field, value in vars(want).items():
            yield (np.zeros(0) if getattr(got, field) is None else getattr(got, field),
                   np.zeros(0) if value is None else value, 0.0)


CASES = {
    "opening": lambda: _morphology("opening"),
    "closing": lambda: _morphology("closing"),
    "gaussian_blur": lambda: _blur("gaussian_blur"),
    "sharpen": lambda: _blur("sharpen"),
    "facial_mask_from_seg12": _facial_mask,
    "swap_head_mask_consider_glass": lambda: _merge("swap_head_mask_consider_glass"),
    "swap_head_mask_target_bg_dilation": lambda: _merge("swap_head_mask_target_bg_dilation"),
    "face_parsing": _face_parsing,
    "video_datasets": _containers,
}


@pytest.mark.parametrize("name", CASES)
def test_port_matches_jax(name):
    """Each output within the stated bound of the largest magnitude of
    JAX's (0: equal; float filters 1e-4, float32 accumulation order)."""
    n = 0
    for got, want, rel in CASES[name]():
        got, want = np.asarray(got), np.asarray(want)
        assert got.shape == want.shape, (name, got.shape, want.shape)
        scale = float(np.abs(want).max()) if want.size else 0.0
        np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(scale, 1e-12), err_msg=name)
        n += 1
    assert n > 0
