"""The port's native data-prep binding (e4s2024_torch.data.native) on the
CPU: it builds `native/fast_prep.cpp` with c++ into its own build directory,
writes nothing under `native/` or the JAX package, and agrees with its
numpy path and with the JAX package's `data/native.py`."""

import os

import numpy as np
import pytest

from e4s2024_tpu.data import native as jnative

from e4s2024_torch.data import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _listing(*dirs):
    out = {}
    for d in dirs:
        for name in sorted(os.listdir(d)) if os.path.isdir(d) else []:
            st = os.stat(os.path.join(d, name))
            out[os.path.join(d, name)] = (st.st_size, st.st_mtime_ns)
    return out


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """A fresh build into a temporary build directory; what `native/` and
    `e4s2024_tpu/_native/` hold before and after it."""
    dirs = (os.path.join(ROOT, "native"), os.path.join(ROOT, "e4s2024_tpu", "_native"))
    before = _listing(*dirs)
    mp = pytest.MonkeyPatch()
    mp.setattr(native, "BUILD_DIR", tmp_path_factory.mktemp("build"))
    mp.setattr(native, "_lib", None)
    assert native.native_available()
    path = native.library_path()
    yield path, before, _listing(*dirs)
    mp.undo()


def test_builds_into_its_own_directory(built):
    path, before, after = built
    assert path.exists() and path.name.startswith("libfast_prep_")
    assert before == after


def test_images_to_pm1_matches_numpy_and_jax(built, rng):
    imgs = rng.integers(0, 256, (3, 70, 50, 3), dtype=np.uint8)
    got = native.images_to_pm1(imgs, threads=4)
    np.testing.assert_allclose(got, imgs.astype(np.float32) / 127.5 - 1.0, atol=1e-6)
    np.testing.assert_allclose(got, jnative.images_to_pm1(imgs), atol=1e-6)


@pytest.mark.parametrize("size,k", [(32, 12), (100, 12), (64, 8)])
def test_labels_to_onehot_matches_numpy_and_jax(built, rng, size, k):
    """Floor-nearest resize and one-hot; classes at or over K give zero
    rows (k=8 of 12 labels). Exact."""
    lbl = rng.integers(0, 12, (2, 64, 48), dtype=np.uint8)
    got = native.labels_to_onehot(lbl, size, num_classes=k, threads=3)
    mp = pytest.MonkeyPatch()
    mp.setattr(native, "_lib", False)
    numpy_path = native.labels_to_onehot(lbl, size, num_classes=k)
    mp.undo()
    np.testing.assert_array_equal(got, numpy_path)
    np.testing.assert_array_equal(got, jnative.labels_to_onehot(lbl, size, num_classes=k))


def test_hflip_matches_numpy_and_jax(built, rng):
    img = rng.integers(0, 256, (17, 23, 3), dtype=np.uint8)
    got = native.hflip(img)
    np.testing.assert_array_equal(got, img[:, ::-1])
    np.testing.assert_array_equal(got, jnative.hflip(img))


def test_no_compiler_takes_the_numpy_path(monkeypatch, tmp_path, rng):
    """Without a compiler the binding reports no library and every entry
    point still answers, through JAX's numpy path."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert not native.native_available()
    imgs = rng.integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    np.testing.assert_allclose(native.images_to_pm1(imgs), imgs / 127.5 - 1.0, atol=1e-6)
    np.testing.assert_array_equal(native.hflip(imgs[0]), imgs[0, :, ::-1])
