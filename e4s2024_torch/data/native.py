"""ctypes binding of the native data-prep library (`native/fast_prep.cpp`).

Counterpart of `e4s2024_tpu/data/native.py`. The port compiles the source
itself on first use, with `c++ -O3 -std=c++17 -shared -fPIC -lpthread`,
into `kernels/_build/` (beside the CUDA kernels' library, listed in
`.gitignore`) under a name that hashes the source and the flags; it reads
`native/` and writes nothing there. Where no compiler or source is found,
every entry point takes the JAX package's numpy path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from e4s2024_torch.kernels.build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "native" / "fast_prep.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_U8P, _F32P = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float)
_I = ctypes.c_int
_lock = threading.Lock()
_lib: ctypes.CDLL | bool | None = None


def library_path() -> Path:
    """Where the library of the current source is, or will be, built."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libfast_prep_{h.hexdigest()[:16]}.so"


def _compile(target: Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = Path(tmp) / target.name
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(out), str(SOURCE), "-lpthread"],
                       check=True, capture_output=True)
        os.replace(out, target)


def _load():
    """The library, built on first use; False where it cannot be built."""
    global _lib
    with _lock:
        if _lib is None:
            try:
                target = library_path()
                if not target.exists():
                    _compile(target)
                lib = ctypes.CDLL(str(target))
                lib.prep_images_pm1.argtypes = [_U8P, _F32P, ctypes.c_int64, _I]
                lib.labels_to_onehot.argtypes = [_U8P, _F32P, _I, _I, _I, _I, _I, _I]
                lib.hflip_u8.argtypes = [_U8P, _U8P, _I, _I, _I]
                _lib = lib
            except (OSError, RuntimeError, subprocess.CalledProcessError):
                _lib = False
        return _lib


def native_available() -> bool:
    return bool(_load())


def images_to_pm1(imgs_u8: np.ndarray, threads: int = 8) -> np.ndarray:
    """uint8 (...) -> float32 in [-1, 1]."""
    lib = _load()
    imgs_u8 = np.ascontiguousarray(imgs_u8, dtype=np.uint8)
    if not lib:
        return imgs_u8.astype(np.float32) / 127.5 - 1.0
    out = np.empty(imgs_u8.shape, np.float32)
    lib.prep_images_pm1(imgs_u8.ctypes.data_as(_U8P), out.ctypes.data_as(_F32P),
                        imgs_u8.size, threads)
    return out


def labels_to_onehot(labels_u8: np.ndarray, out_size: int, num_classes: int = 12,
                     threads: int = 8) -> np.ndarray:
    """(B, H, W) uint8 -> (B, S, S, K) float32 one-hot after a floor-nearest
    resize to S (torch's 'nearest'); classes >= K give all-zero rows."""
    lib = _load()
    labels_u8 = np.ascontiguousarray(labels_u8, dtype=np.uint8)
    b, h, w = labels_u8.shape
    if not lib:
        ih = (np.arange(out_size) * h) // out_size
        iw = (np.arange(out_size) * w) // out_size
        small = labels_u8[:, ih][:, :, iw]
        return np.eye(num_classes, dtype=np.float32)[
            np.clip(small, 0, num_classes - 1)] * (small < num_classes)[..., None]
    out = np.empty((b, out_size, out_size, num_classes), np.float32)
    lib.labels_to_onehot(labels_u8.ctypes.data_as(_U8P), out.ctypes.data_as(_F32P),
                         b, h, w, out_size, num_classes, threads)
    return out


def hflip(img_u8: np.ndarray) -> np.ndarray:
    """(H, W, C) uint8 horizontal flip."""
    lib = _load()
    img_u8 = np.ascontiguousarray(img_u8, dtype=np.uint8)
    if not lib:
        return img_u8[:, ::-1].copy()
    h, w, c = img_u8.shape
    out = np.empty_like(img_u8)
    lib.hflip_u8(img_u8.ctypes.data_as(_U8P), out.ctypes.data_as(_U8P), h, w, c)
    return out
