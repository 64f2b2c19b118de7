"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Every `*.cu` under `csrc/` is compiled for Hopper (`sm_90a`), one nvcc
process per source, all started together, and linked into one shared library
with a plain C interface. The library lands in `_build/` next to this file
(listed in `.gitignore`) under a name that hashes the sources and flags, so a
changed source is rebuilt and an unchanged one is loaded as it is.

The build runs at the first kernel launch (or an explicit `library()` call),
never at import: the CPU tests import every module on hosts without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry points and their argument types (see csrc/*.cu); each returns the
# cudaError_t of its launch.
SIGNATURES = {
    # x, bias, out, dtype, planes, channels, inner, slope, gain, device, stream
    "e4s_fused_leaky_relu": (_P, _P, _P, _I, _LL, _I, _LL, _F, _F, _I, _P),
    # grad, out, grad_x, dtype, elements, slope, gain, device, stream
    "e4s_fused_leaky_relu_backward": (_P, _P, _P, _I, _LL, _F, _F, _I, _P),
    # x, out, dtype, planes, in_h, in_w, out_h, out_w, up, down, pad0,
    # taps (host float*), kh, kw, rank1, device, stream
    "e4s_upfirdn2d": (_P, _P, _I, _LL, _I, _I, _I, _I, _I, _I, _I,
                      ctypes.POINTER(ctypes.c_float), _I, _I, _I, _I, _P),
    # x, seg, scales, out, dtype, batch, channels, regions, hw, device, stream
    "e4s_regional_scale": (_P, _P, _P, _P, _I, _LL, _I, _I, _LL, _I, _P),
    # qkv, bias, labels, out, dtype, batch, height, width, channels, heads,
    # window, scale, device, stream
    "e4s_swin_attention_nhwc": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P),
    # q, k, v, bias, labels, out, dtype, windows, heads, n, head_dim, scale,
    # device, stream
    "e4s_window_attention": (_P, _P, _P, _P, _P, _P, _I, _LL, _I, _I, _I, _F, _I, _P),
    # x, slabs, vec, bias, labels, out, dtype, batch, height, width, channels,
    # heads, hidden, window, shift, scale, eps, device, stream
    "e4s_swin_block": (_P,) * 6 + (_I,) * 9 + (_F, _F, _I, _P),
    # x, packed, bias, out, res1, res2, batch, in_h, in_w, in_stride, cin, n,
    # fold, out_stride, out_off, act, res1_stride, s1, res2_stride, s2,
    # device, stream
    "e4s_rdb_conv": (_P,) * 6 + (_I,) * 11 + (_F, _I, _F, _I, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# What the last build did: seconds, and nvcc's register/shared-memory report.
build_info: dict = {}


def cuda_tool(name: str) -> str:
    """Path of a CUDA toolkit program (nvcc, cuobjdump)."""
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and (Path(home) / "bin" / name).exists():
            return str(Path(home) / "bin" / name)
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(f"{name} not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _compile(target: Path) -> None:
    nvcc = cuda_tool("nvcc")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        reports, failed = [], []
        for src, proc in procs:
            out, _ = proc.communicate()
            reports.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError("nvcc failed on " + ", ".join(failed) + ":\n"
                               + "\n".join(reports))
        lib_tmp = Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(lib_tmp), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("linking the kernels failed:\n" + link.stdout)
        os.replace(lib_tmp, target)
    build_info.update(seconds=time.perf_counter() - t0, built=True,
                      report="\n".join(reports))


def library_path() -> Path:
    """Where the library of the current sources is, or will be, built."""
    return BUILD_DIR / f"libe4s_kernels_{_digest()}.so"


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            target = library_path()
            if target.exists():
                build_info.update(seconds=0.0, built=False, report="")
            else:
                _compile(target)
            lib = ctypes.CDLL(str(target))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
