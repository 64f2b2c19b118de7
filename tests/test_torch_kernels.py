"""The port's hand-written CUDA kernels and their wrappers.

This file imports no JAX, so it also runs on a machine with a card and no
JAX: `python -m pytest --noconftest tests/test_torch_kernels.py`. Tests
marked `cuda` build the kernels with nvcc, hold each against its plain
version on the card, and skip on a host without a card; the rest check the
wrappers' bookkeeping and the C bindings on the CPU.
"""

import re

import numpy as np
import pytest
import torch

from e4s2024_torch import kernels, resolve_device
from e4s2024_torch.kernels import build
from e4s2024_torch.ops import fused_act, modulate, upfirdn


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False  # the plain versions' convs in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.reset_launch_counts()
    return torch.device("cuda")


def _randn(*shape, device="cpu", dtype=torch.float32, seed=0):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.standard_normal(shape).astype(np.float32)).to(device, dtype)


def _one_hot(b, k, h, w, device="cpu", dtype=torch.float32, seed=0):
    lbl = torch.from_numpy(np.random.default_rng(seed).integers(0, k, (b, h, w)))
    return torch.nn.functional.one_hot(lbl, k).permute(0, 3, 1, 2).to(device, dtype).contiguous()


def _assert_close_to_f32(got, want_f32):
    """float32 output: summation order only; bfloat16 output: one rounding
    of the float32 result (2^-8 relative)."""
    rtol = 1e-5 if got.dtype == torch.float32 else 2.0 ** -8
    atol = 1e-5 * float(want_f32.abs().max()) if got.dtype == torch.float32 else 1e-6
    torch.testing.assert_close(got.float(), want_f32, rtol=rtol, atol=atol)


# ----------------------------------------------------------------- CPU


def test_bindings_match_sources():
    """Every ctypes signature names an extern "C" function of csrc/ with as
    many parameters."""
    text = "\n".join(p.read_text() for p in build.CSRC.glob("*.cu"))
    for name, argtypes in build.SIGNATURES.items():
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
        assert m, name
        assert len(m.group(1).split(",")) == len(argtypes), name


def test_wrappers_registered_with_counters():
    assert set(kernels.WRAPPERS) == {"fused_leaky_relu", "upfirdn2d", "regional_scale"}
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == dict.fromkeys(kernels.WRAPPERS, 0)


def test_plain_switch_is_scoped():
    x = torch.zeros(2)
    assert kernels.use_plain(x)
    with kernels.plain_versions_on_card():
        assert kernels._plain_on_card
    assert not kernels._plain_on_card
    with pytest.raises(RuntimeError):
        kernels.use_plain(torch.zeros(2, device="meta"))


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            resolve_device()


# ---------------------------------------------------------------- card


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 32, 33, 35), (1, 512, 4, 4), (3, 7)])
def test_fused_leaky_relu_kernel(cuda, dtype, shape):
    x = _randn(*shape, device=cuda, dtype=dtype)
    b = _randn(shape[1], device=cuda, seed=1)
    got = fused_act.fused_leaky_relu(x, b)
    assert fused_act.fused_leaky_relu.launches == 1
    _assert_close_to_f32(got, fused_act.fused_leaky_relu_plain(x.float(), b))
    _assert_close_to_f32(fused_act.fused_leaky_relu(x), fused_act.fused_leaky_relu_plain(x.float()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("up,down,pad,gain,size", [
    (1, 1, (2, 1), 1.0, 40), (1, 1, (1, 1), 4.0, 65), (2, 1, (2, 1), 4.0, 37),
    (1, 2, (1, 1), 1.0, 66), (1, 1, (-1, 2), 1.0, 9)])
def test_upfirdn2d_kernel(cuda, dtype, up, down, pad, gain, size):
    x = _randn(2, 5, size, size + 3, device=cuda, dtype=dtype)
    k = upfirdn.make_kernel([1, 3, 3, 1]) * gain + 0.01 * _randn(4, 4, seed=2)
    got = upfirdn.upfirdn2d(x, k, up=up, down=down, pad=pad)
    assert upfirdn.upfirdn2d.launches == 1
    _assert_close_to_f32(got, upfirdn.upfirdn2d_plain(x.float(), k, up, down, pad))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,h,w,k", [(2, 70, 9, 31, 12), (1, 512, 4, 4, 12), (1, 3, 64, 64, 16)])
def test_regional_scale_kernel(cuda, dtype, b, c, h, w, k):
    x = _randn(b, c, h, w, device=cuda, dtype=dtype)
    seg = _one_hot(b, k, h, w, device=cuda, dtype=dtype)
    s = _randn(b, k, c, device=cuda, dtype=dtype, seed=3)
    got = modulate.regional_scale(x, seg, s)
    assert modulate.regional_scale.launches == 1
    _assert_close_to_f32(got, modulate.regional_scale_plain(x.float(), seg.float(), s.float()))


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = _randn(1, 4, 8, 8, device=cuda)
    with pytest.raises(ValueError):
        fused_act.fused_leaky_relu(x.transpose(2, 3), None)
    with pytest.raises(TypeError):
        fused_act.fused_leaky_relu(x.half(), None)
    with pytest.raises(RuntimeError):
        fused_act.fused_leaky_relu(x.clone().requires_grad_(True), None)
    with pytest.raises(ValueError):
        upfirdn.upfirdn2d(x, torch.ones(5, 5))
    with pytest.raises(ValueError):
        modulate.regional_scale(x, _one_hot(1, 12, 4, 4, device=cuda), _randn(1, 12, 4, device=cuda))
    assert kernels.launch_counts() == dict.fromkeys(kernels.WRAPPERS, 0)


@pytest.mark.cuda
def test_plain_versions_on_card_launch_nothing(cuda):
    x = _randn(1, 4, 8, 8, device=cuda)
    with kernels.plain_versions_on_card():
        out = fused_act.fused_leaky_relu(x, None)
    assert out.is_cuda
    assert kernels.launch_counts() == dict.fromkeys(kernels.WRAPPERS, 0)
