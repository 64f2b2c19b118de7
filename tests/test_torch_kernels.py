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
from e4s2024_torch.ops import (fused_act, modulate, rdb_conv, swin_block, upfirdn,
                               window_attention)


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
    assert set(kernels.WRAPPERS) == {"fused_leaky_relu", "upfirdn2d", "regional_scale",
                                     "swin_attention_nhwc", "fused_swin_block",
                                     "fused_window_attention", "fused_leaky_relu_backward",
                                     "upfirdn2d_backward", "regional_scale_backward",
                                     "fused_leaky_relu_double_backward",
                                     "upfirdn2d_double_backward", "rdb_conv"}
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


def _two_pass(x, u, v, up, down, pad):
    """upfirdn2d with the kernel outer(u, v) as two 1-D passes in plain torch,
    in the order K2's rank-1 path runs them: along W with v, then along H with u."""
    n, c, h, w = x.shape
    if up > 1:
        stuffed = x.new_zeros(n, c, h * up, w * up)
        stuffed[:, :, ::up, ::up] = x
        x = stuffed
    x = torch.nn.functional.pad(x, [pad[0], pad[1], pad[0], pad[1]])
    kv = torch.from_numpy(np.ascontiguousarray(v[::-1]))[None, None, None].expand(c, 1, 1, -1)
    ku = torch.from_numpy(np.ascontiguousarray(u[::-1]))[None, None, :, None].expand(c, 1, -1, 1)
    x = torch.nn.functional.conv2d(x, kv, stride=(1, down), groups=c)
    return torch.nn.functional.conv2d(x, ku, stride=(down, 1), groups=c)


@pytest.mark.parametrize("gain", [1.0, 4.0])
@pytest.mark.parametrize("up,down,pad", [(1, 1, (1, 1)), (2, 1, (2, 1)), (1, 2, (1, 1)),
                                         (2, 2, (2, 1)), (1, 1, (-1, 2))])
def test_upfirdn2d_rank1_detection_and_two_pass_order(up, down, pad, gain):
    """K2's rank-1 path: the generator's taps split into two 1-D factors, a
    horizontal then a vertical pass matches the 2-D form (float32 rounding
    only: 1e-6 of the largest output), a perturbed kernel is not split, and
    only up 1 / down 1 hands the kernel the factors."""
    k = upfirdn.make_kernel([1, 3, 3, 1]) * gain
    u, v = upfirdn.rank1_taps(k.numpy())
    assert np.array_equal(np.outer(u, v), k.numpy())
    x = _randn(2, 3, 21, 26)
    want = upfirdn.upfirdn2d_plain(x, k, up, down, pad)
    got = _two_pass(x, u, v, up, down, pad)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    assert upfirdn.rank1_taps((k + 0.01 * _randn(4, 4, seed=2)).numpy()) is None
    separable = up == 1 and down == 1
    rank1, taps = upfirdn._launch_taps(k, separable)
    assert rank1 == int(separable) and len(taps) == (8 if separable else 16)


# the generator's three K2 cases (the x4-gain blur after a transposed
# convolution, the ToRGB skip's up-2 FIR upsample, down-2 resampling), then
# odd sizes, a negative pad and down 2 with a remainder
K2_GRAD_CASES = [(1, 1, (1, 1), 4.0, (2, 3, 17, 17)), (2, 1, (2, 1), 4.0, (1, 3, 16, 16)),
                 (1, 2, (1, 1), 1.0, (2, 4, 16, 16)), (1, 1, (2, 1), 1.0, (1, 2, 9, 13)),
                 (1, 1, (-1, 2), 1.0, (1, 2, 9, 12)), (1, 2, (2, 1), 1.0, (1, 2, 15, 18)),
                 (2, 2, (2, 1), 1.0, (1, 2, 7, 10))]


@pytest.mark.parametrize("up,down,pad,gain,shape", K2_GRAD_CASES)
def test_upfirdn2d_backward_plain_is_the_gradient(up, down, pad, gain, shape):
    """K2's input gradient as upfirdn2d of the gradient (flipped taps, up and
    down swapped, `_backward_pads`) against autograd of the plain version;
    float32 summation order only. The taps are perturbed so that a flip is
    not a no-op."""
    k = upfirdn.make_kernel([1, 3, 3, 1]) * gain + 0.01 * _randn(4, 4, seed=2)
    x = _randn(*shape).requires_grad_(True)
    y = upfirdn.upfirdn2d_plain(x, k, up, down, pad)
    g = _randn(*y.shape, seed=1)
    (want,) = torch.autograd.grad(y, x, g)
    got = upfirdn.upfirdn2d_backward_plain(g, k, up, down, pad, shape[2:])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    # the card's wrapper takes one leading pad for both axes: the same pad0
    kh = k.shape[0]
    assert upfirdn._backward_pads(kh, up, down, pad[0], shape[2], y.shape[2])[0] == kh - pad[0] - 1


def test_regional_scale_and_fused_act_gradients_on_the_cpu():
    """The formulas the card's backwards use, against autograd of the plain
    versions: grad_x = K3(grad, seg, scales), grad_scales by
    `regional_scale_grad_scales`; K1's from its output."""
    x = _randn(2, 6, 5, 7).requires_grad_(True)
    seg = _one_hot(2, 4, 5, 7)
    s = _randn(2, 4, 6, seed=3).requires_grad_(True)
    y = modulate.regional_scale_plain(x, seg, s)
    g = _randn(*y.shape, seed=4)
    gx, gs = torch.autograd.grad(y, (x, s), g)
    torch.testing.assert_close(modulate.regional_scale_backward(g, seg, s), gx)
    torch.testing.assert_close(modulate.regional_scale_grad_scales(g, x.detach(), seg), gs)
    b = _randn(6, seed=5).requires_grad_(True)
    y = fused_act.fused_leaky_relu_plain(x, b)
    gx, gb = torch.autograd.grad(y, (x, b), g)
    torch.testing.assert_close(fused_act.fused_leaky_relu_backward(g, y.detach()), gx)
    torch.testing.assert_close(gx.sum(dim=(0, 2, 3)), gb)


def test_autograd_functions_with_plain_launches(monkeypatch):
    """The plumbing of K1-K3's autograd Functions on the CPU, each launch
    replaced by its plain version: gradcheck in float64 (inputs that need
    no gradient get none, K1's bias gets the summed gradient, K2's backward
    takes the flipped taps and swapped factors), and a forward under
    inference mode (the swaps run there). Small inputs on one thread:
    gradcheck runs the forward twice per input element."""
    def k2_plain(counter, x, k, up, down, pad0, out_hw):
        kh = k.shape[0]
        p1 = [(o - 1) * down + kh - n * up - pad0 for o, n in zip(out_hw, x.shape[2:])]
        return upfirdn._upfirdn2d_native(x, k, up, down, (pad0, p1[0]), (pad0, p1[1]))

    monkeypatch.setattr(fused_act, "_launch_forward", fused_act.fused_leaky_relu_plain)
    monkeypatch.setattr(upfirdn, "_launch", k2_plain)
    monkeypatch.setattr(modulate, "_launch", lambda counter, x, seg, s: modulate.regional_scale_plain(
        x, seg, s))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        x = _randn(1, 2, 5, 6).double().requires_grad_(True)
        b = _randn(2, seed=1).double().requires_grad_(True)
        assert torch.autograd.gradcheck(
            lambda x, b: fused_act._FusedLeakyReLU.apply(x, b, 0.2, 2 ** 0.5), (x, b))
        assert torch.autograd.gradcheck(
            lambda b: fused_act._FusedLeakyReLU.apply(x.detach(), b, 0.2, 2 ** 0.5), (b,))
        k = (upfirdn.make_kernel([1, 3, 3, 1]) * 4 + 0.01 * _randn(4, 4, seed=2)).double()
        for up, down, pad in ((1, 1, (1, 1)), (2, 1, (2, 1)), (1, 2, (1, 1)), (2, 2, (2, 1))):
            out_hw = tuple(upfirdn.out_size(n, 4, up, down, pad) for n in x.shape[2:])
            assert torch.autograd.gradcheck(
                lambda x: upfirdn._UpFirDn2d.apply(x, k, up, down, pad, out_hw), (x,))
        seg = _one_hot(1, 3, 5, 6).double()
        s = _randn(1, 3, 2, seed=3).double().requires_grad_(True)
        assert torch.autograd.gradcheck(lambda x, s: modulate._RegionalScale.apply(x, seg, s),
                                        (x, s))
        with torch.inference_mode():
            fused_act._FusedLeakyReLU.apply(x, b, 0.2, 2 ** 0.5)
            upfirdn._UpFirDn2d.apply(x, k, 1, 1, (1, 1), (4, 5))
            modulate._RegionalScale.apply(x, seg, s)
    finally:
        torch.set_num_threads(threads)

def test_double_backward_functions_with_plain_launches(monkeypatch):
    """The Functions that make K1's and K2's backwards differentiable, each
    launch replaced by its plain version: gradcheck in float64 of the
    backward as a function of the incoming gradient, whose own gradient is
    the double backward (K1's backward kernel on the sign mask of the saved
    output; K2's forward on the original taps)."""
    def k2_plain(counter, x, k, up, down, pad0, out_hw):
        kh = k.shape[0]
        p1 = [(o - 1) * down + kh - n * up - pad0 for o, n in zip(out_hw, x.shape[2:])]
        return upfirdn._upfirdn2d_native(x, k, up, down, (pad0, p1[0]), (pad0, p1[1]))

    monkeypatch.setattr(fused_act, "_launch_backward",
                        lambda counter, g, out, slope, scale:
                        fused_act.fused_leaky_relu_backward_plain(g, out, slope, scale))
    monkeypatch.setattr(upfirdn, "_launch", k2_plain)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = fused_act.fused_leaky_relu_plain(_randn(1, 2, 5, 6).double(), None)
        g = _randn(1, 2, 5, 6, seed=1).double().requires_grad_(True)
        assert torch.autograd.gradcheck(
            lambda g: fused_act._FusedLeakyReLUBackward.apply(g, out, 0.2, 2 ** 0.5), (g,))
        k = (upfirdn.make_kernel([1, 3, 3, 1]) * 4 + 0.01 * _randn(4, 4, seed=2)).double()
        for up, down, pad in ((1, 1, (1, 1)), (2, 1, (2, 1)), (1, 2, (2, 2)), (2, 2, (2, 1))):
            out_hw = tuple(upfirdn.out_size(n, 4, up, down, pad) for n in (5, 6))
            gy = _randn(1, 2, *out_hw, seed=3).double().requires_grad_(True)
            assert torch.autograd.gradcheck(
                lambda gy: upfirdn._UpFirDn2dBackward.apply(gy, k, up, down, pad, (5, 6)),
                (gy,))
    finally:
        torch.set_num_threads(threads)


def test_r1_through_the_functions_with_plain_launches(monkeypatch):
    """R1 of a 16^2 Discriminator and its gradient in every parameter through
    K1's and K2's Functions (each launch replaced by its plain version and
    counted, the card's checks skipped) equal plain autograd, and each K1
    and K2 of the penalty's forward has its double backward launched once."""
    from e4s2024_torch.losses.losses import r1_penalty
    from e4s2024_torch.models.stylegan2 import Discriminator

    def counted(counter, fn):
        counter.launches += 1
        return fn

    def k2_plain(counter, x, k, up, down, pad0, out_hw):
        kh = k.shape[0]
        p1 = [(o - 1) * down + kh - n * up - pad0 for o, n in zip(out_hw, x.shape[2:])]
        return counted(counter, upfirdn._upfirdn2d_native(x, k, up, down, (pad0, p1[0]),
                                                          (pad0, p1[1])))

    torch.manual_seed(0)
    d = Discriminator(16, 1)
    x = _randn(4, 3, 16, 16)

    def r1_and_grads():
        r1 = r1_penalty(d, x)
        return [r1.detach()] + list(torch.autograd.grad(r1 + d(x).mean(), list(d.parameters())))

    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # the suite runs six workers
    try:
        want = r1_and_grads()
    finally:
        torch.set_num_threads(threads)
    monkeypatch.setattr(fused_act, "_launch_forward", lambda x, b, s, sc: counted(
        fused_act.fused_leaky_relu, fused_act.fused_leaky_relu_plain(x, b, s, sc)))
    monkeypatch.setattr(fused_act, "_launch_backward", lambda c, g, out, s, sc: counted(
        c, fused_act.fused_leaky_relu_backward_plain(g, out, s, sc)))
    monkeypatch.setattr(upfirdn, "_launch", k2_plain)
    monkeypatch.setattr(kernels, "use_plain", lambda t: False)
    monkeypatch.setattr(kernels, "check_input", lambda *args, **kw: None)
    kernels.reset_launch_counts()
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        got = r1_and_grads()
    finally:
        torch.set_num_threads(threads)
    counts = kernels.launch_counts()
    # 7 K1 (convs.0, 2 per ResBlock, final_conv, final_linear.0) and 4 K2
    # (2 per ResBlock) a forward; the penalty's forward is the one
    # differentiated twice
    assert counts["fused_leaky_relu"] == 14 and counts["upfirdn2d"] == 8, counts
    assert counts["fused_leaky_relu_double_backward"] == 7, counts
    assert counts["upfirdn2d_double_backward"] == 4, counts
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


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
@pytest.mark.parametrize("up,down,pad", [(1, 1, (1, 1)), (1, 1, (2, 1)), (1, 1, (-1, 2)),
                                         (1, 1, (0, 3)), (2, 1, (2, 1)), (1, 2, (1, 1)),
                                         (2, 2, (2, 1))])
@pytest.mark.parametrize("perturbed", [False, True])
@pytest.mark.parametrize("shape", [(3, 4, 23, 37), (1, 1, 3, 3)])
def test_upfirdn2d_kernel_rank1_and_general_taps(cuda, dtype, up, down, pad, perturbed, shape):
    """The generator's rank-1 taps (the separable path at up 1 / down 1) and
    the same taps perturbed (the 2-D path), at an odd width; a 3 x 3 input
    is under the four 16-byte chunks the separable path reads and takes the
    2-D path."""
    x = _randn(*shape, device=cuda, dtype=dtype)
    k = upfirdn.make_kernel([1, 3, 3, 1]) * 4
    if perturbed:
        k = k + 0.01 * _randn(4, 4, seed=2)
    got = upfirdn.upfirdn2d(x, k, up=up, down=down, pad=pad)
    _assert_close_to_f32(got, upfirdn.upfirdn2d_plain(x.float(), k, up, down, pad))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("up,shape", [(1, (1, 3000, 9, 9)), (1, (2, 1500, 17, 17)),
                                      (1, (1, 2, 1025, 1025)), (1, (12, 24, 65, 65)),
                                      (1, (1, 70000, 9, 9)), (2, (1, 3, 512, 512)),
                                      (2, (2, 3, 9, 9)), (2, (1, 70000, 4, 6))])
def test_upfirdn2d_kernel_main_path_shapes(cuda, dtype, up, shape):
    """Up 1: the blur after a transposed convolution at odd input widths
    (each bfloat16 row starting 2 bytes off a 4-byte boundary every other
    row) and thousands of small planes; up 2: the ToRGB skips' FIR upsample
    (the 2-D path); both with more planes than a grid dimension holds."""
    x = _randn(*shape, device=cuda, dtype=dtype)
    k = upfirdn.make_kernel([1, 3, 3, 1])
    if up == 1:
        got, pad, want_hw = upfirdn.upfirdn2d(x, k * 4, pad=(1, 1)), (1, 1), (-1, -1)
    else:
        got, pad, want_hw = upfirdn.upsample_2x(x, k), (2, 1), shape[2:]
    assert got.shape == (*shape[:2], shape[2] + want_hw[0], shape[3] + want_hw[1])
    _assert_close_to_f32(got, upfirdn.upfirdn2d_plain(x.float(), k * 4, up, 1, pad))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,h,w,k", [(2, 70, 9, 31, 12), (1, 512, 4, 4, 12), (1, 3, 64, 64, 16),
                                       (1, 37, 16, 20, 16), (3, 130, 5, 7, 16),
                                       (1, 512, 8, 8, 12), (2, 129, 64, 64, 12), (1, 6, 3, 3, 1)])
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
    with pytest.raises(RuntimeError):  # K4-K6 are forward-only
        window_attention.fused_window_attention(
            *(_randn(2, 2, 64, 8, device=cuda).requires_grad_(True),) * 3,
            _randn(2, 64, 64, device=cuda))
    with pytest.raises(RuntimeError):  # a one-hot map carries no gradient
        modulate.regional_scale(x, _one_hot(1, 12, 8, 8, device=cuda).requires_grad_(True),
                                _randn(1, 12, 4, device=cuda))
    with pytest.raises(ValueError):
        upfirdn.upfirdn2d(x, torch.ones(5, 5))
    with pytest.raises(ValueError):
        modulate.regional_scale(x, _one_hot(1, 12, 4, 4, device=cuda), _randn(1, 12, 4, device=cuda))
    q = _randn(2, 2, 64, 8, device=cuda)
    with pytest.raises(ValueError):  # bias of the wrong type
        window_attention.fused_window_attention(q, q, q, _randn(2, 64, 64, device=cuda).double())
    with pytest.raises(ValueError):  # head_dim 40: the kernels pad a head to 32
        window_attention.swin_attention_nhwc(_randn(1, 8, 8, 240, device=cuda),
                                             _randn(2, 64, 64, device=cuda), window=8, heads=2)
    with pytest.raises(ValueError):  # 9 x 9 windows: the kernels pad a window to 64 tokens
        window_attention.fused_window_attention(*(_randn(1, 2, 81, 8, device=cuda),) * 3,
                                                _randn(2, 81, 81, device=cuda))
    wts = _block_weights(12, 2, 24, cuda, torch.float32)
    with pytest.raises(ValueError, match="packed"):  # the wrapper packs nothing itself
        swin_block.fused_swin_block(_randn(1, 8, 8, 12, device=cuda), wts, window=8, heads=2)
    wts["packed"] = swin_block.pack_block_weights(wts, 2)
    with pytest.raises(TypeError):  # weights made for float32, x in bfloat16
        swin_block.fused_swin_block(_randn(1, 8, 8, 12, device=cuda, dtype=torch.bfloat16), wts,
                                    window=8, heads=2)
    with pytest.raises(ValueError):  # wider than K5's tiles (C <= 192)
        swin_block.fused_swin_block(_randn(1, 8, 8, 240, device=cuda),
                                    _block_weights(240, 8, 480, cuda, torch.float32),
                                    window=8, heads=8)
    with pytest.raises(ValueError):  # head_dim 48 (K5 pads a head to 32)
        swin_block.fused_swin_block(_randn(1, 8, 8, 96, device=cuda),
                                    _block_weights(96, 2, 192, cuda, torch.float32),
                                    window=8, heads=2)
    with pytest.raises(ValueError):  # MLP wider than two tiles (hidden <= 384)
        swin_block.fused_swin_block(_randn(1, 8, 8, 96, device=cuda),
                                    _block_weights(96, 4, 480, cuda, torch.float32),
                                    window=8, heads=4)
    with pytest.raises(ValueError):  # a shift of the whole image or more
        swin_block.fused_swin_block(_randn(1, 8, 8, 12, device=cuda), wts, window=8, heads=2,
                                    shift=8)
    assert kernels.launch_counts() == dict.fromkeys(kernels.WRAPPERS, 0)


@pytest.mark.cuda
def test_plain_versions_on_card_launch_nothing(cuda):
    x = _randn(1, 4, 8, 8, device=cuda)
    with kernels.plain_versions_on_card():
        out = fused_act.fused_leaky_relu(x, None)
    assert out.is_cuda
    assert kernels.launch_counts() == dict.fromkeys(kernels.WRAPPERS, 0)


# ------------------------------------------------ K4-K6, window attention


def _labels(h, w, window, shift, device):
    """Window-region labels of the image rolled by -shift, (h/w, w/w, n)."""
    img = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(h // window, window, w // window, window).transpose(0, 2, 1, 3)
    return torch.from_numpy(np.ascontiguousarray(win).reshape(h // window, w // window, -1)).to(device)


def _assert_close_to_plain(got, want, rtol_bf16):
    """Kernel against its plain version in the same dtype: float32 differs in
    summation order only; in bfloat16 that order can flip a rounding of an
    intermediate, whose one-ulp step (2^-8) the later steps carry on."""
    assert got.dtype == want.dtype and got.shape == want.shape
    scale = float(want.float().abs().max())
    tol = 1e-4 * scale + 1e-5 if got.dtype == torch.float32 else rtol_bf16 * scale
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol, (err, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("bw,heads,n,hd", [(7, 6, 64, 30), (2 * 15, 2, 64, 6), (5, 3, 16, 8),
                                           (3, 3, 49, 5)])
def test_window_attention_kernel(cuda, dtype, masked, bw, heads, n, hd):
    q, k, v = (_randn(bw, heads, n, hd, device=cuda, dtype=dtype, seed=s) for s in (1, 2, 3))
    bias = 0.5 * _randn(heads, n, n, device=cuda, seed=4)
    labels = (torch.from_numpy(np.random.default_rng(5).integers(0, 4, (bw, n)).astype(np.int32))
              .to(cuda) if masked else None)
    got = window_attention.fused_window_attention(q, k, v, bias, labels)
    assert window_attention.fused_window_attention.launches == 1
    _assert_close_to_plain(got, window_attention.window_attention_plain(q, k, v, bias, labels),
                           2.0 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shift", [0, 4])
@pytest.mark.parametrize("b,h,w,c,heads", [(2, 24, 40, 12, 2), (1, 16, 24, 180, 6)])
def test_swin_attention_nhwc_kernel(cuda, dtype, shift, b, h, w, c, heads):
    qkv = _randn(b, h, w, 3 * c, device=cuda, dtype=dtype)
    bias = 0.5 * _randn(heads, 64, 64, device=cuda, seed=4)
    labels = _labels(h, w, 8, shift, cuda) if shift else None
    got = window_attention.swin_attention_nhwc(qkv, bias, labels, window=8, heads=heads)
    assert window_attention.swin_attention_nhwc.launches == 1
    want = window_attention.swin_attention_nhwc_plain(qkv, bias, labels, window=8, heads=heads)
    _assert_close_to_plain(got, want, 2.0 ** -7)


def _block_weights(c, heads, hidden, device, dtype, seed=7, n=64):
    g = np.random.default_rng(seed)

    def rnd(*shape, scale=1.0):
        return torch.from_numpy((scale * g.standard_normal(shape)).astype(np.float32)).to(device)

    wts = {"ln1_scale": 1 + 0.1 * rnd(c), "ln1_bias": 0.1 * rnd(c),
           "ln2_scale": 1 + 0.1 * rnd(c), "ln2_bias": 0.1 * rnd(c),
           "bias_hnn": 0.5 * rnd(heads, n, n),
           "qkv_w": rnd(c, 3 * c, scale=c ** -0.5), "qkv_b": 0.1 * rnd(3 * c),
           "proj_w": rnd(c, c, scale=c ** -0.5), "proj_b": 0.1 * rnd(c),
           "fc1_w": rnd(c, hidden, scale=c ** -0.5), "fc1_b": 0.1 * rnd(hidden),
           "fc2_w": rnd(hidden, c, scale=hidden ** -0.5), "fc2_b": 0.1 * rnd(c)}
    return {k: v if k in swin_block.F32_KEYS else v.to(dtype) for k, v in wts.items()}


def _packed_block_weights(c, heads, hidden, device, dtype, n=64):
    """`_block_weights` with the kernel's packed copy, as K5 takes them on a card."""
    wts = _block_weights(c, heads, hidden, device, dtype, n=n)
    wts["packed"] = swin_block.pack_block_weights(wts, heads)
    return wts


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shift", [0, 4])
@pytest.mark.parametrize("b,h,w,c,heads,hidden", [(2, 24, 40, 12, 2, 24), (1, 16, 24, 180, 6, 360)])
def test_swin_block_kernel(cuda, dtype, shift, b, h, w, c, heads, hidden):
    x = _randn(b, h, w, c, device=cuda, dtype=dtype)
    wts = _packed_block_weights(c, heads, hidden, cuda, dtype)
    labels = _labels(h, w, 8, shift, cuda) if shift else None
    got = swin_block.fused_swin_block(x, wts, labels, window=8, heads=heads)
    assert swin_block.fused_swin_block.launches == 1
    want = swin_block.fused_swin_block_plain(x, wts, labels, window=8, heads=heads)
    _assert_close_to_plain(got, want, 2.0 ** -5)
    # the shift inside the kernel: x as it was before the caller's roll
    unrolled = torch.roll(x, (shift, shift), dims=(1, 2))
    got = swin_block.fused_swin_block(unrolled, wts, labels, window=8, heads=heads, shift=shift)
    assert swin_block.fused_swin_block.launches == 2
    _assert_close_to_plain(got, torch.roll(want, (shift, shift), dims=(1, 2)), 2.0 ** -5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swin_block_kernel_small_window_odd_heads(cuda, dtype):
    """4 x 4 windows (16 of the 64 token rows in use) and three heads (the
    second pair holds one)."""
    x = _randn(2, 8, 12, 15, device=cuda, dtype=dtype)
    wts = _packed_block_weights(15, 3, 30, cuda, dtype, n=16)
    labels = _labels(8, 12, 4, 2, cuda)
    got = swin_block.fused_swin_block(x, wts, labels, window=4, heads=3, shift=2)
    want = swin_block.fused_swin_block_plain(x, wts, labels, window=4, heads=3, shift=2)
    _assert_close_to_plain(got, want, 2.0 ** -5)


def _grad_pair(fn, plain, inputs, g):
    """Gradients of fn(*inputs) and of plain(*inputs) (float32 copies of
    the same values) under g, rounded to the output's dtype for both, for
    the inputs that require grad."""
    want_in = [t.detach().float().requires_grad_(t.requires_grad) if t.is_floating_point() else t
               for t in inputs]
    out = fn(*inputs)
    g = g.to(out.dtype)
    got = torch.autograd.grad(out, [t for t in inputs if t.requires_grad], g)
    ref = plain(*want_in)
    want = torch.autograd.grad(ref, [t for t in want_in if t.requires_grad], g.float())
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grads", ["x", "bias", "both"])
def test_fused_leaky_relu_backward_kernel(cuda, dtype, grads):
    """K1 under autograd on the card: the backward kernel (counted once) and
    the bias sum against autograd of the plain version, with only x, only
    the bias, or both requiring grad."""
    x = _randn(2, 32, 33, 35, device=cuda, dtype=dtype).requires_grad_(grads != "bias")
    b = _randn(32, device=cuda, seed=1).requires_grad_(grads != "x")
    g = _randn(2, 32, 33, 35, device=cuda, seed=2)
    got, want = _grad_pair(fused_act.fused_leaky_relu, fused_act.fused_leaky_relu_plain,
                           (x, b), g)
    assert fused_act.fused_leaky_relu_backward.launches == 1
    for a, w in zip(got, want):
        if a.shape == (32,):
            # a float32 sum over 2 x 33 x 35 elements of grad_x, each rounded
            # once to the input's type: within that rounding of the sum of
            # their magnitudes (|grad_x| <= sqrt(2) |g|)
            scale = (g.to(dtype).float().abs() * np.sqrt(2.0)).sum(dim=(0, 2, 3))
            unit = 1e-6 if dtype == torch.float32 else 2.0 ** -8
            assert bool(((a.float() - w).abs() <= unit * scale + 1e-5).all()), (a, w)
        else:
            _assert_close_to_f32(a, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("up,down,pad,gain,shape", K2_GRAD_CASES + [
    (1, 1, (1, 1), 4.0, (1, 32, 1025, 1025)), (2, 1, (2, 1), 4.0, (1, 3, 512, 512))])
def test_upfirdn2d_backward_kernel(cuda, dtype, up, down, pad, gain, shape):
    """K2's gradient is K2 on the flipped taps (counted as
    `upfirdn2d_backward`), against autograd of the plain version, in the
    generator's cases at their 1024^2 shapes and the CPU test's others."""
    k = upfirdn.make_kernel([1, 3, 3, 1]) * gain
    x = _randn(*shape, device=cuda, dtype=dtype).requires_grad_(True)
    y_shape = upfirdn.upfirdn2d_plain(x.detach()[:1, :1].float(), k, up, down, pad).shape
    g = _randn(shape[0], shape[1], *y_shape[2:], device=cuda, seed=1)
    (got,), (want,) = _grad_pair(lambda t: upfirdn.upfirdn2d(t, k, up, down, pad),
                                 lambda t: upfirdn.upfirdn2d_plain(t, k, up, down, pad), (x,), g)
    assert upfirdn.upfirdn2d.launches == 1 and upfirdn.upfirdn2d_backward.launches == 1
    _assert_close_to_f32(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,h,w,k", [(1, 128, 256, 256, 12), (2, 70, 9, 31, 12),
                                       (1, 512, 4, 4, 12)])
def test_regional_scale_backward_kernel(cuda, dtype, b, c, h, w, k):
    """K3's grad_x is K3 itself (counted as `regional_scale_backward`);
    grad_scales is one batched product over pixels; both against autograd
    of the plain version."""
    x = _randn(b, c, h, w, device=cuda, dtype=dtype).requires_grad_(True)
    seg = _one_hot(b, k, h, w, device=cuda, dtype=dtype)
    s = _randn(b, k, c, device=cuda, dtype=dtype, seed=3).requires_grad_(True)
    g = _randn(b, c, h, w, device=cuda, seed=4)
    (gx, gs), (wx, ws) = _grad_pair(modulate.regional_scale, modulate.regional_scale_plain,
                                    (x, seg, s), g)
    assert modulate.regional_scale_backward.launches == 1
    _assert_close_to_f32(gx, wx)
    tol = 1e-4 if dtype == torch.float32 else 2e-2  # a sum over h * w products
    torch.testing.assert_close(gs.float(), ws, rtol=tol, atol=tol * float(ws.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_generator_gradients_through_the_kernels(cuda, mode, monkeypatch):
    """A 64^2 regional generator's loss gradient with respect to every
    parameter, through K1-K3 and their backwards, against the same gradient
    with the plain versions on the card (float32, within 1e-4 of each
    gradient's largest element). cuDNN runs its deterministic algorithms:
    with the others, the plain versions' own gradients vary from run to run
    by as much as they differ from the kernels', which at times pushed the
    comparison past the bound."""
    from e4s2024_torch.models.rgi import RGINet

    torch.manual_seed(0)
    net = RGINet(out_size=64, remaining_layer_idx=7, encoder_num_units=(1, 1, 1, 1)).to(cuda)
    sv = _randn(2, 12, 1280, device=cuda) * 0.1
    seg = _one_hot(2, 12, 32, 32, device=cuda)
    target = _randn(2, 3, 64, 64, device=cuda, seed=5)

    def grads():
        net.zero_grad(set_to_none=True)
        img, _, _ = net.gen_img(None, net.cal_style_codes(sv), seg, regional_mode=mode)
        ((img - target) ** 2).mean().backward()
        return {n: p.grad.clone() for n, p in net.named_parameters() if p.grad is not None}

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    got = grads()
    counts = kernels.launch_counts()
    with kernels.plain_versions_on_card():
        want = grads()
    for name in ("fused_leaky_relu", "upfirdn2d", "regional_scale"):
        assert counts[name] > 0 and counts[name + "_backward"] > 0, counts
    assert set(got) == set(want)
    for n, w in want.items():
        torch.testing.assert_close(got[n], w, rtol=1e-3, atol=1e-4 * float(w.abs().max()), msg=n)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_bfloat16_tuning_step_through_the_kernels(cuda, mode, monkeypatch):
    """One bfloat16 PTI step (PTIConfig(compute_dtype="bfloat16"): the
    float32 master weights cast to bfloat16, L2 + recolor) on a 64^2
    generator, through K1-K3 forward and their bfloat16 backwards, against
    the same step with the plain versions on the card: the loss within 1e-3
    relative (the forward), the float32 gradients of all the trainable
    weights within 5e-2 of their norm (bfloat16 rounds the activations and
    gradients at other places in the two), the backwards launched."""
    from e4s2024_torch.models.rgi import RGINet
    from e4s2024_torch.training.pti import PTICoach, PTIConfig

    torch.manual_seed(0)
    net = RGINet(out_size=64, remaining_layer_idx=7, encoder_num_units=(1, 1, 1, 1)).to(cuda)
    coach = PTICoach(net, {}, PTIConfig(compute_dtype="bfloat16", lpips_lambda=0.0,
                                        id_lambda=0.0, face_parsing_lambda=0.0,
                                        regional_mode=mode))
    rng = np.random.default_rng(6)
    frames = torch.from_numpy((rng.random((2, 64, 64, 3)) * 255).astype(np.uint8)).to(cuda)
    labels = torch.from_numpy(rng.integers(0, 12, (2, 64, 64))).to(cuda)
    sv = _randn(2, 12, 1280, device=cuda, seed=7) * 0.1

    def step():
        work, _ = coach._working_copy(None)
        loss, _ = coach._chunk_loss(work, frames, labels, sv, frames)
        loss.backward()
        grads = [p.grad for p in work.parameters() if p.grad is not None]
        assert grads and all(g.dtype == torch.float32 for g in grads)
        return float(loss), torch.cat([g.flatten() for g in grads])

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    loss, got = step()
    counts = kernels.launch_counts()
    with kernels.plain_versions_on_card():
        want_loss, want = step()
    for name in ("fused_leaky_relu", "upfirdn2d", "regional_scale"):
        assert counts[name] > 0 and counts[name + "_backward"] > 0, counts
    assert loss == pytest.approx(want_loss, rel=1e-3)
    assert float((got - want).norm()) <= 5e-2 * float(want.norm())


def _penalty_grads(fn, params, x):
    """R1's pattern: ||d fn(x).sum() / dx||^2 and its gradient in `params`."""
    xr = x.detach().requires_grad_(True)
    (gx,) = torch.autograd.grad(fn(xr).sum(), xr, create_graph=True)
    pen = gx.square().sum()
    return [pen.detach()] + [g.detach() for g in torch.autograd.grad(pen, params)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 32, 33, 35), (4, 64, 256, 256)])
def test_fused_leaky_relu_double_backward_kernel(cuda, shape):
    """K1's double backward on the card against autograd twice through the
    plain version: float32, within 1e-5 of the largest element. A scale c
    before and after K1, so that the gradient K1's backward receives
    depends on a parameter and the penalty's gradient in c needs the
    double backward."""
    x = _randn(*shape, device=cuda)
    c = _randn(1, shape[1], 1, 1, device=cuda, seed=1).requires_grad_(True)
    b = _randn(shape[1], device=cuda, seed=2).requires_grad_(True)
    w = _randn(*shape, device=cuda, seed=3)

    def fn(t):
        return w * c * fused_act.fused_leaky_relu(t * c, b)

    got = _penalty_grads(fn, [c], x)
    assert fused_act.fused_leaky_relu_double_backward.launches == 1
    with kernels.plain_versions_on_card():
        want = _penalty_grads(fn, [c], x)
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, rtol=1e-5, atol=1e-5 * float(e.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("up,down,pad,gain,shape", [
    (1, 2, (2, 2), 1.0, (4, 64, 256, 256)), (1, 2, (1, 1), 1.0, (2, 32, 33, 34)),
    (2, 1, (2, 1), 4.0, (2, 3, 64, 64)), (1, 1, (1, 1), 4.0, (1, 32, 129, 129))])
def test_upfirdn2d_double_backward_kernel(cuda, up, down, pad, gain, shape):
    """K2's double backward (its forward on the original taps, counted as
    `upfirdn2d_double_backward`) against autograd twice through the plain
    version, with a scale c before and after it (as in K1's case)."""
    k = upfirdn.make_kernel([1, 3, 3, 1]) * gain
    x = _randn(*shape, device=cuda)
    c = _randn(1, shape[1], 1, 1, device=cuda, seed=1).requires_grad_(True)
    oh, ow = (upfirdn.out_size(n, 4, up, down, pad) for n in shape[2:])
    w = _randn(shape[0], shape[1], oh, ow, device=cuda, seed=2)

    def fn(t):
        y = upfirdn.upfirdn2d(fused_act.fused_leaky_relu_plain(t * c), k, up, down, pad)
        return w * c * y

    got = _penalty_grads(fn, [c], x)
    assert upfirdn.upfirdn2d_double_backward.launches == 1
    with kernels.plain_versions_on_card():
        want = _penalty_grads(fn, [c], x)
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, rtol=1e-5, atol=1e-5 * float(e.abs().max()))


@pytest.mark.cuda
def test_regional_scale_second_derivative_raises(cuda):
    """K3's backward is once-differentiable: a second derivative through it
    raises on the card rather than falling back."""
    x = _randn(1, 8, 6, 6, device=cuda).requires_grad_(True)
    seg = _one_hot(1, 4, 6, 6, device=cuda)
    s = _randn(1, 4, 8, device=cuda, seed=1)
    (gx,) = torch.autograd.grad(modulate.regional_scale(x, seg, s).square().sum(), x,
                                create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        gx.sum().backward()


# K7 cases: (batch, in_h, in_w, buffer width, cin, n, out_off, fold, epilogue)
RDB_CASES = {
    "conv1 into the buffer, ragged tiles": (2, 21, 35, 192, 64, 32, 64, 1, "act"),
    "conv4 into the buffer": (1, 16, 16, 192, 160, 32, 160, 1, "act"),
    "conv5 with the block's residual": (2, 19, 17, 192, 192, 64, 0, 1, "res1"),
    "conv5 with the RRDB's residual in place": (1, 18, 33, 192, 192, 64, 0, 1, "res2"),
    "conv_body with + feat": (1, 16, 40, 64, 64, 64, 0, 1, "body"),
    "conv_up with the x2 fold": (2, 9, 13, 64, 64, 64, 0, 2, "act"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(RDB_CASES))
def test_rdb_conv_kernel(cuda, case):
    """K7 against its plain version on the card (float32 convolutions in
    full float32): every epilogue, the x2 fold, tiles cut by the image's
    edge; the channels outside the written slice stay as they were. 3xTF32
    leaves about 2^-20 of sum |x||w| per product: within 1e-5 of the
    largest output."""
    b, h, w, width, cin, n, off, fold, mode = RDB_CASES[case]
    x = _randn(b, h, w, width, device=cuda)
    weight = _randn(n, cin, 3, 3, device=cuda, seed=1) * (9 * cin) ** -0.5
    bias = _randn(n, device=cuda, seed=2) * 0.1
    big = (b, fold * h, fold * w)
    out = x if off else _randn(*big, width, device=cuda, seed=3)
    kw = {"fold": fold, "act": mode == "act"}
    if mode in ("res1", "res2"):
        kw.update(res1=x, s1=0.2)
    if mode == "res2":
        kw.update(res2=out, s2=0.2)
    if mode == "body":
        kw.update(res1=_randn(*big, 64, device=cuda, seed=4))
    want = rdb_conv.rdb_conv_plain(x.clone(), weight, bias, out.clone(), off,
                                   **{k: v.clone() if torch.is_tensor(v) else v
                                      for k, v in kw.items()})
    before = out.clone()
    got = rdb_conv.rdb_conv(x, weight, bias, out, off, packed=rdb_conv.pack_weights(weight),
                            **kw)
    torch.cuda.synchronize()
    assert rdb_conv.rdb_conv.launches == 1
    keep = torch.ones(width, dtype=torch.bool)
    keep[off:off + n] = False
    assert torch.equal(got[..., keep], before[..., keep])
    torch.testing.assert_close(got[..., off:off + n], want[..., off:off + n], rtol=1e-5,
                               atol=1e-5 * float(want[..., off:off + n].abs().max()))


@pytest.mark.cuda
def test_rrdbnet_through_k7(cuda):
    """A two-RRDB net at the published widths on a 20 x 24 crop: the dense
    path (5 launches a block, 4 in the tail) against the plain modules."""
    from e4s2024_torch.models.rrdb import RRDBNet

    torch.manual_seed(0)
    net = RRDBNet(64, 2, 32).to(cuda).eval().requires_grad_(False)
    x = torch.rand(2, 20, 24, 3, device=cuda)
    with torch.inference_mode():
        got = net.forward_nhwc(x)
        want = net(x.permute(0, 3, 1, 2).contiguous()).permute(0, 2, 3, 1)
    assert rdb_conv.rdb_conv.launches == 2 * 3 * 5 + 4
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
