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
from e4s2024_torch.ops import fused_act, modulate, swin_block, upfirdn, window_attention


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
                                     "fused_window_attention"}
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
    with pytest.raises(RuntimeError):
        fused_act.fused_leaky_relu(x.clone().requires_grad_(True), None)
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
