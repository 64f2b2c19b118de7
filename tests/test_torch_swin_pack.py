"""Kernel K5's weight packing, its in-kernel shift, and the 3xTF32 product.

On the CPU: `pack_block_weights` lays a block's weights out as the CUDA
kernel streams them, and everything here that the kernel relies on is plain
tensor code: the packing round-trips, the plain block gives the same bits
from unpacked weights, `fused_swin_block(..., shift=s)` equals roll -> JAX
`fused_swin_block` (Pallas, interpret mode) -> roll, and a numpy emulation of
the kernel's error-compensated tf32 product stays close to float64.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from e4s2024_tpu.models.swinir import SwinBlock as JSwinBlock
from e4s2024_tpu.models.swinir import _block_weights, _shift_labels
from e4s2024_tpu.ops.swin_block import fused_swin_block as j_fused_swin_block

from e4s2024_torch.ops.swin_block import (
    HEAD_DIM, TILE, fused_swin_block, fused_swin_block_plain, pack_block_weights, slab_depth,
    widths_ok)
from tests.test_torch_kernels import _block_weights as _random_block_weights
from tests.test_torch_swinir import _port_block_weights, swin_params
from tests.test_torch_criterion import jit_apply, two_threads  # noqa: F401

SHAPES = [(12, 2, 24), (180, 6, 360), (15, 3, 30)]
DTYPES = [torch.float32, torch.bfloat16]


def _weights(c, heads, hidden, dtype):
    return _random_block_weights(c, heads, hidden, "cpu", dtype)


def _unslab(slabs, depth):
    """(S, TILE * depth) -> (TILE, S * depth): inside a slab, column n at depth
    k lies in core matrix (n // 8, k // core) at (n % 8, k % core), a core
    matrix being 8 columns by 16 bytes of k."""
    core = 16 // slabs.element_size()
    cut = slabs.reshape(-1, TILE // 8, depth // core, 8, core)  # (slab, group, kg, row, k)
    return cut.permute(1, 3, 0, 2, 4).reshape(TILE, -1)


def unpack_block_weights(packed):
    """The weight dict `pack_block_weights` was given, read back from the
    layout its docstring and swin_block.cu state."""
    c, heads, hidden = packed["dims"]
    slabs, vecs = packed["slabs"], packed["vec"]
    dtype, hd, depth = slabs.dtype, c // heads, slabs.shape[-1] // TILE
    pairs, chunks = -(-heads // 2), -(-hidden // TILE)
    kc = -(-c // depth)

    def mats(first, count, k_slabs):
        """`count` matrices of `k_slabs` slabs from slab `first`: (count, TILE, K)."""
        return torch.stack([_unslab(slabs[first + i * k_slabs:first + (i + 1) * k_slabs], depth)
                            for i in range(count)])

    def from_pairs(t):
        """(pairs, 2 * 3 * HEAD_DIM, ...) -> (3, heads, hd, ...)."""
        t = t.reshape(pairs, 2, 3, HEAD_DIM, *t.shape[2:]).transpose(1, 2).transpose(0, 1)
        return t.reshape(3, 2 * pairs, HEAD_DIM, *t.shape[4:])[:, :heads, :hd]

    qkv = from_pairs(mats(0, pairs, kc))[..., :c].reshape(3 * c, c)
    proj = mats(pairs * kc, 1, kc)[0, :c, :c]
    fc1 = mats((pairs + 1) * kc, chunks, kc).reshape(chunks * TILE, -1)[:hidden, :c]
    fc2 = mats((pairs + 1 + chunks) * kc, 1, slabs.shape[0] - (pairs + 1 + chunks) * kc)
    fixed = vecs[:6 * TILE].reshape(6, TILE)[:, :c]  # LN scales and biases, proj_b, fc2_b
    qkv_b = from_pairs(vecs[6 * TILE:(6 + pairs) * TILE].reshape(pairs, TILE))
    wts = {"ln1_scale": fixed[0], "ln1_bias": fixed[1], "ln2_scale": fixed[2],
           "ln2_bias": fixed[3], "bias_hnn": packed["bias_hnn"],
           "qkv_w": qkv.t(), "qkv_b": qkv_b.reshape(-1).to(dtype),
           "proj_w": proj.t(), "proj_b": fixed[4].to(dtype),
           "fc1_w": fc1.t(), "fc1_b": vecs[(6 + pairs) * TILE:][:hidden].to(dtype),
           "fc2_w": fc2[0, :c, :hidden].t(), "fc2_b": fixed[5].to(dtype)}
    return {k: v.contiguous() for k, v in wts.items()}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,heads,hidden", SHAPES)
def test_pack_round_trips(c, heads, hidden, dtype):
    wts = _weights(c, heads, hidden, dtype)
    packed = pack_block_weights(wts, heads)
    back = unpack_block_weights(packed)
    assert set(back) == set(wts)
    for key, t in wts.items():
        assert back[key].dtype == t.dtype and back[key].is_contiguous(), key
        assert torch.equal(back[key], t), key


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,heads,hidden", SHAPES)
def test_pack_layout_and_zero_padding(c, heads, hidden, dtype):
    """As many slabs as the kernel consumes, and nothing but the weights in
    them: the padding adds zeros, so the sums of squares agree."""
    wts = _weights(c, heads, hidden, dtype)
    packed = pack_block_weights(wts, heads)
    depth = slab_depth(dtype)
    pairs, chunks, kc = -(-heads // 2), -(-hidden // TILE), -(-c // depth)
    slabs, vec = packed["slabs"], packed["vec"]
    assert depth * slabs.element_size() == 64
    assert slabs.shape == ((pairs + 1 + chunks) * kc + -(-hidden // depth), TILE * depth)
    assert slabs.dtype == dtype and slabs.is_contiguous()
    assert vec.shape == ((6 + pairs + chunks) * TILE,) and vec.dtype == torch.float32
    assert packed["dims"] == (c, heads, hidden)
    mats = ("qkv_w", "proj_w", "fc1_w", "fc2_w")
    assert float(slabs.double().square().sum()) == pytest.approx(
        sum(float(wts[k].double().square().sum()) for k in mats), rel=1e-12)
    vecs = ("ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias", "proj_b", "fc2_b", "qkv_b",
            "fc1_b")
    assert float(vec.double().square().sum()) == pytest.approx(
        sum(float(wts[k].double().square().sum()) for k in vecs), rel=1e-12)
    # a pair's columns are head * 96 + part * 32 + d
    qkv_t = _unslab(slabs[:kc], depth)
    hd = c // heads
    for head, part, d in [(0, 0, 0), (min(1, heads - 1), 2, hd - 1), (0, 1, hd // 2)]:
        row = qkv_t[head * 96 + part * 32 + d, :c]
        assert torch.equal(row, wts["qkv_w"][:, part * c + head * hd + d])
    assert not qkv_t[:, c:].any() and not qkv_t[hd:32].any()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,heads,hidden", [(12, 2, 24), (180, 6, 360)])
def test_plain_block_from_packed_weights_is_bit_identical(c, heads, hidden, dtype):
    wts = _weights(c, heads, hidden, dtype)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 8, 16, c))
                         .astype(np.float32)).to(dtype)
    want = fused_swin_block_plain(x, wts, None, window=8, heads=heads)
    got = fused_swin_block_plain(x, unpack_block_weights(pack_block_weights(wts, heads)), None,
                                 window=8, heads=heads)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shift", [0, 4])
def test_shift_inside_the_block_matches_jax(shift):
    """fused_swin_block(x, shift=s) is roll -> JAX fused_swin_block (Pallas,
    interpret mode) -> roll, within the tolerance of
    test_torch_swinir.py::test_fused_swin_block_matches_jax (float32
    summation order through one block)."""
    rng = np.random.default_rng(3)
    b, h, w, c, heads, ws = 2, 16, 24, 12, 2, 8
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    module = JSwinBlock(dim=c, heads=heads, window=ws, shift=shift)
    params = swin_params(jax.eval_shape(module.init, jax.random.PRNGKey(1),
                                        jnp.zeros((b, h, w, c)))["params"], 4)
    labels = (_shift_labels(h, w, ws, shift).astype(np.int32).reshape(h // ws, w // ws, 64)
              if shift else None)
    want = j_fused_swin_block(jnp.roll(jnp.asarray(x), (-shift, -shift), axis=(1, 2)),
                              _block_weights(params, ws, heads),
                              None if labels is None else jnp.asarray(labels),
                              window=ws, heads=heads, interpret=True)
    want = np.asarray(jnp.roll(want, (shift, shift), axis=(1, 2)))
    got = fused_swin_block(torch.from_numpy(x), _port_block_weights(params, heads),
                           None if labels is None else torch.from_numpy(labels),
                           window=ws, heads=heads, shift=shift)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-4)
    want_module = np.asarray(jit_apply(module, {"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want_module, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("shift", [0, 3])
def test_plain_shift_is_two_rolls(shift):
    wts = _weights(12, 2, 24, torch.float32)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 8, 16, 12))
                         .astype(np.float32))
    got = fused_swin_block(x, wts, None, window=8, heads=2, shift=shift)
    rolled = fused_swin_block(torch.roll(x, (-shift, -shift), dims=(1, 2)), wts, None,
                              window=8, heads=2)
    assert torch.equal(got, torch.roll(rolled, (shift, shift), dims=(1, 2)))
    assert "packed" not in wts  # the CPU path neither needs nor makes the packed copy


@pytest.mark.parametrize("c,heads,hidden,window,ok", [
    (180, 6, 360, 8, True), (192, 6, 384, 8, True), (12, 2, 24, 4, True),
    (240, 8, 480, 8, False),   # wider than a 192-column tile
    (96, 2, 192, 8, False),    # head_dim 48: a head is padded to 32
    (96, 4, 480, 8, False),    # MLP wider than two tiles
    (96, 4, 192, 9, False),    # 81 tokens: a window is padded to 64
    (90, 4, 180, 8, False),    # C not a multiple of heads
])
def test_widths_ok(c, heads, hidden, window, ok):
    assert widths_ok(c, heads, hidden, window) is ok
    if not ok and window <= 8 and c % heads == 0:
        with pytest.raises(ValueError):
            pack_block_weights(_weights(c, heads, hidden, torch.float32), heads)


def _cut(a: np.ndarray) -> np.ndarray:
    """float32 values with the mantissa cut to tf32's 10 bits."""
    return (a.astype(np.float32).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


@pytest.mark.parametrize("k", [32, 192, 360])
def test_three_tf32_products_stay_close_to_float64(k):
    """The kernels' float32 product: a = hi + lo with hi = a cut to 10
    mantissa bits and lo = a - hi, cut again as the tensor core reads it;
    a . b ~ lo_a . hi_b + hi_a . lo_b + hi_a . hi_b. Against the float64
    product the error stays under 2e-6 of sum |a||b| (one cut product alone
    leaves 1e-3), which is why the card tests hold the float32 kernels to
    the bounds they had with float32 FMAs."""
    rng = np.random.default_rng(k)
    a = rng.standard_normal((64, k)).astype(np.float32)
    b = (rng.standard_normal((k, 192)) * k ** -0.5).astype(np.float32)
    a_hi, b_hi = _cut(a), _cut(b)
    a_lo, b_lo = _cut(a - a_hi), _cut(b - b_hi)
    f64 = np.float64
    got = a_lo.astype(f64) @ b_hi.astype(f64) + a_hi.astype(f64) @ b_lo.astype(f64) \
        + a_hi.astype(f64) @ b_hi.astype(f64)
    want = a.astype(f64) @ b.astype(f64)
    scale = np.abs(a).astype(f64) @ np.abs(b).astype(f64)
    assert float((np.abs(got - want) / scale).max()) < 2e-6
    assert float(np.abs(got - want).max() / np.abs(want).max()) < 2e-6
    one = a_hi.astype(f64) @ b_hi.astype(f64)
    assert float((np.abs(one - want) / scale).max()) > 1e-4
