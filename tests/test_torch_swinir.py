"""The port's SwinIR (window attention K4/K6, the fused Swin block K5, the
model in its three routes, the upscaler and the enhancer) against the JAX
package's, on the CPU, at small sizes.

The JAX kernels run in the Pallas interpreter (`interpret=True`), as
tests/test_window_attention.py and tests/test_swin_fused.py run them; the
port runs each kernel's plain PyTorch version, which its wrapper takes for a
CPU tensor. Weights come from a numpy seed (tests/test_torch_models.py's
`random_params`, with the dense layers scaled to unit gain) and cross to the
port through `convert.swinir_state_dict_from_jax`.

Tolerances: float32 on both sides differs only in summation order, so
outputs of O(1) agree within 2e-5 (the attention) and 2e-4 relative to the
largest value (the whole model, ten Swin blocks and eleven convolutions);
the [0, 255] upscaler output within 5e-3 levels.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from e4s2024_tpu.convert.torch_loader import convert_swinir
from e4s2024_tpu.models.swinir import SwinBlock as JSwinBlock
from e4s2024_tpu.models.swinir import SwinIR as JSwinIR
from e4s2024_tpu.models.swinir import SwinIREnhancer as JSwinIREnhancer
from e4s2024_tpu.models.swinir import SwinIRUpscaler as JSwinIRUpscaler
from e4s2024_tpu.models.swinir import _block_weights, _rel_pos_index, _shift_labels, _shift_mask
from e4s2024_tpu.models.swinir import apply_fused as j_apply_fused
from e4s2024_tpu.ops.swin_block import fused_swin_block as j_fused_swin_block
from e4s2024_tpu.ops.window_attention import fused_window_attention as j_fused_window_attention
from e4s2024_tpu.ops.window_attention import reference_window_attention
from e4s2024_tpu.ops.window_attention import swin_attention_nhwc as j_swin_attention_nhwc

from e4s2024_torch import kernels
from e4s2024_torch.convert import swin_block_state_dict_from_jax, swinir_state_dict_from_jax
from e4s2024_torch.models import swinir
from e4s2024_torch.models.swinir import SwinIR, SwinIREnhancer, SwinIRUpscaler, apply_fused
from e4s2024_torch.ops.swin_block import block_weights, fused_swin_block
from e4s2024_torch.ops.window_attention import fused_window_attention, swin_attention_nhwc
from tests.test_torch_models import random_params, torch_to_numpy
from tests.test_torch_criterion import jit_apply, two_threads  # noqa: F401

TINY = dict(embed_dim=24, depths=(2, 2), heads=(2, 2), num_feat=16)
ATT_TOL = dict(atol=2e-5, rtol=2e-5)


def swin_params(shapes, seed: int):
    """random_params with every dense kernel scaled by 1/sqrt(fan_in), so
    that activations stay O(1) through the blocks."""
    params = random_params(shapes, seed)

    def scale(path, leaf):
        if path[-1].key == "kernel" and leaf.ndim == 2:
            return leaf / np.float32(np.sqrt(leaf.shape[0]))
        return leaf

    return jax.tree_util.tree_map_with_path(scale, params)


@pytest.fixture(scope="module")
def tiny():
    model = JSwinIR(**TINY)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
    params = swin_params(shapes["params"], 21)
    return model, params, swinir_state_dict_from_jax(params)


def _qkv(rng, bw, heads, n, d):
    return [rng.standard_normal((bw, heads, n, d)).astype(np.float32) for _ in range(3)]


# ------------------------------------------------------- K6, K4, K5


@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_matches_jax(masked):
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, 6, 2, 64, 8)
    bias = (0.5 * rng.standard_normal((2, 64, 64))).astype(np.float32)
    labels = rng.integers(0, 4, (6, 64)).astype(np.int32) if masked else None
    jl = None if labels is None else jnp.asarray(labels)
    args = [jnp.asarray(a) for a in (q, k, v, bias)]
    want_ref = np.asarray(reference_window_attention(*args, jl))
    want_pallas = np.asarray(j_fused_window_attention(*args, jl, interpret=True))
    got = fused_window_attention(*(torch.from_numpy(a) for a in (q, k, v, bias)),
                                 None if labels is None else torch.from_numpy(labels)).numpy()
    np.testing.assert_allclose(got, want_ref, **ATT_TOL)
    np.testing.assert_allclose(got, want_pallas, **ATT_TOL)


@pytest.mark.parametrize("shift", [0, 4])
def test_swin_attention_nhwc_matches_jax(shift):
    rng = np.random.default_rng(2)
    b, h, w, heads, hd, ws = 2, 16, 24, 2, 6, 8
    qkv = rng.standard_normal((b, h, w, 3 * heads * hd)).astype(np.float32)
    bias = (0.5 * rng.standard_normal((heads, 64, 64))).astype(np.float32)
    labels = (_shift_labels(h, w, ws, shift).astype(np.int32).reshape(h // ws, w // ws, 64)
              if shift else None)
    want = np.asarray(j_swin_attention_nhwc(
        jnp.asarray(qkv), jnp.asarray(bias), None if labels is None else jnp.asarray(labels),
        window=ws, heads=heads, interpret=True))
    got = swin_attention_nhwc(torch.from_numpy(qkv), torch.from_numpy(bias),
                              None if labels is None else torch.from_numpy(labels),
                              window=ws, heads=heads)
    np.testing.assert_allclose(got.numpy(), want, **ATT_TOL)


def _port_block_weights(jparams, heads, dtype=torch.float32):
    """The port's K5 weight dict, through the port's own block module."""
    blk = swinir.SwinBlock(jparams["norm1"]["scale"].shape[0], heads, 8)
    blk.load_state_dict(swin_block_state_dict_from_jax(jparams), strict=True)
    return block_weights(blk.norm1, blk.attn.qkv, blk.attn.proj, blk.attn.bias_hnn(),
                         blk.norm2, blk.mlp.fc1, blk.mlp.fc2, dtype)


@pytest.mark.parametrize("shift", [0, 4])
def test_fused_swin_block_matches_jax(shift):
    """K5's plain version against the Pallas kernel (interpret mode) and the
    JAX module, on tests/test_swin_fused.py's shapes."""
    rng = np.random.default_rng(3)
    b, h, w, c, heads, ws = 2, 16, 24, 12, 2, 8
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    module = JSwinBlock(dim=c, heads=heads, window=ws, shift=shift)
    params = swin_params(jax.eval_shape(module.init, jax.random.PRNGKey(1),
                                        jnp.zeros((b, h, w, c)))["params"], 4)
    want_module = np.asarray(jit_apply(module, {"params": params}, jnp.asarray(x)))
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    labels = None
    if shift:
        jx = jnp.roll(jx, (-shift, -shift), axis=(1, 2))
        tx = torch.roll(tx, (-shift, -shift), dims=(1, 2))
        labels = _shift_labels(h, w, ws, shift).astype(np.int32).reshape(h // ws, w // ws, 64)
    want = j_fused_swin_block(jx, _block_weights(params, ws, heads),
                              None if labels is None else jnp.asarray(labels),
                              window=ws, heads=heads, interpret=True)
    got = fused_swin_block(tx, _port_block_weights(params, heads),
                           None if labels is None else torch.from_numpy(labels),
                           window=ws, heads=heads)
    if shift:
        want = jnp.roll(want, (shift, shift), axis=(1, 2))
        got = torch.roll(got, (shift, shift), dims=(1, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(got.numpy(), want_module, atol=2e-4, rtol=2e-4)


# ------------------------------------------------------- the model


def test_helpers_match_jax():
    np.testing.assert_array_equal(swinir.rel_pos_index(8), _rel_pos_index(8))
    np.testing.assert_array_equal(swinir.shift_labels(16, 24, 8, 4), _shift_labels(16, 24, 8, 4))
    np.testing.assert_array_equal(swinir.shift_mask(16, 16, 8, 4), _shift_mask(16, 16, 8, 4))
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 16, 24, 5)))
    wins = swinir.window_partition(x, 8)
    assert wins.shape == (2 * 6, 64, 5)
    torch.testing.assert_close(swinir.window_reverse(wins, 8, 16, 24), x, rtol=0, atol=0)


def test_state_dict_round_trip_and_strict_load(tiny):
    _, params, sd = tiny
    model = SwinIR(**TINY)
    model.load_state_dict(sd, strict=True)
    assert set(model.state_dict()) == set(sd)
    back = convert_swinir(torch_to_numpy(model.state_dict()))
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, jax.tree_util.tree_map(
        np.asarray, params))


def _model(sd, **kw):
    model = SwinIR(**TINY, **kw)
    model.load_state_dict(sd, strict=True)
    return model.eval()


@pytest.mark.parametrize("route", ["windowed", "nhwc", "fused"])
def test_swinir_routes_match_jax(tiny, route):
    """All three attention routes against JAX `model.apply`; the fused route
    also against JAX `apply_fused` with the Pallas block in interpret mode."""
    jmodel, params, sd = tiny
    x = np.random.default_rng(5).random((1, 16, 16, 3)).astype(np.float32)
    want = np.asarray(jit_apply(jmodel, {"params": params}, jnp.asarray(x)))
    model = _model(sd, use_kernel=route == "nhwc")
    with torch.inference_mode():
        got = (apply_fused(model, torch.from_numpy(x)) if route == "fused"
               else model(torch.from_numpy(x))).numpy()
    assert got.shape == (1, 64, 64, 3) and got.dtype == np.float32
    tol = 2e-4 * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol, rtol=2e-4)
    if route == "fused":
        want_fused = np.asarray(j_apply_fused(jmodel, params, jnp.asarray(x), interpret=True))
        np.testing.assert_allclose(got, want_fused, atol=tol, rtol=2e-4)


def test_swinir_bfloat16_tracks_float32(tiny):
    """The fused route in bfloat16 against JAX's float32 model: bfloat16 keeps
    8 bits of mantissa through ten blocks, so within 0.05 (the JAX package's
    own bound for its bfloat16 fused executor, tests/test_swin_fused.py)."""
    jmodel, params, sd = tiny
    x = np.random.default_rng(6).random((1, 16, 16, 3)).astype(np.float32)
    want = np.asarray(jit_apply(jmodel, {"params": params}, jnp.asarray(x)))
    with torch.inference_mode():
        got = apply_fused(_model(sd, dtype=torch.bfloat16), torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=0.05, rtol=0.05)


def test_upscaler_flip_pads_like_jax(tiny):
    jmodel, params, sd = tiny
    img = (np.random.default_rng(7).random((1, 13, 11, 3)) * 255).astype(np.float32)
    want = np.asarray(JSwinIRUpscaler(params, model=jmodel).upscale(img))
    up = SwinIRUpscaler(sd, device="cpu", **TINY)
    got = up.upscale(img).numpy()
    assert got.shape == (1, 52, 44, 3)
    assert got.min() >= 0 and got.max() <= 255
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=0)


def test_enhancer_chunks_like_jax(tiny):
    """B=5 crops with max_batch=2: chunks of 2, the last padded with a copy of
    the last crop; the x4 output resized back to the crop size."""
    jmodel, params, sd = tiny
    crops = (np.random.default_rng(8).random((5, 16, 16, 3)) * 255).astype(np.float32)
    want = np.asarray(JSwinIREnhancer(JSwinIRUpscaler(params, model=jmodel),
                                      max_batch=2).enhance_aligned(jnp.asarray(crops)))
    up = SwinIRUpscaler(sd, device="cpu", **TINY)
    calls = []
    up_forward = up.forward
    up.forward = lambda x: calls.append(x.shape[0]) or up_forward(x)
    got = SwinIREnhancer(up, max_batch=2).enhance_aligned(crops).numpy()
    assert calls == [2, 2, 2]
    assert got.shape == crops.shape
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=0)


def test_routes_launch_nothing_on_the_cpu(tiny):
    """On CPU tensors every wrapper takes its plain version: no launches."""
    _, _, sd = tiny
    kernels.reset_launch_counts()
    x = torch.rand(1, 16, 16, 3)
    with torch.inference_mode():
        apply_fused(_model(sd), x)
        _model(sd, use_kernel=True)(x)
        _model(sd)(x)
    assert kernels.launch_counts() == dict.fromkeys(kernels.WRAPPERS, 0)
