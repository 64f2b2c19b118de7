"""The port's tuning module against the JAX package's, on the CPU: the
trainable mask (at 64^2 and 1024^2), the first PTI step's gradient on
tests/test_pti_optim.py's tiny RGINet, the mask helpers, and what the
coaches refuse. The PTI and stitching coaches' whole tunes are held
against JAX's in tests/test_torch_coaches.py and
tests/test_torch_stitching.py, the loss nets and the criterion in
tests/test_torch_criterion.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from e4s2024_tpu.models.rgi import RGINet as JRGINet
from e4s2024_tpu.training import pti as jpti
from e4s2024_tpu.training.coach import TrainConfig as JTrainConfig
from e4s2024_tpu.training.coach import _g_trainable_mask as j_g_trainable_mask

from e4s2024_torch.convert import rgi_state_dict_from_jax
from e4s2024_torch.models.rgi import RGINet
from e4s2024_torch.training import pti
from e4s2024_torch.training.coach import TrainConfig, _g_trainable_mask
from tests.test_torch_coaches import _clip, _port_params, tiny  # noqa: F401
from tests.test_torch_criterion import nhwc, two_threads  # noqa: F401

TINY = dict(out_size=64, remaining_layer_idx=7, channel_multiplier=1, encoder_input_size=64,
            encoder_num_units=(1, 1, 2, 1))


# ------------------------------------------------------------ coaches


def test_trainable_mask_matches_jax():
    """Identical to JAX's set at the tiny configuration and at 1024^2
    (remaining_layer_idx 13: 4 convs and 3 ToRGBs frozen), with train_G
    on and off, mapped through `convert_rgi`'s names."""
    for out_size, remaining, train_g in ((64, 7, True), (1024, 13, True), (1024, 13, False)):
        jn = JRGINet(out_size=out_size, remaining_layer_idx=remaining, channel_multiplier=1,
                     encoder_num_units=(1, 1, 1, 1))
        shapes = jax.eval_shape(jn.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                                jnp.zeros((1, 64, 64, 12)))
        jmask = j_g_trainable_mask(shapes["params"], JTrainConfig(
            out_size=out_size, remaining_layer_idx=remaining, train_G=train_g))
        # the JAX mask as a state dict of 0/1 in the port's names
        as_sd = rgi_state_dict_from_jax({
            "params": jax.tree_util.tree_map(lambda m, s: np.full(s.shape, float(m), np.float32),
                                             jmask, shapes["params"]),
            "buffers": {"latent_avg": np.zeros((1, 512), np.float32)}})
        with torch.device("meta"):  # names only
            port = RGINet(num_seg_cls=12, out_size=out_size, remaining_layer_idx=remaining,
                          channel_multiplier=1, encoder_num_units=(1, 1, 1, 1))
        names = [n for n, _ in port.named_parameters()]
        mask = _g_trainable_mask(names, TrainConfig(out_size=out_size,
                                                    remaining_layer_idx=remaining,
                                                    train_G=train_g))
        want = {n: bool(as_sd[n].all()) for n in names}
        assert all(bool(as_sd[n].all()) == bool(as_sd[n].any()) for n in names)
        assert mask == want
        if out_size == 1024 and train_g:
            frozen = {n.split(".")[2] for n in names if not mask[n] and n.startswith("G.convs")}
            assert frozen == {"12", "13", "14", "15"}
            assert {n.split(".")[2] for n in names if not mask[n]
                    and n.startswith("G.to_rgbs")} == {"5", "6", "7"}
            assert all(mask[n] for n in names if n.startswith("MLPs."))


def test_pti_first_step_gradient_matches_jax(tiny):
    """The PTI loss's gradient (L2 + recolor, 2 frames, the port's synthesis
    under remat) before the first update, against jax.grad of JAX's
    `PTICoach._chunk_loss`: every trained tensor within 1e-4 of its largest
    element (float32 summation order through the synthesis)."""
    jnet, variables, net = tiny
    frames, labels, sv, recolor = _clip(10, 2)
    kw = dict(lpips_lambda=0.0, id_lambda=0.0, face_parsing_lambda=0.0)
    coach = pti.PTICoach(net, {}, pti.PTIConfig(**kw))
    jcoach = jpti.PTICoach(jnet, {}, jpti.PTIConfig(scan_steps=1, remat=False, **kw))
    work, _ = coach._working_copy(None)
    coach._chunk_loss(work, *map(torch.from_numpy, (frames, labels, sv, recolor)))[0].backward()
    jgrads = _port_params(jax.jit(jax.grad(lambda p: jcoach._chunk_loss(
        p, variables["buffers"], *map(jnp.asarray, (frames, labels, sv, recolor)))[0]))(
        variables["params"]), variables)
    trained = [(n, p) for n, p in work.named_parameters() if p.grad is not None]
    assert trained
    for name, p in trained:
        w = jgrads[name]
        torch.testing.assert_close(p.grad, w, rtol=1e-3, atol=1e-4 * float(w.abs().max()),
                                   msg=name)


def test_coach_helpers_match_jax():
    rng = np.random.default_rng(13)
    lbl = rng.integers(0, 12, (2, 32, 32))
    lbl[:, 8:24, 8:24] = 6
    np.testing.assert_array_equal(
        pti.eroded_label_map(torch.from_numpy(lbl), radius=2).numpy(),
        np.asarray(jpti.eroded_label_map(jnp.asarray(lbl), radius=2)))
    np.testing.assert_allclose(
        nhwc(pti.foreground_mask_from_label(torch.from_numpy(lbl), 64)),
        np.asarray(jpti.foreground_mask_from_label(jnp.asarray(lbl), 64)), atol=1e-6)
    u8 = (rng.random((1, 4, 4, 3)) * 255).astype(np.uint8)
    np.testing.assert_allclose(pti.to_pm1_f32(torch.from_numpy(u8)).numpy(),
                               np.asarray(jpti.to_pm1_f32(jnp.asarray(u8))), atol=1e-7)


def test_coach_refuses_what_is_not_ported():
    net = RGINet(num_seg_cls=12, **TINY)
    with pytest.raises(ValueError, match="float32"):
        pti.PTICoach(net, {}, pti.PTIConfig(compute_dtype="bfloat16"))
