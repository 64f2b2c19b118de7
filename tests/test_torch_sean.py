"""The SEAN-style encoder, the RGI net's other `fsencoder_type`, against the
JAX package's on the CPU: the encoder alone from a reference-style state
dict through `convert_encoder_sean`, and a tiny RGI net (32^2, one IR-SE
unit a group unused) whose state dict's `encoder.model.1.weight` makes both
packages' loading switch to it (`convert_rgi`, `rgi.fsencoder_type_of`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from e4s2024_tpu.convert.torch_loader import convert_encoder_sean, convert_rgi
from e4s2024_tpu.models.encoders import FSEncoderSEAN as JFSEncoderSEAN
from e4s2024_tpu.models.rgi import RGINet as JRGINet

from e4s2024_torch.convert import rgi_state_dict_from_jax
from e4s2024_torch.models.encoders import FSEncoderSEAN
from e4s2024_torch.models.rgi import RGINet, fsencoder_type_of
from tests.test_torch_criterion import two_threads  # noqa: F401  (autouse fixture)
from tests.test_torch_gpen import nchw, nhwc, np_sd, reference_state_dict

TINY = dict(out_size=32, remaining_layer_idx=5, channel_multiplier=1, encoder_input_size=64)


def _inputs(seed, size=64, b=2):
    rng = np.random.default_rng(seed)
    img = np.tanh(rng.standard_normal((b, size, size, 3))).astype(np.float32)
    seg = np.eye(12, dtype=np.float32)[rng.integers(0, 12, (b, 32, 32))]
    return img, seg


def test_sean_encoder_matches_jax():
    """Style vectors (B, 12, 512) and structure features within 1e-5 of the
    largest value (float32 summation order)."""
    enc = FSEncoderSEAN().eval()
    sd = reference_state_dict(enc, 0)
    enc.load_state_dict(sd, strict=True)
    img, seg = _inputs(1)
    sv, st = JFSEncoderSEAN().apply({"params": convert_encoder_sean(np_sd(sd))}, img, seg)
    with torch.no_grad():
        got_sv, got_st = enc(nchw(img), nchw(seg))
    assert got_sv.shape == (2, 12, 512) and got_st.shape == (2, 512, 4, 4)
    np.testing.assert_allclose(got_sv.numpy(), np.asarray(sv), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(sv)).max())
    np.testing.assert_allclose(nhwc(got_st), np.asarray(st), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(st)).max())


def test_rgi_with_sean_switches_and_matches_jax():
    """A reference-style SEAN RGI state dict: `fsencoder_type_of` picks SEAN,
    as `convert_rgi` does; the port's image within 1e-4 of JAX's largest
    value, and the JAX params carried back give the same state dict."""
    net = RGINet(fsencoder_type="sean", **TINY)
    sd = reference_state_dict(net, 2)
    sd["latent_avg"] = torch.from_numpy(
        (0.5 * np.random.default_rng(3).standard_normal((8, 512))).astype(np.float32))
    assert fsencoder_type_of(sd) == "sean" and fsencoder_type_of(RGINet(**TINY).state_dict()) == "psp"
    net = RGINet(fsencoder_type=fsencoder_type_of(sd), **TINY).eval()
    net.load_state_dict(sd, strict=True)
    variables = convert_rgi(np_sd(sd))
    img, seg = _inputs(4)
    want, _ = JRGINet(fsencoder_type="sean", **TINY).apply(variables, jnp.asarray(img),
                                                            jnp.asarray(seg),
                                                            regional_mode="fast")
    with torch.no_grad():
        got, _ = net(nchw(img), nchw(seg), regional_mode="fast")
    want = np.asarray(want)
    np.testing.assert_allclose(nhwc(got), want, rtol=0, atol=1e-4 * np.abs(want).max())
    back = rgi_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, variables))
    assert set(back) == set(sd)
    for k, v in sd.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0, msg=k)
