"""The port's MISF inpainting (models/misf.py) and the inpainting registry
(pipelines/inpaint_registry.py) against the JAX package's, on the CPU.

MISF at its published widths on a 32^2 input with two residual blocks and
64 kernel sets (tests/test_misf.py's small configuration), weights seeded
with numpy in the reference's names and carried to JAX by `convert_misf`.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from e4s2024_tpu.convert.torch_loader import convert_misf
from e4s2024_tpu.models import misf as jmisf

from e4s2024_torch.convert import misf_state_dict_from_jax
from e4s2024_torch.models import misf
from e4s2024_torch.pipelines.inpaint_registry import make_inpainter
from tests.test_torch_criterion import two_threads  # noqa: F401  (autouse fixture)
from tests.test_torch_gpen import assert_close_scaled, nchw, nhwc, np_sd, reference_state_dict

MISF = dict(residual_blocks=2, num_kernels=64)


def test_per_pixel_filter_matches_jax():
    rng = np.random.default_rng(70)
    x = rng.standard_normal((2, 5, 6, 3)).astype(np.float32)
    k = rng.standard_normal((2, 5, 6, 3, 9)).astype(np.float32)
    want = np.asarray(jmisf.per_pixel_filter(jnp.asarray(x), jnp.asarray(k)))
    got = misf.per_pixel_filter(nchw(x), torch.from_numpy(k.transpose(0, 3, 4, 1, 2)))
    np.testing.assert_allclose(nhwc(got), want, rtol=1e-6, atol=1e-6)


def test_misf_matches_jax():
    ref = reference_state_dict(misf.MISFGenerator(**MISF), 71)
    # the reference file's envelope and its unused KPN head
    file_sd = {"generator": dict(ref, **{"kpn_model.conv_final.weight": torch.zeros(3, 3, 1, 1)})}
    params = convert_misf({f"generator.{k}": v for k, v in np_sd(file_sd["generator"]).items()})
    rng = np.random.default_rng(72)
    img = rng.random((2, 32, 32, 3)).astype(np.float32)
    mask = np.zeros((2, 32, 32, 1), np.float32)
    mask[:, 8:20, 10:26] = 1.0
    jinp = jmisf.MISFInpainter(params, num_kernels=64)
    jinp.model = jmisf.MISFGenerator(**MISF)  # its constructor takes no block count
    want = np.asarray(jinp(jnp.asarray(img), jnp.asarray(mask)))
    inp = make_inpainter("misf", file_sd, num_kernels=64, residual_blocks=2, device="cpu")
    got = inp(img, mask).numpy()
    # float32 through the encoder, the KPN, two dilated blocks and the
    # transposed-convolution decoder, in [0, 1]
    assert_close_scaled(got, want, 1e-5)
    np.testing.assert_array_equal(got[mask[..., 0] == 0], img[mask[..., 0] == 0])
    back = misf_state_dict_from_jax(params)
    assert set(back) == set(ref) and all(torch.equal(back[k], ref[k]) for k in ref)


def test_registry():
    with pytest.raises(KeyError, match="unknown inpainting backend"):
        make_inpainter("nope")
    with pytest.raises(ValueError, match="MISF needs"):
        make_inpainter("misf")
