"""Reference E4S checkpoints through the port's loaders: a Net3 state dict
carries fixed generator buffers (the registered noise maps and the FIR
kernel of every blur and upsample) that the port keeps as constants;
`FaceSwapper` and `swap_cli.load_params` drop them, check the FIR taps
against the port's constant, and load every other key strictly.
"""

import numpy as np
import pytest
import torch

from e4s2024_torch import swap_cli
from e4s2024_torch.convert import drop_generator_buffers
from e4s2024_torch.models.bisenet import BiSeNet
from e4s2024_torch.models.rgi import RGINet
from e4s2024_torch.ops.upfirdn import make_kernel
from e4s2024_torch.pipelines.swap import FaceSwapper, SwapConfig
from tests.test_torch_criterion import two_threads  # noqa: F401

SIZE, REMAINING, UNITS = 64, 7, (1, 1, 1, 1)


@pytest.fixture(scope="module")
def state_dicts():
    torch.manual_seed(0)
    rgi = RGINet(out_size=SIZE, remaining_layer_idx=REMAINING, encoder_num_units=UNITS)
    rgi.latent_avg.normal_()
    return rgi.state_dict(), BiSeNet().state_dict()


def reference_style(sd: dict) -> dict:
    """The state dict as the reference's Net3 saves it: plus
    `G.noises.noise_{i}` (1, 1, res, res) and the x4-gain FIR kernels of the
    up-convolutions' blurs and the ToRGBs' upsamples."""
    out = dict(sd)
    fir = make_kernel([1, 3, 3, 1]) * 4
    log_size = int(np.log2(SIZE))
    for i in range((log_size - 2) * 2 + 1):
        res = 2 ** ((i + 5) // 2)
        out[f"G.noises.noise_{i}"] = torch.randn(1, 1, res, res)
    for j in range(log_size - 2):
        out[f"G.convs.{2 * j}.conv.blur.kernel"] = fir.clone()
        out[f"G.to_rgbs.{j}.upsample.kernel"] = fir.clone()
    return out


def _swapper(rgi_sd, bise_sd):
    return FaceSwapper(rgi_sd, bise_sd, SwapConfig(out_size=SIZE, remaining_layer_idx=REMAINING),
                       device="cpu", encoder_num_units=UNITS)


def test_reference_state_dict_loads_through_faceswapper(state_dicts):
    rgi_sd, bise_sd = state_dicts
    ref = reference_style(rgi_sd)
    assert len(ref) - len(rgi_sd) == 9 + 2 * 4  # 9 noise maps at 64^2, 4 blurs, 4 upsamples
    swapper = _swapper(ref, bise_sd)
    for k, v in swapper.rgi.state_dict().items():
        assert torch.equal(v, rgi_sd[k]), k


def test_reference_checkpoint_loads_through_swap_cli(state_dicts, tmp_path):
    """A checkpoint file in the reference's envelope ({"state_dict",
    "latent_avg"}) through `load_params`, then the swapper."""
    rgi_sd, bise_sd = state_dicts
    ref = reference_style(rgi_sd)
    latent_avg = ref.pop("latent_avg")
    path = tmp_path / "iteration_300000.pt"
    torch.save({"state_dict": ref, "latent_avg": latent_avg, "opts": {"out_size": SIZE}}, path)
    loaded = swap_cli.load_params(str(path))
    assert set(loaded) == set(rgi_sd)
    swapper = _swapper(loaded, bise_sd)
    assert torch.equal(swapper.rgi.latent_avg, rgi_sd["latent_avg"])
    assert torch.equal(swapper.rgi.G.conv1.conv.weight, rgi_sd["G.conv1.conv.weight"])


def test_differing_fir_taps_raise(state_dicts):
    rgi_sd, bise_sd = state_dicts
    for key in ("G.convs.2.conv.blur.kernel", "G.to_rgbs.0.upsample.kernel"):
        ref = reference_style(rgi_sd)
        ref[key] = ref[key].clone()
        ref[key][1, 2] += 1e-3
        with pytest.raises(ValueError, match="FIR taps"):
            _swapper(ref, bise_sd)
    ref = reference_style(rgi_sd)
    ref["G.to_rgbs.1.upsample.kernel"] = make_kernel([1, 3, 3, 1])  # gain 1, not 4
    with pytest.raises(ValueError, match="FIR taps"):
        drop_generator_buffers(ref)


def test_unknown_and_missing_weights_still_raise(state_dicts):
    rgi_sd, bise_sd = state_dicts
    ref = reference_style(rgi_sd)
    ref["G.convs.0.conv.extra"] = torch.zeros(3)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        _swapper(ref, bise_sd)
    ref = reference_style(rgi_sd)
    del ref["G.conv1.activate.bias"]
    with pytest.raises(RuntimeError, match="Missing key"):
        _swapper(ref, bise_sd)
