"""The port's reconstruction CLI (e4s2024_torch.app `recon_cli`) against the
JAX package's, on the CPU, with tests/test_torch_app.py's swappers: the
metrics, and the grids the port writes with its own PNG writer as PIL
decodes them.
"""

import numpy as np
import pytest
from PIL import Image

from e4s2024_tpu import app as japp

from e4s2024_torch import app
from tests.test_torch_app import _image, swappers  # noqa: F401
from tests.test_torch_criterion import two_threads  # noqa: F401


def test_recon_cli_matches_jax(swappers, tmp_path):  # noqa: F811
    """Two synthetic items through both CLIs: SSIM, PSNR and RMSE within
    1e-3 relative of JAX's, each grid PNG as PIL decodes it equal to the
    port's grid and within 2 levels of JAX's."""
    sw, jsw = swappers
    rng = np.random.default_rng(2)
    items = []
    for i in range(2):
        img = (_image(10 + i) / 127.5 - 1.0).astype(np.float32)
        base = rng.integers(0, 12, (8, 8))
        items.append((img, np.repeat(np.repeat(base, 8, 0), 8, 1).astype(np.int32)))
    got = app.recon_cli(sw, items, str(tmp_path / "port"), limit=5)
    want = japp.recon_cli(jsw, items, str(tmp_path / "jax"), limit=5)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-3), k
    assert (tmp_path / "port" / "metrics.txt").read_text() == str(got)
    for i in range(2):
        name = f"{i:05d}_recon.png"
        port_png = np.asarray(Image.open(tmp_path / "port" / name))
        jax_png = np.asarray(Image.open(tmp_path / "jax" / name))
        assert port_png.shape == (64, 128, 3)
        np.testing.assert_array_equal(port_png[:, :64], ((items[i][0] + 1) * 127.5).clip(
            0, 255).astype(np.uint8))
        assert np.abs(port_png.astype(int) - jax_png.astype(int)).max() <= 2
