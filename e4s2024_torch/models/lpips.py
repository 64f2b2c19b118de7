"""LPIPS v0.1 perceptual distance with AlexNet features, frozen (reference
criteria/lpips/lpips.py:8, networks.py:77).

Counterpart of `e4s2024_tpu/models/lpips.py` in NCHW. torchvision's
`alexnet.features` tapped after each ReLU, the taps unit-normalised over
channels, squared differences weighted by the 1x1 "lin" heads, averaged
over space and summed. State-dict names: `features.{0,3,6,8,10}.*` and
`lin{i}.model.1.weight`, the ones `convert_lpips` reads. Input in [-1, 1].

Under a height split (`parallel.spatial`) the inputs are slabs of rows
and each rank holds only its rows of every feature: the 11x11 stride-4
convolution, the 3x3 stride-2 max pools and the 5x5 and 3x3 convolutions
fetch the rows their windows read, and the output rows of a strided
layer belong to the rank that holds the input row they start from, so
the feature slabs are uneven (256 rows give 63 after the first
convolution, 32 and 31 over two ranks); the spatial means are sums over
the split, and the distance comes out the same on every rank.
"""

from __future__ import annotations

import torch
from torch import nn

from e4s2024_torch.parallel import spatial

# LPIPS input standardisation (reference networks.py:41-44)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
CHANNELS = (64, 192, 384, 256, 256)
TAPS = (1, 4, 7, 9, 11)  # indices of the ReLUs in `features`


def unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Unit length over the channel axis (reference lpips/utils.py:6)."""
    norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True) + 1e-16)
    return x / (norm + eps)


class LinLayer(nn.Module):
    """The LPIPS 1x1 head (`model.1` is the conv; Dropout is the identity
    at inference)."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), nn.Conv2d(channels, 1, 1, bias=False))

    def forward(self, x):
        return self.model(x)


class LPIPS(nn.Module):
    """LPIPS(x, y): mean over the batch of the summed lin-weighted spatial
    means of squared feature differences (the JAX package's reduction)."""

    def __init__(self):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2d(3, 64, 11, 4, 2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(64, 192, 5, 1, 2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(192, 384, 3, 1, 1), nn.ReLU(),
            nn.Conv2d(384, 256, 3, 1, 1), nn.ReLU(),
            nn.Conv2d(256, 256, 3, 1, 1), nn.ReLU())
        for i, c in enumerate(CHANNELS):
            setattr(self, f"lin{i}", LinLayer(c))
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1), persistent=False)

    def taps(self, x: torch.Tensor) -> list[torch.Tensor]:
        """Unit-normalised AlexNet features after each ReLU."""
        x = (x - self.shift) / self.scale
        feats = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in TAPS:
                feats.append(unit_normalize(x))
        return feats

    def _taps_split(self, x: torch.Tensor) -> list[tuple[torch.Tensor, int]]:
        """`taps` of a slab of rows: (this rank's rows of each tap, the
        tap's global height)."""
        x = (x - self.shift) / self.scale
        extents = spatial.even_extents(x.shape[-2])
        feats = []
        for i, layer in enumerate(self.features):
            if isinstance(layer, nn.Conv2d):
                x, extents = spatial.conv2d_rows(x, layer.weight, layer.bias, layer.stride,
                                                 layer.padding, extents)
            elif isinstance(layer, nn.MaxPool2d):
                x, extents = spatial.max_pool2d(x, layer.kernel_size, layer.stride, extents)
            else:
                x = layer(x)
            if i in TAPS:
                feats.append((unit_normalize(x), extents[-1][1]))
        return feats

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if spatial.active() is not None:
            sums, counts = [], []
            for i, ((a, rows), (b, _)) in enumerate(zip(self._taps_split(x),
                                                        self._taps_split(y))):
                # the 1x1 head summed over the slab, as a contraction: a
                # rank may hold no row of the coarsest taps
                lin = getattr(self, f"lin{i}").model[1].weight.reshape(-1)
                sums.append(torch.einsum("bchw,c->b", (a - b) ** 2, lin))
                counts.append(rows * a.shape[-1])
            means = spatial.all_reduce(torch.stack(sums)) / torch.tensor(
                counts, dtype=x.dtype, device=x.device)[:, None]
            return means.sum() / x.shape[0]
        total = 0.0
        for i, (a, b) in enumerate(zip(self.taps(x), self.taps(y))):
            total = total + getattr(self, f"lin{i}")((a - b) ** 2).mean(dim=(1, 2, 3))
        return total.sum() / x.shape[0]
