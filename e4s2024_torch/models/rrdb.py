"""RealESRGAN x4 super-resolution, RRDBNet (reference
swap_face_fine/realesr/image_infer.py:39: RRDBNet(3, 3, 64, 23, 32,
scale=4); it brings the 256^2 Blender recolor back to 1024^2,
Face_swap_with_two_imgs.py:533).

Counterpart of `e4s2024_tpu/models/rrdb.py` in NCHW, with basicsr's
state-dict names (`conv_first`, `body.{i}.rdb{1,2,3}.conv{1..5}`,
`conv_body`, `conv_up1`, `conv_up2`, `conv_hr`, `conv_last`). Residual-in-
residual dense blocks with 0.2 residual scaling, then two nearest x2
upsamples each followed by a conv. The JAX package runs no Pallas
kernel here.

`RRDBNet.forward` is the plain path (NCHW, cuDNN float32 and `torch.cat`):
the CPU path and the oracle. `RRDBNet.forward_nhwc`, which the upscaler
calls, runs the net through kernel K7 (`ops/rdb_conv.py`) where the net is
on a card in float32 at the published widths (64 features, growth 32), and
through `forward` everywhere else. There each residual dense block works in
one NHWC buffer of 64 + 4 x 32 channels (`dense_block`): conv i reads the
first channels and writes its 32 beside them, conv5's epilogue adds the
block's 0.2-scaled residual (in a block's third RDB also the RRDB's) and
writes the next buffer's first 64 channels; the tail folds each nearest x2
upsample into its conv. conv_first and conv_last (under 1% of the work) stay
on cuDNN, in channels-last layout.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from e4s2024_torch import kernels, resolve_device
from e4s2024_torch.convert import as_tensors, strip_module_prefix, unwrap_envelope
from e4s2024_torch.ops.rdb_conv import pack_weights, rdb_conv
from e4s2024_torch.ops.resize import resize_nearest

# widths K7 has instances for: conv1-4 write 32 channels, conv5 and the
# tail 64
K7_WIDTHS = (64, 32)


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


class ResidualDenseBlock(nn.Module):
    def __init__(self, num_feat: int = 64, num_grow: int = 32):
        super().__init__()
        for i in range(4):
            setattr(self, f"conv{i + 1}", nn.Conv2d(num_feat + i * num_grow, num_grow, 3, 1, 1))
        self.conv5 = nn.Conv2d(num_feat + 4 * num_grow, num_feat, 3, 1, 1)

    def forward(self, x):
        c = [x]
        for i in range(4):
            c.append(_lrelu(getattr(self, f"conv{i + 1}")(torch.cat(c, 1))))
        return x + 0.2 * self.conv5(torch.cat(c, 1))


class RRDB(nn.Module):
    def __init__(self, num_feat: int = 64, num_grow: int = 32):
        super().__init__()
        self.rdb1 = ResidualDenseBlock(num_feat, num_grow)
        self.rdb2 = ResidualDenseBlock(num_feat, num_grow)
        self.rdb3 = ResidualDenseBlock(num_feat, num_grow)

    def forward(self, x):
        return x + 0.2 * self.rdb3(self.rdb2(self.rdb1(x)))


def _conv(src, m: nn.Conv2d, out, off: int = 0, packs: dict | None = None, **epilogue):
    """One `rdb_conv` of conv m: kernel K7 on a card (`packs` holds its
    packed weights), the plain version on the CPU."""
    return rdb_conv(src, m.weight, m.bias, out, off, packed=None if packs is None else packs[m],
                    **epilogue)


def dense_block(rdb: ResidualDenseBlock, src: torch.Tensor, dst: torch.Tensor,
                packs: dict | None = None, rrdb_res: torch.Tensor | None = None) -> None:
    """`rdb` over the NHWC buffer src (B, H, W, F + 4G), whose channels
    [0, F) hold its input x: conv1-4 write their growth into src's later
    channels, conv5 writes x + 0.2 conv5 (or rrdb_res + 0.2 of that) into
    dst[..., :F]."""
    f, g = rdb.conv5.out_channels, rdb.conv1.out_channels
    for i in range(4):
        _conv(src, getattr(rdb, f"conv{i + 1}"), src, f + i * g, packs, act=True)
    extra = {} if rrdb_res is None else {"res2": rrdb_res, "s2": 0.2}
    _conv(src, rdb.conv5, dst, 0, packs, res1=src, s1=0.2, **extra)


def dense_rrdb(rrdb: RRDB, bufs, packs: dict | None = None) -> None:
    """`rrdb` over bufs[0][..., :F], in place, through three dense buffers:
    rdb1 0 -> 1, rdb2 1 -> 2, rdb3 2 -> 0 with the RRDB's residual read
    from bufs[0] pixel by pixel before it is overwritten."""
    d0, d1, d2 = bufs
    dense_block(rrdb.rdb1, d0, d1, packs)
    dense_block(rrdb.rdb2, d1, d2, packs)
    dense_block(rrdb.rdb3, d2, d0, packs, rrdb_res=d0)


class RRDBNet(nn.Module):
    """x4 SR net: (B, 3, H, W) in [0, 1] -> (B, 3, 4H, 4W), unclipped."""

    def __init__(self, num_feat: int = 64, num_block: int = 23, num_grow: int = 32):
        super().__init__()
        self.conv_first = nn.Conv2d(3, num_feat, 3, 1, 1)
        self.body = nn.Sequential(*[RRDB(num_feat, num_grow) for _ in range(num_block)])
        self.conv_body = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_up1 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_up2 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_hr = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_last = nn.Conv2d(num_feat, 3, 3, 1, 1)

    def forward(self, x):
        feat = self.conv_first(x)
        feat = feat + self.conv_body(self.body(feat))
        h, w = feat.shape[-2:]
        feat = _lrelu(self.conv_up1(resize_nearest(feat, (2 * h, 2 * w))))
        feat = _lrelu(self.conv_up2(resize_nearest(feat, (4 * h, 4 * w))))
        return self.conv_last(_lrelu(self.conv_hr(feat)))

    def uses_k7(self, x: torch.Tensor) -> bool:
        """Whether `forward_nhwc(x)` runs through K7: x on a card (and the
        plain versions not forced there), float32, and the net at the
        widths K7 has instances for."""
        return (not kernels.use_plain(x) and x.dtype == torch.float32
                and (self.conv_first.out_channels, self.body[0].rdb1.conv1.out_channels)
                == K7_WIDTHS)

    def _k7_weights(self) -> dict:
        """Every K7 conv's packed weights (`pack_weights`), made once and
        again only when a weight changes (its device, storage or version)."""
        convs = [m for m in self.modules()
                 if isinstance(m, nn.Conv2d) and m not in (self.conv_first, self.conv_last)]
        key = tuple((m.weight.device, m.weight.data_ptr(), m.weight._version) for m in convs)
        cached = getattr(self, "_k7_cache", None)
        if cached is None or cached[0] != key:
            with torch.no_grad():
                cached = (key, {m: pack_weights(m.weight.detach()) for m in convs})
            self._k7_cache = cached
        return cached[1]

    def forward_nhwc(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, 4H, 4W, 3): through K7 where `uses_k7`, else
        `forward` between two permutes."""
        if not self.uses_k7(x):
            return self.forward(x.permute(0, 3, 1, 2).contiguous()).permute(0, 2, 3, 1)
        return self.dense_forward(x, self._k7_weights())

    def dense_forward(self, x: torch.Tensor, packs: dict | None = None) -> torch.Tensor:
        """The net over NHWC x in dense buffers (`dense_block`), every conv
        but the first and the last an `rdb_conv`."""
        b, h, w, _ = x.shape
        nf = self.conv_first.out_channels
        width = nf + 4 * self.body[0].rdb1.conv1.out_channels
        feat = self.conv_first(x.contiguous().permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        feat = feat.contiguous()
        bufs = [x.new_empty(b, h, w, width) for _ in range(3)]
        bufs[0][..., :nf] = feat
        for rrdb in self.body:
            dense_rrdb(rrdb, bufs, packs)
        body = _conv(bufs[0], self.conv_body, x.new_empty(b, h, w, nf), 0, packs, res1=feat)
        del bufs
        up = _conv(body, self.conv_up1, x.new_empty(b, 2 * h, 2 * w, nf), 0, packs, fold=2,
                   act=True)
        up = _conv(up, self.conv_up2, x.new_empty(b, 4 * h, 4 * w, nf), 0, packs, fold=2,
                   act=True)
        hr = _conv(up, self.conv_hr, torch.empty_like(up), 0, packs, act=True)
        del up
        return self.conv_last(hr.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class RealESRGANUpscaler:
    """x4 upscale of [0, 255] images (the reference's RealESRBatchInfer,
    realesr/image_infer.py:87). A reference file's `params_ema` (or
    `params`) envelope is opened; every other key loads strictly.
    `fused_form`: see `models/gpen.py::GPENEnhancer`."""

    fused_form = True

    def __init__(self, state_dict: Mapping, *, num_feat: int = 64, num_block: int = 23,
                 num_grow: int = 32, device=None):
        self.device = resolve_device(device)
        self.model = RRDBNet(num_feat, num_block, num_grow)
        sd = strip_module_prefix(unwrap_envelope(state_dict, "params_ema", "params"))
        self.model.load_state_dict(as_tensors(sd), strict=True)
        self.model.to(self.device).eval().requires_grad_(False)

    def forward(self, x01: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) in [0, 1] -> (B, 4H, 4W, 3) float32, unclipped."""
        with torch.inference_mode():
            return self.model.forward_nhwc(x01)

    def upscale(self, img255) -> torch.Tensor:
        """(B, H, W, 3) in [0, 255] -> (B, 4H, 4W, 3) float32, clip(out x 255)."""
        x = torch.as_tensor(img255).to(self.device, torch.float32) / 255.0
        return torch.clamp(self.forward(x) * 255.0, 0, 255)
