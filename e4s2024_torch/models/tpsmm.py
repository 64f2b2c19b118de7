"""Thin-Plate-Spline Motion Model (TPSMM) reenactment.

Counterpart of `e4s2024_tpu/models/tpsmm.py` in NCHW, with the reference's
state-dict names (swap_face_fine/TPSMM/: modules/keypoint_detector.py:5
`fg_encoder.*`, a resnet18 giving K*5 keypoints; modules/dense_motion.py:8,
K thin-plate-spline warps to an optical flow and multi-resolution occlusion;
modules/inpainting_network.py:8, the flow-warped encoder-decoder), driven as
demo.py:124 `drive_source_demo` in standard mode: one driving frame
reenacts the source crop. The reference's checkpoint is an internal cluster
path (demo.py:145), so weights are the caller's.

The K+1 warps of the source run as one `grid_sample` with the transform
axis folded into the batch; blocks use nn.InstanceNorm2d(affine=True).
"""

from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from e4s2024_torch import resolve_device
from e4s2024_torch.convert import as_tensors, strip_module_prefix
from e4s2024_torch.models.arcface import FrozenBatchNorm
from e4s2024_torch.models.bisenet import BasicBlock
from e4s2024_torch.models.facevid2vid import AntiAliasDownsample, _axis
from e4s2024_torch.ops.pool import max_pool2d
from e4s2024_torch.ops.resize import resize_bilinear, resize_nearest

# ------------------------------------------------------------------ geometry


def make_grid_2d(h: int, w: int, device=None) -> torch.Tensor:
    """(H, W, 2) (x, y) grid in [-1, 1] (reference util.py:118, align-corners
    spacing)."""
    yy, xx = torch.meshgrid(_axis(h, device), _axis(w, device), indexing="ij")
    return torch.stack([xx, yy], dim=-1)


def kp2gaussian2d(kp: torch.Tensor, size: tuple[int, int], var: float = 0.01) -> torch.Tensor:
    """(B, N, 2) xy keypoints -> (B, N, H, W) gaussians (reference util.py:95)."""
    grid = make_grid_2d(*size, device=kp.device)[None, None]
    mean = kp[:, :, None, None, :]
    return torch.exp(-0.5 * torch.sum((grid - mean) ** 2, -1) / var)


def grid_sample_2d(img: torch.Tensor, grid: torch.Tensor,
                   align_corners: bool = True) -> torch.Tensor:
    """Bilinear F.grid_sample with zero padding. img: (B, C, H, W); grid:
    (B, Hg, Wg, 2) xy in [-1, 1]."""
    return F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=align_corners)


def tps_warp_grid(kp_driving: torch.Tensor, kp_source: torch.Tensor, h: int,
                  w: int) -> torch.Tensor:
    """K thin-plate-spline warps (reference util.py:6 TPS, mode 'kp'):
    (B, K, 5, 2) control points, driving -> source. Returns (B, K, H, W, 2)
    sampling grids. The 8x8 systems carry a 0.01 I ridge; the radial basis is
    d^2 log(d^2 + 1e-9)."""
    b, k, n, _ = kp_driving.shape
    kp1 = kp_driving
    d2 = torch.sum((kp1[:, :, :, None] - kp1[:, :, None, :]) ** 2, -1)
    radial = d2 * torch.log(d2 + 1e-9)                        # (B, K, 5, 5)
    kp1p = torch.cat([kp1, kp1.new_ones(b, k, n, 1)], 3)      # (B, K, 5, 3)
    p_blk = torch.cat([kp1p, kp1.new_zeros(b, k, 3, 3)], 2)  # (B, K, 8, 3)
    l_blk = torch.cat([radial, kp1p.transpose(2, 3)], 2)     # (B, K, 8, 5)
    lmat = torch.cat([l_blk, p_blk], 3) + 0.01 * torch.eye(n + 3, device=kp1.device)
    y = torch.cat([kp_source, kp1.new_zeros(b, k, 3, 2)], 2)
    param = torch.linalg.solve(lmat, y)                       # (B, K, 8, 2)
    theta = param[:, :, n:, :].transpose(2, 3)                # (B, K, 2, 3)
    ctrl = param[:, :, :n, :]                                 # (B, K, 5, 2)

    coords = make_grid_2d(h, w, device=kp1.device).reshape(-1, 2)
    affine = torch.einsum("bkij,nj->bkni", theta[:, :, :, :2], coords) \
        + theta[:, :, None, :, 2]
    dist = torch.sum((coords[None, None, :, None, :] - kp1[:, :, None, :, :]) ** 2, -1)
    warped = affine + torch.einsum("bknc,bkcd->bknd", dist * torch.log(dist + 1e-9), ctrl)
    return warped.reshape(b, k, h, w, 2)


# ------------------------------------------------------------------ blocks


class TPSSameBlock(nn.Module):
    """SameBlock2d (reference util.py:202): conv, IN, relu."""

    def __init__(self, cin: int, cout: int, kernel: int = 3):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, padding=kernel // 2)
        self.norm = nn.InstanceNorm2d(cout, affine=True)

    def forward(self, x):
        return torch.relu(self.norm(self.conv(x)))


class TPSDownBlock(TPSSameBlock):
    """DownBlock2d (util.py:182): conv, IN, relu, 2x average pool."""

    def forward(self, x):
        return F.avg_pool2d(super().forward(x), 2)


class TPSUpBlock(TPSSameBlock):
    """UpBlock2d (util.py:162): 2x nearest, conv, IN, relu."""

    def forward(self, x):
        return super().forward(resize_nearest(x, (2 * x.shape[-2], 2 * x.shape[-1])))


class TPSResBlock(nn.Module):
    """ResBlock2d (util.py:137): IN, relu, conv, twice; residual."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1 = nn.Conv2d(c, c, 3, padding=1)
        self.conv2 = nn.Conv2d(c, c, 3, padding=1)
        self.norm1 = nn.InstanceNorm2d(c, affine=True)
        self.norm2 = nn.InstanceNorm2d(c, affine=True)

    def forward(self, x):
        r = self.conv1(torch.relu(self.norm1(x)))
        return x + self.conv2(torch.relu(self.norm2(r)))


class _TPSEncoder(nn.Module):
    def __init__(self, be, cin, num_blocks, mf):
        super().__init__()
        self.down_blocks = nn.ModuleList(
            TPSDownBlock(cin if i == 0 else min(mf, be * 2 ** i), min(mf, be * 2 ** (i + 1)))
            for i in range(num_blocks))


class _TPSDecoder(nn.Module):
    def __init__(self, be, cin, num_blocks, mf):
        super().__init__()
        self.up_blocks = nn.ModuleList(
            TPSUpBlock((1 if i == num_blocks - 1 else 2) * min(mf, be * 2 ** (i + 1)),
                       min(mf, be * 2 ** i))
            for i in reversed(range(num_blocks)))
        self.out_channels = [min(mf, be * 2 ** i) + (cin if i == 0 else min(mf, be * 2 ** i))
                             for i in reversed(range(num_blocks))]


class TPSHourglass(nn.Module):
    """Hourglass (util.py:278); forward returns the decoder's outputs, the
    last at full resolution."""

    def __init__(self, block_expansion: int, in_features: int, num_blocks: int = 5,
                 max_features: int = 1024):
        super().__init__()
        self.encoder = _TPSEncoder(block_expansion, in_features, num_blocks, max_features)
        self.decoder = _TPSDecoder(block_expansion, in_features, num_blocks, max_features)
        self.out_channels = self.decoder.out_channels

    def forward(self, x):
        enc = [x]
        for down in self.encoder.down_blocks:
            enc.append(down(enc[-1]))
        out, outs = enc.pop(), []
        for up in self.decoder.up_blocks:
            out = torch.cat([up(out), enc.pop()], dim=1)
            outs.append(out)
        return outs


# ------------------------------------------------------------------ nets


class _ResNet18(nn.Module):
    """torchvision resnet18 with its `fc` replaced (reference
    keypoint_detector.py:14)."""

    def __init__(self, num_outputs: int):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        cin = 64
        for li, c in enumerate((64, 128, 256, 512)):
            stride = 2 if li > 0 else 1
            self.add_module(f"layer{li + 1}", nn.Sequential(BasicBlock(cin, c, stride),
                                                            BasicBlock(c, c, 1)))
            cin = c
        self.fc = nn.Linear(512, num_outputs)

    def forward(self, x):
        x = max_pool2d(torch.relu(self.bn1(self.conv1(x))), 3, 2, padding=1)
        for li in range(1, 5):
            x = getattr(self, f"layer{li}")(x)
        return self.fc(x.mean(dim=(2, 3)))


class TPSKPDetector(nn.Module):
    """K*5 keypoints in [-1, 1] (sigmoid output, reference keypoint_detector.py:5)."""

    def __init__(self, num_tps: int = 10):
        super().__init__()
        self.fg_encoder = _ResNet18(num_tps * 5 * 2)
        self.num_tps = num_tps

    def forward(self, img01):
        kp = torch.sigmoid(self.fg_encoder(img01)) * 2.0 - 1.0
        return kp.reshape(img01.shape[0], self.num_tps * 5, 2)


class TPSDenseMotion(nn.Module):
    """Optical flow and multi-resolution occlusion from K TPS warps
    (reference dense_motion.py:8; vox: block_expansion 64, 5 blocks,
    max_features 1024, scale 0.25, multi_mask)."""

    def __init__(self, num_tps: int = 10, block_expansion: int = 64, num_blocks: int = 5,
                 max_features: int = 1024, scale_factor: float = 0.25,
                 kp_variance: float = 0.01, num_channels: int = 3):
        super().__init__()
        self.hourglass = TPSHourglass(block_expansion,
                                      num_channels * (num_tps + 1) + num_tps * 5 + 1,
                                      num_blocks, max_features)
        chans = self.hourglass.out_channels
        self.maps = nn.Conv2d(chans[-1], num_tps + 1, 7, padding=3)
        self.up_nums = int(round(math.log2(1 / scale_factor)))
        self.occlusion_num = 4
        self.up = nn.ModuleList(TPSUpBlock(chans[-1] // 2 ** i, chans[-1] // 2 ** (i + 1))
                                for i in range(self.up_nums))
        occ_in = [chans[self.up_nums - self.occlusion_num + i]
                  for i in range(self.occlusion_num - self.up_nums)]
        occ_in += [chans[-1] // 2 ** (i + 1) for i in range(self.up_nums)]
        self.occlusion = nn.ModuleList(nn.Conv2d(c, 1, 7, padding=3) for c in occ_in)
        self.down = AntiAliasDownsample(num_channels, scale_factor) if scale_factor != 1 else None
        self.num_tps, self.kp_variance = num_tps, kp_variance

    def forward(self, source01, kp_driving, kp_source) -> dict:
        k = self.num_tps
        if self.down is not None:
            source01 = self.down(source01)
        b, c, h, w = source01.shape
        hm = kp2gaussian2d(kp_driving, (h, w), self.kp_variance) \
            - kp2gaussian2d(kp_source, (h, w), self.kp_variance)
        hm = torch.cat([hm.new_zeros(b, 1, h, w), hm], dim=1)

        grids = tps_warp_grid(kp_driving.reshape(b, k, 5, 2), kp_source.reshape(b, k, 5, 2), h, w)
        ident = make_grid_2d(h, w, device=source01.device)[None, None].expand(b, 1, h, w, 2)
        transforms = torch.cat([ident, grids], 1)                 # (B, K+1, H, W, 2)
        src_rep = source01[:, None].expand(b, k + 1, c, h, w).reshape(-1, c, h, w)
        deformed = grid_sample_2d(src_rep, transforms.reshape(-1, h, w, 2))
        deformed = deformed.view(b, k + 1, c, h, w)

        preds = self.hourglass(torch.cat([hm, deformed.reshape(b, -1, h, w)], dim=1))
        contribution = torch.softmax(self.maps(preds[-1]), dim=1)  # (B, K+1, H, W)
        deformation = torch.einsum("bkhwd,bkhw->bhwd", transforms, contribution)

        occ = [torch.sigmoid(self.occlusion[i](preds[self.up_nums - self.occlusion_num + i]))
               for i in range(self.occlusion_num - self.up_nums)]
        out = preds[-1]
        for i, up in enumerate(self.up):
            out = up(out)
            occ.append(torch.sigmoid(
                self.occlusion[i + self.occlusion_num - self.up_nums](out)))
        return {"deformation": deformation, "occlusion_map": occ,
                "contribution_maps": contribution, "deformed_source": deformed}


class TPSInpainting(nn.Module):
    """Flow-warped encoder-decoder (reference inpainting_network.py:8; vox:
    block_expansion 64, max_features 512, 3 down blocks). As in the
    reference, `up_blocks` and `resblock` are registered in the order they
    run."""

    def __init__(self, block_expansion: int = 64, num_down_blocks: int = 3,
                 max_features: int = 512, num_channels: int = 3):
        super().__init__()
        be, mf, nd = block_expansion, max_features, num_down_blocks
        self.first = TPSSameBlock(num_channels, be, 7)
        downs = [min(mf, be * 2 ** (i + 1)) for i in range(nd)]
        self.down_blocks = nn.ModuleList(TPSDownBlock(([be] + downs)[i], downs[i])
                                         for i in range(nd))
        ins = [downs[-1]] + [2 * d for d in reversed(downs[:-1])]
        outs = [min(mf, be * 2 ** (nd - i - 1)) for i in range(nd)]
        self.up_blocks = nn.ModuleList(TPSUpBlock(ins[i], outs[i]) for i in range(nd))
        self.resblock = nn.ModuleList(TPSResBlock(ins[i // 2]) for i in range(2 * nd))
        self.final = nn.Conv2d(be, num_channels, 7, padding=3)

    @staticmethod
    def _deform(feat, deformation):
        h, w = feat.shape[-2:]
        if tuple(deformation.shape[1:3]) != (h, w):
            deformation = resize_bilinear(deformation.permute(0, 3, 1, 2), (h, w),
                                          align_corners=True).permute(0, 2, 3, 1)
        return grid_sample_2d(feat, deformation)

    def forward(self, source01, dense_motion: dict):
        deformation, occ = dense_motion["deformation"], dense_motion["occlusion_map"]
        out = self.first(source01)
        encoder_map = [out]
        for down in self.down_blocks:
            out = down(out)
            encoder_map.append(out)
        out = self._deform(out, deformation) * occ[0]
        nd = len(self.down_blocks)
        for i in range(nd):
            out = self.resblock[2 * i + 1](self.resblock[2 * i](out))
            out = self.up_blocks[i](out)
            encode_i = self._deform(encoder_map[-(i + 2)], deformation) * occ[i + 1]
            if i == nd - 1:
                break
            out = torch.cat([out, encode_i], dim=1)
        deformed_source = self._deform(source01, deformation)
        occ_last = occ[-1]
        out = torch.sigmoid(self.final(out * (1 - occ_last) + encode_i))
        return out * (1 - occ_last) + deformed_source * occ_last


def tpsmm_state_dicts(ckpt: Mapping, scale_factor: float = 0.25) -> dict[str, dict]:
    """A TPSMM checkpoint (nested {'kp_detector', 'dense_motion_network',
    'inpainting_network', ...} or flattened; reference file or
    `convert.tpsmm_state_dicts_from_jax`) as the three nets' state dicts:
    `module.` stripped, BatchNorm counters dropped, the dense motion's
    anti-alias `down.weight` checked against the port's constant and
    dropped. The 'avd' mode's network is not read."""
    from e4s2024_torch.convert import drop_antialias_buffers, nest_flat_checkpoint

    ckpt = nest_flat_checkpoint(ckpt)
    out = {}
    for net in ("kp_detector", "dense_motion_network", "inpainting_network"):
        sd = {k: v for k, v in strip_module_prefix(ckpt[net]).items()
              if not k.endswith("num_batches_tracked")}
        if net == "dense_motion_network":
            sd = drop_antialias_buffers(sd, {"down.weight": scale_factor})
        out[net] = as_tensors(sd)
    return out


class TPSMMDriver:
    """drive_source_demo in standard mode (reference demo.py:124). `dm` and
    `inp` override the nets' widths (tests)."""

    def __init__(self, ckpt: Mapping, num_tps: int = 10, *, dm: dict | None = None,
                 inp: dict | None = None, device=None):
        self.device = resolve_device(device)
        self.kp = TPSKPDetector(num_tps)
        self.dm = TPSDenseMotion(num_tps, **(dm or {}))
        self.inp = TPSInpainting(**(inp or {}))
        scale = (dm or {}).get("scale_factor", 0.25)
        sds = tpsmm_state_dicts(ckpt, scale)
        for net, name in ((self.kp, "kp_detector"), (self.dm, "dense_motion_network"),
                          (self.inp, "inpainting_network")):
            net.load_state_dict(sds[name], strict=True)
            net.eval().requires_grad_(False).to(self.device)

    @torch.inference_mode()
    def __call__(self, source01, driving01) -> torch.Tensor:
        """(B, 256, 256, 3) in [0, 1] each -> the reenacted source, (B, 256,
        256, 3) in [0, 1]."""
        src = torch.as_tensor(source01, device=self.device).float().permute(0, 3, 1, 2)
        drv = torch.as_tensor(driving01, device=self.device).float().permute(0, 3, 1, 2)
        dense = self.dm(src, self.kp(drv), self.kp(src))
        return self.inp(src, dense).permute(0, 2, 3, 1)
