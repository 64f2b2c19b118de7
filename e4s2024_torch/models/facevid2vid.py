"""faceVid2Vid (One-Shot Free-View Neural Talking Head) reenactment.

Counterpart of `e4s2024_tpu/models/facevid2vid.py` in NCHW / NCDHW, with the
reference's state-dict names (swap_face_fine/face_vid2vid/:
modules/keypoint_detector.py `KPDetector`, `HEEstimator`,
modules/dense_motion.py `DenseMotionNetwork`, modules/generator.py
`OcclusionAwareSPADEGenerator` with its `SPADEDecoder`; drive_demo.py): canonical
3D keypoints and head-pose/expression transforms drive a 3D feature volume
through a dense motion field, decoded by occlusion-aware SPADE blocks.

Defaults are the public vox-256 settings (num_kp 15, feature_channel 32,
estimate_jacobian False, the SPADE generator), the combination the
reference loads (drive_demo.py:21-58 with gen='spade'). BatchNorms run on
their stored statistics. The 2D->3D reshapes are torch's own
`view(b, c // depth, depth, h, w)`, and the 3D->2D flattens the (c, d)-major
`view(b, c * d, h, w)`, so no transposes are needed in this layout.

`FaceVid2VidDriver` takes a reference checkpoint's `generator`,
`kp_detector` and `he_estimator` state dicts (`facevid2vid_state_dicts`:
`module.` stripped, spectral norms folded, the anti-alias kernel checked
against the port's constant and dropped).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from e4s2024_torch import resolve_device
from e4s2024_torch.convert import as_tensors, fold_spectral_norm, strip_module_prefix
from e4s2024_torch.models.arcface import FrozenBatchNorm
from e4s2024_torch.models.hopenet import bins_to_degrees
from e4s2024_torch.ops.pool import max_pool2d
from e4s2024_torch.ops.resize import resize_bilinear, resize_nearest

# ------------------------------------------------------------------ samplers


def _axis(n: int, device=None) -> torch.Tensor:
    return 2 * (torch.arange(n, dtype=torch.float32, device=device) / (n - 1)) - 1


def make_grid_3d(d: int, h: int, w: int, device=None) -> torch.Tensor:
    """(D, H, W, 3) xyz grid in [-1, 1] (reference util.py:55
    make_coordinate_grid, align-corners spacing)."""
    zz, yy, xx = torch.meshgrid(_axis(d, device), _axis(h, device), _axis(w, device),
                                indexing="ij")
    return torch.stack([xx, yy, zz], dim=-1)


def grid_sample_3d(vol: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Trilinear F.grid_sample (align_corners=False, zero padding).
    vol: (B, C, D, H, W); grid: (B, Dg, Hg, Wg, 3) xyz."""
    return F.grid_sample(vol, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=False)


def kp2gaussian3d(kp: torch.Tensor, size: tuple, var: float = 0.01) -> torch.Tensor:
    """(B, K, 3) keypoints -> (B, K, D, H, W) gaussians (reference util.py:13)."""
    grid = make_grid_3d(*size, device=kp.device)[None, None]
    mean = kp[:, :, None, None, None, :]
    return torch.exp(-0.5 * torch.sum((grid - mean) ** 2, -1) / var)


# ------------------------------------------------------------------ blocks


class SameBlock2d(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 3, lrelu: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, padding=kernel // 2)
        self.norm = FrozenBatchNorm(cout)
        self.lrelu = lrelu

    def forward(self, x):
        x = self.norm(self.conv(x))
        return F.leaky_relu(x, 0.01) if self.lrelu else torch.relu(x)


class DownBlock2d(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm = FrozenBatchNorm(cout)

    def forward(self, x):
        return F.avg_pool2d(torch.relu(self.norm(self.conv(x))), 2)


class UpBlock2d(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm = FrozenBatchNorm(cout)

    def forward(self, x):
        x = resize_nearest(x, (2 * x.shape[-2], 2 * x.shape[-1]))
        return torch.relu(self.norm(self.conv(x)))


class DownBlock3d(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv3d(cin, cout, 3, padding=1)
        self.norm = FrozenBatchNorm(cout)

    def forward(self, x):
        return F.avg_pool3d(torch.relu(self.norm(self.conv(x))), (1, 2, 2))


class UpBlock3d(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv3d(cin, cout, 3, padding=1)
        self.norm = FrozenBatchNorm(cout)

    def forward(self, x):
        x = x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)
        return torch.relu(self.norm(self.conv(x)))


class ResBlock3d(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv1 = nn.Conv3d(c, c, 3, padding=1)
        self.conv2 = nn.Conv3d(c, c, 3, padding=1)
        self.norm1 = FrozenBatchNorm(c)
        self.norm2 = FrozenBatchNorm(c)

    def forward(self, x):
        h = self.conv1(torch.relu(self.norm1(x)))
        return x + self.conv2(torch.relu(self.norm2(h)))


class ResBottleneck(nn.Module):
    def __init__(self, c: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(c, c // 4, 1)
        self.norm1 = FrozenBatchNorm(c // 4)
        self.conv2 = nn.Conv2d(c // 4, c // 4, 3, stride, 1)
        self.norm2 = FrozenBatchNorm(c // 4)
        self.conv3 = nn.Conv2d(c // 4, c, 1)
        self.norm3 = FrozenBatchNorm(c)
        self.stride = stride
        if stride != 1:
            self.skip = nn.Conv2d(c, c, 1, stride)
            self.norm4 = FrozenBatchNorm(c)

    def forward(self, x):
        h = torch.relu(self.norm1(self.conv1(x)))
        h = torch.relu(self.norm2(self.conv2(h)))
        h = self.norm3(self.conv3(h))
        if self.stride != 1:
            x = self.norm4(self.skip(x))
        return torch.relu(h + x)


class _Encoder3d(nn.Module):
    def __init__(self, be: int, cin: int, num_blocks: int, mf: int):
        super().__init__()
        self.down_blocks = nn.ModuleList(
            DownBlock3d(cin if i == 0 else min(mf, be * 2 ** i), min(mf, be * 2 ** (i + 1)))
            for i in range(num_blocks))

    def forward(self, x):
        outs = [x]
        for down in self.down_blocks:
            outs.append(down(outs[-1]))
        return outs


class _Decoder3d(nn.Module):
    def __init__(self, be: int, cin: int, num_blocks: int, mf: int):
        super().__init__()
        self.up_blocks = nn.ModuleList(
            UpBlock3d((1 if i == num_blocks - 1 else 2) * min(mf, be * 2 ** (i + 1)),
                      min(mf, be * 2 ** i))
            for i in reversed(range(num_blocks)))
        self.out_filters = be + cin
        self.conv = nn.Conv3d(self.out_filters, self.out_filters, 3, padding=1)
        self.norm = FrozenBatchNorm(self.out_filters)

    def forward(self, outs):
        out = outs.pop()
        for up in self.up_blocks:
            out = torch.cat([up(out), outs.pop()], dim=1)
        return torch.relu(self.norm(self.conv(out)))


class Hourglass3d(nn.Module):
    """3D hourglass with skip concats (reference util.py:262-330)."""

    def __init__(self, block_expansion: int, in_features: int, num_blocks: int = 5,
                 max_features: int = 1024):
        super().__init__()
        self.encoder = _Encoder3d(block_expansion, in_features, num_blocks, max_features)
        self.decoder = _Decoder3d(block_expansion, in_features, num_blocks, max_features)
        self.out_filters = self.decoder.out_filters

    def forward(self, x):
        return self.decoder(self.encoder(x))


class KPHourglass(nn.Module):
    """2D downs -> 1x1 conv -> view to 3D -> 3D ups (reference util.py:335-368)."""

    def __init__(self, block_expansion: int, in_features: int, reshape_features: int,
                 reshape_depth: int, num_blocks: int = 5, max_features: int = 1024):
        super().__init__()
        be, mf = block_expansion, max_features
        self.down_blocks = nn.Sequential()
        for i in range(num_blocks):
            self.down_blocks.add_module(f"down{i}", DownBlock2d(
                in_features if i == 0 else min(mf, be * 2 ** i), min(mf, be * 2 ** (i + 1))))
        self.conv = nn.Conv2d(min(mf, be * 2 ** num_blocks), reshape_features, 1)
        self.up_blocks = nn.Sequential()
        for i in range(num_blocks):
            self.up_blocks.add_module(f"up{i}", UpBlock3d(
                reshape_features // reshape_depth if i == 0
                else min(mf, be * 2 ** (num_blocks - i)),
                min(mf, be * 2 ** (num_blocks - i - 1))))
        self.reshape_depth = reshape_depth
        self.out_filters = min(mf, be)

    def forward(self, x):
        x = self.conv(self.down_blocks(x))
        b, c, h, w = x.shape
        x = x.view(b, c // self.reshape_depth, self.reshape_depth, h, w)
        return self.up_blocks(x)


def antialias_kernel(scale: float) -> np.ndarray:
    """The Gaussian of AntiAliasInterpolation2d (reference util.py:372-415):
    sigma = (1 / scale - 1) / 2, 2 * round(4 sigma) + 1 taps, normalised;
    (ks, ks) float64."""
    sigma = (1 / scale - 1) / 2
    ks = 2 * round(sigma * 4) + 1
    t = np.arange(ks, dtype=np.float64)
    g = np.exp(-((t - (ks - 1) / 2) ** 2) / (2 * sigma ** 2))
    k2 = np.outer(g, g)
    return k2 / k2.sum()


class AntiAliasDownsample(nn.Module):
    """Band-limited downsample by an integer factor (reference util.py:372-415):
    a depthwise Gaussian with zero padding, then every (1/scale)-th sample,
    computed as one strided depthwise convolution. The kernel is a constant
    of the module (the reference's `weight` buffer is checked and dropped on
    load, `convert.drop_antialias_buffers`)."""

    def __init__(self, channels: int, scale: float = 0.25):
        super().__init__()
        k = torch.from_numpy(antialias_kernel(scale).astype(np.float32))
        self.register_buffer("kernel", k[None, None].repeat(channels, 1, 1, 1),
                             persistent=False)
        self.step = int(1 / scale)
        self.pad = k.shape[0] // 2

    def forward(self, x):
        p = self.pad
        return F.conv2d(F.pad(x, (p, p, p, p)), self.kernel.to(x.dtype), stride=self.step,
                        groups=x.shape[1])


# ------------------------------------------------------------------ nets


class KPDetector(nn.Module):
    """Canonical 3D keypoints (reference keypoint_detector.py:9)."""

    def __init__(self, num_kp: int = 15, temperature: float = 0.1, block_expansion: int = 32,
                 max_features: int = 1024, reshape_features: int = 16384,
                 reshape_depth: int = 16, num_blocks: int = 5, image_channel: int = 3,
                 scale_factor: float = 0.25):
        super().__init__()
        self.down = AntiAliasDownsample(image_channel, scale_factor)
        self.predictor = KPHourglass(block_expansion, image_channel, reshape_features,
                                     reshape_depth, num_blocks, max_features)
        self.kp = nn.Conv3d(self.predictor.out_filters, num_kp, 3, padding=1)
        self.temperature = temperature

    def forward(self, x) -> dict:
        pred = self.kp(self.predictor(self.down(x)))              # (B, K, D, H, W)
        b, k, d, h, w = pred.shape
        heat = torch.softmax(pred.reshape(b, k, -1) / self.temperature, dim=2)
        grid = make_grid_3d(d, h, w, device=x.device).reshape(-1, 3)
        return {"value": heat @ grid}                             # (B, K, 3)


class HEEstimator(nn.Module):
    """Head pose and expression (reference keypoint_detector.py:86). As in
    the reference, the head called `fc_roll` gives the "yaw" output and
    `fc_yaw` the "roll" (keypoint_detector.py:173-175): the checkpoint
    depends on it."""

    def __init__(self, num_kp: int = 15, num_bins: int = 66, block_expansion: int = 64,
                 width: int = 256, image_channel: int = 3):
        super().__init__()
        be, w = block_expansion, width
        self.conv1 = nn.Conv2d(image_channel, be, 7, 2, 3)
        self.norm1 = FrozenBatchNorm(be)
        self.conv2 = nn.Conv2d(be, w, 1)
        self.norm2 = FrozenBatchNorm(w)
        self.block1 = self._blocks("b1", w, 3)
        self.conv3 = nn.Conv2d(w, 2 * w, 1)
        self.norm3 = FrozenBatchNorm(2 * w)
        self.block2 = ResBottleneck(2 * w, 2)
        self.block3 = self._blocks("b3", 2 * w, 3)
        self.conv4 = nn.Conv2d(2 * w, 4 * w, 1)
        self.norm4 = FrozenBatchNorm(4 * w)
        self.block4 = ResBottleneck(4 * w, 2)
        self.block5 = self._blocks("b5", 4 * w, 5)
        self.conv5 = nn.Conv2d(4 * w, 8 * w, 1)
        self.norm5 = FrozenBatchNorm(8 * w)
        self.block6 = ResBottleneck(8 * w, 2)
        self.block7 = self._blocks("b7", 8 * w, 2)
        self.fc_roll = nn.Linear(8 * w, num_bins)
        self.fc_pitch = nn.Linear(8 * w, num_bins)
        self.fc_yaw = nn.Linear(8 * w, num_bins)
        self.fc_t = nn.Linear(8 * w, 3)
        self.fc_exp = nn.Linear(8 * w, 3 * num_kp)

    @staticmethod
    def _blocks(tag: str, c: int, n: int) -> nn.Sequential:
        seq = nn.Sequential()
        for i in range(n):
            seq.add_module(f"{tag}_{i}", ResBottleneck(c, 1))
        return seq

    def forward(self, x) -> dict:
        x = torch.relu(self.norm1(self.conv1(x)))
        x = max_pool2d(x, 3, 2, padding=1)
        x = self.block1(torch.relu(self.norm2(self.conv2(x))))
        x = self.block3(self.block2(torch.relu(self.norm3(self.conv3(x)))))
        x = self.block5(self.block4(torch.relu(self.norm4(self.conv4(x)))))
        x = self.block7(self.block6(torch.relu(self.norm5(self.conv5(x)))))
        x = x.mean(dim=(2, 3))
        return {"yaw": self.fc_roll(x), "pitch": self.fc_pitch(x), "roll": self.fc_yaw(x),
                "t": self.fc_t(x), "exp": self.fc_exp(x)}


class DenseMotionNetwork(nn.Module):
    """Sparse keypoint motions -> dense 3D deformation and occlusion
    (reference dense_motion.py:9)."""

    def __init__(self, num_kp: int = 15, feature_channel: int = 32, compress: int = 4,
                 block_expansion: int = 32, num_blocks: int = 5, max_features: int = 1024,
                 reshape_depth: int = 16):
        super().__init__()
        self.hourglass = Hourglass3d(block_expansion, (num_kp + 1) * (compress + 1),
                                     num_blocks, max_features)
        self.mask = nn.Conv3d(self.hourglass.out_filters, num_kp + 1, 7, padding=3)
        self.compress = nn.Conv3d(feature_channel, compress, 1)
        self.norm = FrozenBatchNorm(compress)
        self.occlusion = nn.Conv2d(self.hourglass.out_filters * reshape_depth, 1, 7, padding=3)
        self.num_kp = num_kp

    def forward(self, feature, kp_driving: dict, kp_source: dict) -> dict:
        b, _, d, h, w = feature.shape
        k1 = self.num_kp + 1
        feat = torch.relu(self.norm(self.compress(feature)))      # (B, c, D, H, W)
        c = feat.shape[1]

        ident = make_grid_3d(d, h, w, device=feature.device)[None, None]
        d2s = ident - kp_driving["value"][:, :, None, None, None] \
            + kp_source["value"][:, :, None, None, None]
        sparse = torch.cat([ident.expand(b, 1, d, h, w, 3), d2s], dim=1)  # (B, K+1, D, H, W, 3)

        feat_rep = feat[:, None].expand(b, k1, c, d, h, w).reshape(b * k1, c, d, h, w)
        deformed = grid_sample_3d(feat_rep, sparse.reshape(b * k1, d, h, w, 3))
        deformed = deformed.view(b, k1, c, d, h, w)

        heat = kp2gaussian3d(kp_driving["value"], (d, h, w)) \
            - kp2gaussian3d(kp_source["value"], (d, h, w))
        heat = torch.cat([heat.new_zeros(b, 1, d, h, w), heat], dim=1)[:, :, None]
        inp = torch.cat([heat, deformed], dim=2).view(b, k1 * (1 + c), d, h, w)

        pred = self.hourglass(inp)                                # (B, Cp, D, H, W)
        mask = torch.softmax(self.mask(pred), dim=1)              # (B, K+1, D, H, W)
        deformation = torch.einsum("bkdhwc,bkdhw->bdhwc", sparse, mask)
        occ = torch.sigmoid(self.occlusion(pred.reshape(b, -1, h, w)))
        return {"mask": mask, "deformation": deformation, "occlusion_map": occ}


class FV2VSPADE(nn.Module):
    """SPADE (reference util.py:421-441): parameter-free instance norm,
    modulated by convolutions of the nearest-resized segmap."""

    def __init__(self, norm_nc: int, label_nc: int, nhidden: int = 128):
        super().__init__()
        self.mlp_shared = nn.Sequential(nn.Conv2d(label_nc, nhidden, 3, padding=1), nn.ReLU())
        self.mlp_gamma = nn.Conv2d(nhidden, norm_nc, 3, padding=1)
        self.mlp_beta = nn.Conv2d(nhidden, norm_nc, 3, padding=1)

    def forward(self, x, seg):
        seg = resize_nearest(seg, tuple(x.shape[-2:]))
        actv = self.mlp_shared(seg)
        return F.instance_norm(x, eps=1e-5) * (1 + self.mlp_gamma(actv)) + self.mlp_beta(actv)


class FV2VSPADEResBlock(nn.Module):
    """SPADEResnetBlock (reference util.py:444-476); its spectral norms are
    folded into the weights on load."""

    def __init__(self, fin: int, fout: int, label_nc: int):
        super().__init__()
        fmiddle = min(fin, fout)
        self.learned_shortcut = fin != fout
        self.conv_0 = nn.Conv2d(fin, fmiddle, 3, padding=1)
        self.conv_1 = nn.Conv2d(fmiddle, fout, 3, padding=1)
        self.norm_0 = FV2VSPADE(fin, label_nc)
        self.norm_1 = FV2VSPADE(fmiddle, label_nc)
        if self.learned_shortcut:
            self.conv_s = nn.Conv2d(fin, fout, 1, bias=False)
            self.norm_s = FV2VSPADE(fin, label_nc)

    def forward(self, x, seg):
        xs = self.conv_s(self.norm_s(x, seg)) if self.learned_shortcut else x
        dx = self.conv_0(F.leaky_relu(self.norm_0(x, seg), 0.2))
        dx = self.conv_1(F.leaky_relu(self.norm_1(dx, seg), 0.2))
        return xs + dx


class SPADEDecoder(nn.Module):
    """(reference generator.py:124-158); the segmap is the decoder's own
    input. `label_nc` = `ic` = 256 at vox-256."""

    def __init__(self, label_nc: int = 256, ic: int = 256, oc: int = 64, num_middle: int = 6):
        super().__init__()
        self.fc = nn.Conv2d(label_nc, 2 * ic, 3, padding=1)
        for i in range(num_middle):
            self.add_module(f"G_middle_{i}", FV2VSPADEResBlock(2 * ic, 2 * ic, label_nc))
        self.up_0 = FV2VSPADEResBlock(2 * ic, ic, label_nc)
        self.up_1 = FV2VSPADEResBlock(ic, oc, label_nc)
        self.conv_img = nn.Conv2d(oc, 3, 3, padding=1)
        self.num_middle = num_middle

    def forward(self, feature):
        seg = feature
        x = self.fc(feature)
        for i in range(self.num_middle):
            x = getattr(self, f"G_middle_{i}")(x, seg)
        x = self.up_0(resize_nearest(x, (2 * x.shape[-2], 2 * x.shape[-1])), seg)
        x = self.up_1(resize_nearest(x, (2 * x.shape[-2], 2 * x.shape[-1])), seg)
        return torch.sigmoid(self.conv_img(F.leaky_relu(x, 0.2)))


class OcclusionAwareSPADEGenerator(nn.Module):
    """(reference generator.py:161-250). vox-256: block_expansion 64,
    max_features 512, 2 down blocks, the volume (32, 16), 6 3D resblocks."""

    def __init__(self, num_kp: int = 15, block_expansion: int = 64, max_features: int = 512,
                 num_down_blocks: int = 2, reshape_channel: int = 32, reshape_depth: int = 16,
                 num_resblocks: int = 6, dm_block_expansion: int = 32,
                 dm_max_features: int = 1024, dm_num_blocks: int = 5, compress: int = 4,
                 decoder_ic: int = 256, image_channel: int = 3):
        super().__init__()
        be, mf = block_expansion, max_features
        self.first = SameBlock2d(image_channel, be, 3)
        self.down_blocks = nn.ModuleList(
            DownBlock2d(min(mf, be * 2 ** i), min(mf, be * 2 ** (i + 1)))
            for i in range(num_down_blocks))
        self.second = nn.Conv2d(min(mf, be * 2 ** num_down_blocks), mf, 1)
        self.resblocks_3d = nn.Sequential()
        for i in range(num_resblocks):
            self.resblocks_3d.add_module(f"3dr{i}", ResBlock3d(reshape_channel))
        self.dense_motion_network = DenseMotionNetwork(
            num_kp, reshape_channel, compress, dm_block_expansion, dm_num_blocks,
            dm_max_features, reshape_depth)
        out_c = be * 2 ** num_down_blocks
        self.third = SameBlock2d(reshape_channel * reshape_depth, out_c, 3, lrelu=True)
        self.fourth = nn.Conv2d(out_c, out_c, 1)
        self.decoder = SPADEDecoder(out_c, decoder_ic)
        self.reshape_channel, self.reshape_depth = reshape_channel, reshape_depth

    def forward(self, source_image, kp_driving: dict, kp_source: dict) -> dict:
        x = self.first(source_image)
        for down in self.down_blocks:
            x = down(x)
        x = self.second(x)
        b, _, h, w = x.shape
        f3d = self.resblocks_3d(x.view(b, self.reshape_channel, self.reshape_depth, h, w))
        dense = self.dense_motion_network(f3d, kp_driving, kp_source)
        deformed = grid_sample_3d(f3d, dense["deformation"])
        out = self.fourth(self.third(deformed.reshape(b, -1, h, w)))
        occ = dense["occlusion_map"]
        if occ.shape[-2:] != out.shape[-2:]:
            occ = resize_bilinear(occ, tuple(out.shape[-2:]))
        return {"prediction": self.decoder(out * occ), "occlusion_map": dense["occlusion_map"],
                "mask": dense["mask"]}


# ------------------------------------------------------- keypoint transforms


def headpose_to_degree(logits: torch.Tensor) -> torch.Tensor:
    return bins_to_degrees(logits)


def rotation_matrix(yaw, pitch, roll) -> torch.Tensor:
    """(reference drive_demo.py:107-133; degrees). As in the reference, degrees
    become radians with 3.14, not pi."""
    yaw, pitch, roll = (a / 180 * 3.14 for a in (yaw, pitch, roll))
    z, o = torch.zeros_like(yaw), torch.ones_like(yaw)
    c, s = torch.cos, torch.sin
    pitch_m = torch.stack([o, z, z, z, c(pitch), -s(pitch), z, s(pitch), c(pitch)],
                          -1).reshape(-1, 3, 3)
    yaw_m = torch.stack([c(yaw), z, s(yaw), z, o, z, -s(yaw), z, c(yaw)], -1).reshape(-1, 3, 3)
    roll_m = torch.stack([c(roll), -s(roll), z, s(roll), c(roll), z, z, z, o],
                         -1).reshape(-1, 3, 3)
    return torch.einsum("bij,bjk,bkm->bim", pitch_m, yaw_m, roll_m)


def keypoint_transformation(kp_canonical: dict, he: dict, *, yaw=None, pitch=None,
                            roll=None) -> dict:
    """(reference drive_demo.py:135-180, estimate_jacobian=False). yaw,
    pitch, roll: optional free-view overrides in degrees (a scalar or a (B,)
    tensor fixes that angle; None takes it from the head-pose estimate)."""
    kp = kp_canonical["value"]
    b = kp.shape[0]

    def angle(override, logits):
        if override is None:
            return headpose_to_degree(logits)
        return torch.as_tensor(override, dtype=torch.float32,
                               device=kp.device).reshape(-1).expand(b)

    rot = rotation_matrix(angle(yaw, he["yaw"]), angle(pitch, he["pitch"]),
                          angle(roll, he["roll"]))
    kp_t = torch.einsum("bmp,bkp->bkm", rot, kp) + he["t"][:, None, :]
    return {"value": kp_t + he["exp"].reshape(b, -1, 3)}


# ------------------------------------------------------------------ driver

def facevid2vid_state_dicts(ckpt: Mapping) -> dict[str, dict[str, torch.Tensor]]:
    """A faceVid2Vid checkpoint (nested {'generator', 'kp_detector',
    'he_estimator'} or flattened 'net.param' keys; reference files or
    `convert.facevid2vid_state_dicts_from_jax`) for strict loads: `module.`
    stripped, spectral norms folded, BatchNorm counters dropped, and the
    keypoint detector's anti-alias `down.weight` checked against the port's
    constant and dropped."""
    from e4s2024_torch.convert import drop_antialias_buffers, nest_flat_checkpoint

    ckpt = nest_flat_checkpoint(ckpt)
    out = {}
    for net in ("generator", "kp_detector", "he_estimator"):
        sd = fold_spectral_norm(strip_module_prefix(ckpt[net]))
        sd = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
        if net == "kp_detector":
            sd = drop_antialias_buffers(sd, {"down.weight": 0.25})
        out[net] = as_tensors(sd)
    return out


class FaceVid2VidDriver:
    """drive_source_demo (reference drive_demo.py:241-259): the 256^2 source
    animated with the pose and expression of each target frame.
    `frames_per_batch` frames run through the generator at once (the
    reference runs one at a time)."""

    def __init__(self, ckpt: Mapping, *, kp: dict | None = None, he: dict | None = None,
                 gen: dict | None = None, frames_per_batch: int = 4, device=None):
        self.device = resolve_device(device)
        self.kp = KPDetector(**(kp or {}))
        self.he = HEEstimator(**(he or {}))
        self.gen = OcclusionAwareSPADEGenerator(**(gen or {}))
        sds = facevid2vid_state_dicts(ckpt)
        for net, name in ((self.kp, "kp_detector"), (self.he, "he_estimator"),
                          (self.gen, "generator")):
            net.load_state_dict(sds[name], strict=True)
            net.eval().requires_grad_(False).to(self.device)
        self.frames_per_batch = frames_per_batch

    def _nchw(self, x01) -> torch.Tensor:
        return torch.as_tensor(x01, device=self.device).float().permute(0, 3, 1, 2)

    @torch.inference_mode()
    def drive(self, source01, targets01) -> torch.Tensor:
        """source01: (1, 256, 256, 3) in [0, 1]; targets01: (F, 256, 256, 3).
        Returns (F, 256, 256, 3) driven frames in [0, 1]."""
        src = self._nchw(source01)
        tgt = self._nchw(targets01)
        kp_canon = self.kp(src)
        kp_src = keypoint_transformation(kp_canon, self.he(src))
        outs = []
        for i in range(0, tgt.shape[0], self.frames_per_batch):
            he_drv = self.he(tgt[i:i + self.frames_per_batch])
            f = he_drv["yaw"].shape[0]
            kp_drv = keypoint_transformation({"value": kp_canon["value"].expand(f, -1, -1)},
                                             he_drv)
            outs.append(self.gen(src.expand(f, -1, -1, -1), kp_drv,
                                 {"value": kp_src["value"].expand(f, -1, -1)})["prediction"])
        return torch.cat(outs).permute(0, 2, 3, 1)

    @torch.inference_mode()
    def set_pose(self, source01, *, yaw=0.0, pitch=0.0, roll=0.0) -> torch.Tensor:
        """Free-view re-pose (reference make_animation free_view mode,
        drive_demo.py:182/202): the source re-rendered at fixed head-pose
        angles in degrees, keeping its own expression and translation. The
        defaults frontalise. Returns (1, 256, 256, 3) in [0, 1]."""
        src = self._nchw(source01)
        kp_canon = self.kp(src)
        he = self.he(src)
        kp_src = keypoint_transformation(kp_canon, he)
        kp_drv = keypoint_transformation(kp_canon, he, yaw=yaw, pitch=pitch, roll=roll)
        return self.gen(src, kp_drv, kp_src)["prediction"].permute(0, 2, 3, 1)
