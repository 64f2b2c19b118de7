"""DaGAN (Depth-Aware Generative Adversarial Network) reenactment.

Counterpart of `e4s2024_tpu/models/dagan.py` in NCHW, with the reference's
state-dict names (swap_face_fine/DaGAN/: FOMM-style keypoints with
jacobians on the depth-augmented input, modules/keypoint_detector.py:7;
first-order dense motion, modules/dense_motion.py:9; the
`DepthAwareGenerator` with depth self-attention, modules/generator.py:56,92,
the variant face_swap_for_video.py:319 selects; the monodepth2 depth
network, depth/resnet_encoder.py:62 ResnetEncoder(50) and
depth/depth_decoder.py:17 DepthDecoder), driven as drive_demo.py:59
`make_animation` (kp_driving used directly). The reference's checkpoints
are internal cluster paths (face_swap_for_video.py:311-313), so weights are
the caller's.

The K+1 sparse warps run as one folded-batch `grid_sample`; the depth
attention at 64^2 is one (4096 x 4096) product, as in the JAX package
(which runs it outside any Pallas kernel).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from e4s2024_torch import resolve_device
from e4s2024_torch.convert import as_tensors, strip_module_prefix
from e4s2024_torch.models.arcface import FrozenBatchNorm
from e4s2024_torch.models.facevid2vid import (
    AntiAliasDownsample, DownBlock2d, SameBlock2d, UpBlock2d)
from e4s2024_torch.models.hopenet import resnet_layers
from e4s2024_torch.models.tpsmm import grid_sample_2d, kp2gaussian2d, make_grid_2d
from e4s2024_torch.ops.pool import max_pool2d
from e4s2024_torch.ops.resize import resize_bilinear, resize_nearest


class DaGANResBlock2d(nn.Module):
    """FOMM ResBlock2d (DaGAN util.py:52): BN, relu, conv, twice; residual."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1 = nn.Conv2d(c, c, 3, padding=1)
        self.conv2 = nn.Conv2d(c, c, 3, padding=1)
        self.norm1 = FrozenBatchNorm(c)
        self.norm2 = FrozenBatchNorm(c)

    def forward(self, x):
        r = self.conv1(torch.relu(self.norm1(x)))
        return x + self.conv2(torch.relu(self.norm2(r)))


class _Encoder2d(nn.Module):
    def __init__(self, be, cin, num_blocks, mf):
        super().__init__()
        self.down_blocks = nn.ModuleList(
            DownBlock2d(cin if i == 0 else min(mf, be * 2 ** i), min(mf, be * 2 ** (i + 1)))
            for i in range(num_blocks))


class _Decoder2d(nn.Module):
    def __init__(self, be, cin, num_blocks, mf):
        super().__init__()
        self.up_blocks = nn.ModuleList(
            UpBlock2d((1 if i == num_blocks - 1 else 2) * min(mf, be * 2 ** (i + 1)),
                      min(mf, be * 2 ** i))
            for i in reversed(range(num_blocks)))


class DaGANHourglass(nn.Module):
    """FOMM hourglass (DaGAN util.py:241): the final concat, of
    block_expansion + in_features channels."""

    def __init__(self, block_expansion: int, in_features: int, num_blocks: int = 5,
                 max_features: int = 1024):
        super().__init__()
        self.encoder = _Encoder2d(block_expansion, in_features, num_blocks, max_features)
        self.decoder = _Decoder2d(block_expansion, in_features, num_blocks, max_features)
        self.out_filters = block_expansion + in_features

    def forward(self, x):
        enc = [x]
        for down in self.encoder.down_blocks:
            enc.append(down(enc[-1]))
        out = enc.pop()
        for up in self.decoder.up_blocks:
            out = torch.cat([up(out), enc.pop()], dim=1)
        return out


class DaGANKPDetector(nn.Module):
    """Keypoints and jacobians from cat(rgb, disparity) (reference
    keypoint_detector.py:7). The vox config leaves the 7x7 heads unpadded
    (pad 0), as FOMM does."""

    def __init__(self, num_kp: int = 15, block_expansion: int = 32, max_features: int = 1024,
                 num_blocks: int = 5, temperature: float = 0.1, scale_factor: float = 0.25,
                 estimate_jacobian: bool = True, pad: int = 0, num_channels: int = 4):
        super().__init__()
        self.down = AntiAliasDownsample(num_channels, scale_factor) if scale_factor != 1 else None
        self.predictor = DaGANHourglass(block_expansion, num_channels, num_blocks, max_features)
        self.kp = nn.Conv2d(self.predictor.out_filters, num_kp, 7, padding=pad)
        self.jacobian = (nn.Conv2d(self.predictor.out_filters, 4 * num_kp, 7, padding=pad)
                         if estimate_jacobian else None)
        self.temperature = temperature

    def forward(self, x) -> dict:
        if self.down is not None:
            x = self.down(x)
        feat = self.predictor(x)
        pred = self.kp(feat)
        b, k, h, w = pred.shape
        heat = torch.softmax(pred.reshape(b, k, -1) / self.temperature, dim=2)
        out = {"value": heat @ make_grid_2d(h, w, device=x.device).reshape(-1, 2)}
        if self.jacobian is not None:
            jac_map = self.jacobian(feat).reshape(b, k, 4, h * w)
            out["jacobian"] = torch.einsum("bkn,bkjn->bkj", heat, jac_map).reshape(b, k, 2, 2)
        return out


class DaGANDenseMotion(nn.Module):
    """First-order dense motion (reference dense_motion.py:9): K sparse
    affine warps (the jacobian term) and the identity, combined by a
    softmax mask."""

    def __init__(self, num_kp: int = 15, num_channels: int = 3, block_expansion: int = 64,
                 max_features: int = 1024, num_blocks: int = 5, scale_factor: float = 0.25,
                 kp_variance: float = 0.01, estimate_occlusion_map: bool = True):
        super().__init__()
        self.hourglass = DaGANHourglass(block_expansion, (num_kp + 1) * (num_channels + 1),
                                        num_blocks, max_features)
        self.mask = nn.Conv2d(self.hourglass.out_filters, num_kp + 1, 7, padding=3)
        self.occlusion = (nn.Conv2d(self.hourglass.out_filters, 1, 7, padding=3)
                          if estimate_occlusion_map else None)
        self.down = AntiAliasDownsample(num_channels, scale_factor) if scale_factor != 1 else None
        self.num_kp, self.kp_variance = num_kp, kp_variance

    def forward(self, source_image, kp_driving: dict, kp_source: dict) -> dict:
        k = self.num_kp
        if self.down is not None:
            source_image = self.down(source_image)
        b, c, h, w = source_image.shape
        heat = kp2gaussian2d(kp_driving["value"], (h, w), self.kp_variance) \
            - kp2gaussian2d(kp_source["value"], (h, w), self.kp_variance)
        heat = torch.cat([heat.new_zeros(b, 1, h, w), heat], dim=1)

        ident = make_grid_2d(h, w, device=source_image.device)[None, None]
        coord = ident - kp_driving["value"][:, :, None, None, :]
        if "jacobian" in kp_driving:
            jac = kp_source["jacobian"] @ torch.linalg.inv(kp_driving["jacobian"])
            coord = torch.einsum("bkij,bkhwj->bkhwi", jac, coord)
        d2s = coord + kp_source["value"][:, :, None, None, :]
        sparse = torch.cat([ident.expand(b, 1, h, w, 2), d2s], 1)  # (B, K+1, h, w, 2)

        src_rep = source_image[:, None].expand(b, k + 1, c, h, w).reshape(-1, c, h, w)
        deformed = grid_sample_2d(src_rep, sparse.reshape(-1, h, w, 2), align_corners=False)
        deformed = deformed.view(b, k + 1, c, h, w)
        inp = torch.cat([heat[:, :, None], deformed], dim=2).view(b, -1, h, w)
        pred = self.hourglass(inp)
        mask = torch.softmax(self.mask(pred), dim=1)
        out = {"deformation": torch.einsum("bkhwd,bkhw->bhwd", sparse, mask), "mask": mask,
               "sparse_deformed": deformed}
        if self.occlusion is not None:
            out["occlusion_map"] = torch.sigmoid(self.occlusion(pred))
        return out


class DepthAwareAttention(nn.Module):
    """Depth-guided self-attention (reference generator.py:56): queries from
    the depth feature, keys and values from the warped image feature."""

    def __init__(self, c: int):
        super().__init__()
        self.query_conv = nn.Conv2d(c, c // 8, 1)
        self.key_conv = nn.Conv2d(c, c // 8, 1)
        self.value_conv = nn.Conv2d(c, c, 1)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, source, feat):
        b, c, h, w = feat.shape
        q = torch.relu(self.query_conv(source)).reshape(b, -1, h * w)
        k = torch.relu(self.key_conv(feat)).reshape(b, -1, h * w)
        v = torch.relu(self.value_conv(feat)).reshape(b, c, h * w)
        attn = torch.softmax(q.transpose(1, 2) @ k, dim=-1)     # (B, N, N)
        out = (v @ attn.transpose(1, 2)).reshape(b, c, h, w)
        return self.gamma * out + feat, attn


class DepthAwareGenerator(nn.Module):
    """Occlusion-aware generator with a depth encoder branch (reference
    generator.py:92; vox-adv: be 64, mf 512, 2 down blocks, 6 bottleneck
    blocks, occlusion on)."""

    def __init__(self, num_kp: int = 15, num_channels: int = 3, block_expansion: int = 64,
                 max_features: int = 512, num_down_blocks: int = 2,
                 num_bottleneck_blocks: int = 6, dense_motion: dict | None = None):
        super().__init__()
        be, mf, nd = block_expansion, max_features, num_down_blocks
        self.first = SameBlock2d(num_channels, be, 7)
        self.src_first = SameBlock2d(1, be, 7)
        chans = [be] + [min(mf, be * 2 ** (i + 1)) for i in range(nd)]
        self.down_blocks = nn.ModuleList(DownBlock2d(chans[i], chans[i + 1]) for i in range(nd))
        self.src_down_blocks = nn.ModuleList(DownBlock2d(chans[i], chans[i + 1])
                                             for i in range(nd))
        self.up_blocks = nn.ModuleList(UpBlock2d(min(mf, be * 2 ** (nd - i)),
                                                 min(mf, be * 2 ** (nd - i - 1)))
                                       for i in range(nd))
        self.bottleneck = nn.Sequential()
        for i in range(num_bottleneck_blocks):
            self.bottleneck.add_module(f"r{i}", DaGANResBlock2d(chans[-1]))
        self.final = nn.Conv2d(be, num_channels, 7, padding=3)
        self.AttnModule = DepthAwareAttention(chans[-1])
        self.dense_motion_network = DaGANDenseMotion(num_kp, num_channels,
                                                     **(dense_motion or {}))

    def forward(self, source_image, kp_driving, kp_source, source_depth) -> dict:
        out = self.first(source_image)
        for down in self.down_blocks:
            out = down(out)
        src = self.src_first(source_depth)
        for down in self.src_down_blocks:
            src = down(src)
        dm = self.dense_motion_network(source_image, kp_driving, kp_source)
        deformation = dm["deformation"]

        def deform(inp):
            d = deformation
            if tuple(d.shape[1:3]) != tuple(inp.shape[-2:]):
                d = resize_bilinear(d.permute(0, 3, 1, 2), tuple(inp.shape[-2:])
                                    ).permute(0, 2, 3, 1)
            return grid_sample_2d(inp, d, align_corners=False)

        out = deform(out)
        occ = dm.get("occlusion_map")
        if occ is not None:
            if occ.shape[-2:] != out.shape[-2:]:
                occ = resize_bilinear(occ, tuple(out.shape[-2:]))
            out = out * occ
        out, attention = self.AttnModule(src, out)
        out = self.bottleneck(out)
        for up in self.up_blocks:
            out = up(out)
        return {"prediction": torch.sigmoid(self.final(out)), "deformed": deform(source_image),
                "occlusion_map": dm.get("occlusion_map"), "attention": attention}


# -------------------------------------------------------- monodepth2 depth


class _ResNet(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        self.layer1, self.layer2, self.layer3, self.layer4 = resnet_layers(layers)


class DepthResnetEncoder(nn.Module):
    """monodepth2 ResnetEncoder(50) (reference depth/resnet_encoder.py:62):
    the five feature scales of (x - 0.45) / 0.225."""

    def __init__(self, layers=(3, 4, 6, 3)):
        super().__init__()
        self.encoder = _ResNet(layers)

    def forward(self, img01):
        e = self.encoder
        x = torch.relu(e.bn1(e.conv1((img01 - 0.45) / 0.225)))
        feats = [x]
        x = max_pool2d(x, 3, 2, padding=1)
        for layer in (e.layer1, e.layer2, e.layer3, e.layer4):
            x = layer(x)
            feats.append(x)
        return feats


class _Conv3x3(nn.Module):
    """Reflection-padded 3x3 conv (monodepth2 layers.py Conv3x3)."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3)

    def forward(self, x):
        return self.conv(F.pad(x, (1, 1, 1, 1), mode="reflect"))


class _ConvBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = _Conv3x3(cin, cout)

    def forward(self, x):
        return F.elu(self.conv(x))


NUM_CH_ENC = (64, 256, 512, 1024, 2048)


class DepthDecoder(nn.Module):
    """monodepth2 DepthDecoder (reference depth/depth_decoder.py:17): the
    full-resolution disparity only (scale 0), the one inference reads. Its
    `decoder` list holds the reference's order: upconv (4..0, j = 0, 1),
    then dispconv 0 (index 10)."""

    def __init__(self, num_ch_dec=(16, 32, 64, 128, 256), num_ch_enc=NUM_CH_ENC):
        super().__init__()
        convs = []
        for i in range(4, -1, -1):
            cin0 = num_ch_enc[-1] if i == 4 else num_ch_dec[i + 1]
            convs.append(_ConvBlock(cin0, num_ch_dec[i]))
            cin1 = num_ch_dec[i] + (num_ch_enc[i - 1] if i > 0 else 0)
            convs.append(_ConvBlock(cin1, num_ch_dec[i]))
        convs.append(_Conv3x3(num_ch_dec[0], 1))
        self.decoder = nn.ModuleList(convs)

    def forward(self, features):
        x = features[-1]
        for n, i in enumerate(range(4, -1, -1)):
            x = self.decoder[2 * n](x)
            x = resize_nearest(x, (2 * x.shape[-2], 2 * x.shape[-1]))
            if i > 0:
                x = torch.cat([x, features[i - 1]], dim=1)
            x = self.decoder[2 * n + 1](x)
        return torch.sigmoid(self.decoder[10](x))


def dagan_state_dicts(generator: Mapping, kp_detector: Mapping, depth_encoder: Mapping,
                      depth_decoder: Mapping, kp_scale: float = 0.25,
                      dm_scale: float = 0.25) -> dict[str, dict]:
    """DaGAN's four state dicts for strict loads (reference files, the main
    checkpoint's 'generator' / 'kp_detector' entries or its flattened form,
    and monodepth2's encoder.pth / depth.pth; or
    `convert.dagan_state_dicts_from_jax`): `module.` stripped, BatchNorm
    counters dropped, the anti-alias `down.weight` buffers checked against
    the port's constants and dropped, and what inference never reads
    dropped: the encoder's ImageNet `fc`, the decoder's disparity heads at
    scales 1-3 (`decoder.11`-`13`) and monodepth2's non-tensor entries."""
    from e4s2024_torch.convert import drop_antialias_buffers, unwrap_envelope

    def clean(sd, drop=()):
        return {k: v for k, v in strip_module_prefix(sd).items()
                if not k.endswith("num_batches_tracked") and not k.startswith(drop)
                and isinstance(v, (torch.Tensor, np.ndarray))}

    gen = drop_antialias_buffers(clean(unwrap_envelope(generator, "generator")),
                                 {"dense_motion_network.down.weight": dm_scale})
    kp = drop_antialias_buffers(clean(unwrap_envelope(kp_detector, "kp_detector")),
                                {"down.weight": kp_scale})
    enc = clean(depth_encoder, ("encoder.fc.",))
    dec = clean(depth_decoder, tuple(f"decoder.{n}." for n in (11, 12, 13)))
    return {"generator": as_tensors(gen), "kp_detector": as_tensors(kp),
            "depth_encoder": as_tensors(enc), "depth_decoder": as_tensors(dec)}


class DaGANDriver:
    """make_animation (reference drive_demo.py:59): depth maps of both
    frames, keypoints on cat(rgb, disparity), depth-aware generation.
    `state_dicts`: {"generator", "kp_detector", "depth_encoder",
    "depth_decoder"}; `kp`, `gen`, `resnet_layers` and `num_ch_dec`
    override the nets' widths (tests)."""

    def __init__(self, state_dicts: Mapping, num_kp: int = 15, *, kp: dict | None = None,
                 gen: dict | None = None, resnet_layers=(3, 4, 6, 3),
                 num_ch_dec=(16, 32, 64, 128, 256), device=None):
        self.device = resolve_device(device)
        self.enc = DepthResnetEncoder(resnet_layers)
        self.dec = DepthDecoder(num_ch_dec)
        self.kp = DaGANKPDetector(num_kp, **(kp or {}))
        self.gen = DepthAwareGenerator(num_kp, **(gen or {}))
        dm_scale = ((gen or {}).get("dense_motion") or {}).get("scale_factor", 0.25)
        sds = dagan_state_dicts(state_dicts["generator"], state_dicts["kp_detector"],
                                state_dicts["depth_encoder"], state_dicts["depth_decoder"],
                                (kp or {}).get("scale_factor", 0.25), dm_scale)
        for net, name in ((self.enc, "depth_encoder"), (self.dec, "depth_decoder"),
                          (self.kp, "kp_detector"), (self.gen, "generator")):
            net.load_state_dict(sds[name], strict=True)
            net.eval().requires_grad_(False).to(self.device)

    @torch.inference_mode()
    def __call__(self, source01, driving01) -> torch.Tensor:
        """(B, 256, 256, 3) in [0, 1] each -> the reenacted source, (B, 256,
        256, 3) in [0, 1]."""
        src = torch.as_tensor(source01, device=self.device).float().permute(0, 3, 1, 2)
        drv = torch.as_tensor(driving01, device=self.device).float().permute(0, 3, 1, 2)
        depth = self.dec(self.enc(torch.cat([src, drv])))
        d_src, d_drv = depth[:src.shape[0]], depth[src.shape[0]:]
        kp_s = self.kp(torch.cat([src, d_src], 1))
        kp_d = self.kp(torch.cat([drv, d_drv], 1))
        return self.gen(src, kp_d, kp_s, d_src)["prediction"].permute(0, 2, 3, 1)
