"""Blender, the learned recolor at 256^2, plain: a frozen copy of the nets
of `e4s2024_torch/models/blender.py` (reference Blender/model_center/
blener.py:7) and the BlenderInfer.infer_image glue (inference.py:97-125).
The seeded state dict holds plain conv weights, so there are no spectral
norms to fold."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .arcface import FrozenBatchNorm
from .encoders import instance_norm
from .morphology import dilation_planar
from .resize import resize_bilinear, resize_nearest

_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)
_GRAY = (0.299, 0.587, 0.114)

# facial part -> 19-class ids (reference semantic_tools.py:163-172)
PART_IDS = {
    "skin": (1,), "hair": (17,), "eye": (4, 5), "nose": (10,),
    "lip": (12, 13), "tooth": (11,), "ear": (7, 8), "brow": (2, 3),
}


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


def _col(values, x):
    return torch.tensor(values, device=x.device, dtype=x.dtype).view(1, -1, 1, 1)


class SPADE(nn.Module):
    """Instance-norm SPADE with reflect padding ('spadeinstance3x3',
    normalization.py:87-156), conditioned on the 3-channel image."""

    def __init__(self, norm_nc: int, label_nc: int = 3, hidden: int = 128):
        super().__init__()
        self.mlp_shared = nn.Sequential(nn.ReflectionPad2d(1), nn.Conv2d(label_nc, hidden, 3),
                                        nn.ReLU())
        self.mlp_gamma = nn.Conv2d(hidden, norm_nc, 3, padding=1, padding_mode="reflect")
        self.mlp_beta = nn.Conv2d(hidden, norm_nc, 3, padding=1, padding_mode="reflect")

    def forward(self, x, seg):
        actv = self.mlp_shared(resize_nearest(seg, tuple(x.shape[-2:])))
        return instance_norm(x) * (1 + self.mlp_gamma(actv)) + self.mlp_beta(actv)


class SPADEResnetBlock(nn.Module):
    """architecture.py:19-96 (pad_type 'nozero': reflect)."""

    def __init__(self, fin: int, fout: int):
        super().__init__()
        fmiddle = min(fin, fout)
        self.learned_shortcut = fin != fout
        self.conv_0 = nn.Conv2d(fin, fmiddle, 3, padding=1, padding_mode="reflect")
        self.conv_1 = nn.Conv2d(fmiddle, fout, 3, padding=1, padding_mode="reflect")
        self.norm_0 = SPADE(fin)
        self.norm_1 = SPADE(fmiddle)
        if self.learned_shortcut:
            self.conv_s = nn.Conv2d(fin, fout, 1, bias=False)
            self.norm_s = SPADE(fin)

    def forward(self, x, seg):
        xs = self.conv_s(self.norm_s(x, seg)) if self.learned_shortcut else x
        dx = self.conv_0(_lrelu(self.norm_0(x, seg)))
        dx = self.conv_1(_lrelu(self.norm_1(dx, seg)))
        return xs + dx


class BlenderFPN(nn.Module):
    """AdaptiveFeatureGenerator (backbone.py:13-81) with its default flags:
    (B, 3, 256, 256) ImageNet-normalised -> (B, 256, 64, 64). The convs of
    'spectralinstance' layers carry no bias."""

    def __init__(self):
        super().__init__()
        widths = [(3, 64, 1), (64, 128, 2), (128, 256, 1), (256, 512, 2), (512, 512, 1)]
        for i, (cin, cout, stride) in enumerate(widths, start=1):
            setattr(self, f"layer{i}", nn.Sequential(
                nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)))
        self.head_0 = SPADEResnetBlock(512, 512)
        self.G_middle_0 = SPADEResnetBlock(512, 512)
        self.G_middle_1 = SPADEResnetBlock(512, 256)

    def forward(self, img):
        x = instance_norm(self.layer1(img))
        for i in range(2, 6):
            x = instance_norm(getattr(self, f"layer{i}")(_lrelu(x)))
        x = self.head_0(x, img)
        x = self.G_middle_0(x, img)
        return self.G_middle_1(x, img)


class Referencer(nn.Module):
    def __init__(self):
        super().__init__()
        self.FPN = BlenderFPN()
        self.trainable_tao = nn.Parameter(torch.ones(1))

    def init_rules(self):
        return {"trainable_tao": ("const", 1.0)}


class UNetInputLayer(nn.Module):
    """res_u_net.py:7-27: conv-bn-relu-conv plus a 1x1 squeeze residual."""

    def __init__(self, fin: int, fout: int):
        super().__init__()
        self.conv1 = nn.Conv2d(fin, fout, 3, padding=1)
        self.bn1 = FrozenBatchNorm(fout)
        self.conv2 = nn.Conv2d(fout, fout, 3, padding=1)
        self.sqz_layer = nn.Conv2d(fin, fout, 1)

    def forward(self, x):
        h = self.conv2(F.relu(self.bn1(self.conv1(x))))
        return h + self.sqz_layer(x)


class UNetResBlock(nn.Module):
    """res_u_net.py:30-57: pre-activation resblock with a 1x1 squeeze."""

    def __init__(self, fin: int, fout: int, stride: int = 1):
        super().__init__()
        self.bn1 = FrozenBatchNorm(fin)
        self.conv1 = nn.Conv2d(fin, fout, 3, stride=stride, padding=1)
        self.bn2 = FrozenBatchNorm(fout)
        self.conv2 = nn.Conv2d(fout, fout, 3, padding=1)
        self.sqz_layer = nn.Conv2d(fin, fout, 1, stride=stride)

    def forward(self, x):
        h = self.conv1(F.relu(self.bn1(x)))
        h = self.conv2(F.relu(self.bn2(h)))
        return h + self.sqz_layer(x)


class BlenderResUNet(nn.Module):
    """res_u_net.py:60-108, the full variant: 12 package channels -> RGB."""

    def __init__(self):
        super().__init__()
        self.input_encoder_layer = UNetInputLayer(12, 64)
        self.res_en_layer2 = UNetResBlock(64, 128, 2)
        self.res_en_layer3 = UNetResBlock(128, 256, 2)
        self.res_bridge_layer = UNetResBlock(256, 512, 2)
        self.res_de_layer3 = UNetResBlock(512 + 256, 256)
        self.res_de_layer2 = UNetResBlock(256 + 128, 128)
        self.res_de_layer1 = UNetResBlock(128 + 64, 64)
        self.output_decoder_layer = nn.Sequential(nn.Conv2d(64, 3, 1))

    def forward(self, pkgs):
        def up2(v):
            return resize_bilinear(v, (2 * v.shape[2], 2 * v.shape[3]), align_corners=True)

        e1 = self.input_encoder_layer(pkgs)
        e2 = self.res_en_layer2(e1)
        e3 = self.res_en_layer3(e2)
        bridge = self.res_bridge_layer(e3)
        d3 = self.res_de_layer3(torch.cat([up2(bridge), e3], 1))
        d2 = self.res_de_layer2(torch.cat([up2(d3), e2], 1))
        d1 = self.res_de_layer1(torch.cat([up2(d2), e1], 1))
        return torch.sigmoid(self.output_decoder_layer(d1))


def part_masks_19(mask19: torch.Tensor) -> dict[str, torch.Tensor]:
    """(B, H, W) 19-class labels -> {part: (B, H, W) 0/1 float} plus the
    'head' union (semantic_tools.py:175-181)."""
    parts = {}
    for name, ids in PART_IDS.items():
        m = torch.zeros(mask19.shape, dtype=torch.float32, device=mask19.device)
        for i in ids:
            m = m + (mask19 == i).float()
        parts[name] = torch.clamp(m, 0, 1)
    parts["head"] = torch.clamp(sum(parts.values()), 0, 1)
    return parts


def _masked_part_attention(feat_a, feat_t, rgb_t, m_a, m_t, tao):
    """Dense masked attention for one part, batched. feat_a / feat_t:
    (B, N, C) channel-centred features; rgb_t: (B, N, 3); m_a / m_t: (B, N)
    0/1. Returns (B, N, 3): T's part colours attended by A's part pixels,
    zero outside A's part and where T has no such part."""
    eps = 1e-8
    na = feat_a / torch.clamp(torch.linalg.vector_norm(feat_a, dim=-1, keepdim=True), min=eps)
    nt = feat_t / torch.clamp(torch.linalg.vector_norm(feat_t, dim=-1, keepdim=True), min=eps)
    logits = torch.matmul(na, nt.transpose(1, 2)) * tao
    logits = logits + torch.where(m_t[:, None, :] > 0, 0.0, -1e9)
    color = torch.matmul(torch.softmax(logits, dim=-1), rgb_t)
    has_t = (m_t.sum(dim=1) > 0)[:, None, None]
    return torch.where(has_t, color * m_a[..., None], 0.0)


class Blender(nn.Module):
    """Recolor the swapped face A with the target T's colours.

    img_a / img_t: (B, 3, 256, 256) ImageNet-normalised; mask_a / mask_t:
    (B, 256, 256) 19-class labels. Returns (RGB (B, 3, 256, 256) in [0, 1],
    the 12 package channels)."""

    def __init__(self):
        super().__init__()
        self.referencer = Referencer()
        self.unet = BlenderResUNet()

    def forward(self, img_a, img_t, mask_a, mask_t):
        b = img_a.shape[0]
        feats = self.referencer.FPN(torch.cat([img_a, img_t]))  # instance norm: per sample
        feats_a, feats_t = feats[:b], feats[b:]
        tao = self.referencer.trainable_tao.reshape(())
        parts_a, parts_t = part_masks_19(mask_a), part_masks_19(mask_t)
        mean, std = _col(_MEAN, img_a), _col(_STD, img_a)
        rgb_a = torch.clamp(img_a * std + mean, 0, 1)
        gray_a = torch.clamp((rgb_a * _col(_GRAY, img_a)).sum(1), 0, 1) * parts_a["head"]

        k = int(mask_a.shape[-1] * 0.1 / 2) * 2 + 1

        def dilate(m):
            return dilation_planar(m[:, None], k)[:, 0]

        inpaint_t = torch.clamp(dilate(parts_t["head"]) - parts_t["head"], 0, 1)
        e_at = dilate(torch.clamp(parts_a["head"] + parts_t["head"], 0, 1))
        inpaint_a = torch.clamp(e_at - parts_a["head"], 0, 1)
        img_bg = torch.clamp(img_t * std + mean, 0, 1) * (1 - e_at[:, None])
        parts_a = {**parts_a, "inpainting": inpaint_a}
        parts_t = {**parts_t, "inpainting": inpaint_t}

        s64 = feats_a.shape[-1]
        n = s64 * s64
        rgb_t64 = torch.clamp(resize_nearest(img_t, (s64, s64)) * std + mean, 0, 1)
        rgb_t64 = rgb_t64.reshape(b, 3, n).transpose(1, 2)
        fa_all = feats_a.reshape(b, -1, n).transpose(1, 2)
        ft_all = feats_t.reshape(b, -1, n).transpose(1, 2)
        head_ref = torch.zeros(b, n, 3, device=img_a.device)
        inpaint_ref = head_ref
        for name in list(PART_IDS) + ["inpainting"]:
            m_a = resize_nearest(parts_a[name], (s64, s64)).reshape(b, n)
            m_t = resize_nearest(parts_t[name], (s64, s64)).reshape(b, n)
            # as the reference (semantic_tools.py:105): T's features are
            # multiplied by A's mask
            fa = fa_all * m_a[..., None]
            ft = ft_all * m_a[..., None]
            fa = fa - fa.mean(dim=-1, keepdim=True)
            ft = ft - ft.mean(dim=-1, keepdim=True)
            ref = _masked_part_attention(fa, ft, rgb_t64, m_a, m_t, tao)
            if name == "inpainting":
                inpaint_ref = ref
            else:
                head_ref = head_ref + ref

        refs = torch.cat([head_ref, inpaint_ref], -1).transpose(1, 2).reshape(b, 6, s64, s64)
        size = img_a.shape[-1]
        refs = resize_bilinear(refs, (size, size), align_corners=True)
        packages = torch.cat([refs, parts_a["head"][:, None], inpaint_a[:, None],
                              gray_a[:, None], img_bg], dim=1)
        return self.unet(packages), packages


def recolor(net: Blender, img_a255, img_t255, mask_a19, mask_t19, size: int = 256):
    """img_a255 / img_t255: (B, H, W, 3) in [0, 255]; mask_a19 / mask_t19:
    (B, Hm, Wm) 19-class labels. Returns (B, 256, 256, 3) float32 in
    [0, 255]."""
    def prep(img255):
        img = img255.float().permute(0, 3, 1, 2) / 255.0
        img = resize_bilinear(img, (size, size))
        return ((img - _col(_MEAN, img)) / _col(_STD, img)).contiguous()

    out = net(prep(img_a255), prep(img_t255), resize_nearest(mask_a19, (size, size)),
              resize_nearest(mask_t19, (size, size)))[0]
    return torch.clamp(out * 255.0, 0, 255).permute(0, 2, 3, 1)
