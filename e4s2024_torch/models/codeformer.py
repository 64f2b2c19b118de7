"""CodeFormer face restoration: a VQGAN at 512^2 whose 16^2 codes a
transformer predicts from the low-quality face's features, with the
encoder's features fused into the decoder at fidelity weight w (reference
swap_face_fine/archs/codeformer_arch.py:161, vqgan_arch.py; the
alternative enhancer, inference_codeformer.py).

Counterpart of `e4s2024_tpu/models/codeformer.py` in NCHW, with the
reference's state-dict names (`encoder.blocks.{i}`, `generator.blocks.{i}`,
`quantize.embedding`, `position_emb`, `feat_emb`, `ft_layers.{n}` with
`self_attn.in_proj_*`, `idx_pred_layer.{0,1}`, `fuse_convs_dict.{size}`).
The block plans and the fuse taps are the reference's (module functions
and tables, read when a net is built). Plain
cuDNN convolutions and `torch.matmul`: the JAX package runs no Pallas
kernel here.
"""

from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from e4s2024_torch import resolve_device
from e4s2024_torch.convert import as_tensors, strip_module_prefix, unwrap_envelope
from e4s2024_torch.models.gpen import restore_aligned
from e4s2024_torch.ops.resize import resize_nearest

# torch block indices of the fuse taps in the 512 plan (codeformer_arch.py:196-199)
FUSE_ENCODER_BLOCK = {512: 2, 256: 5, 128: 8, 64: 11, 32: 14, 16: 18}
FUSE_GENERATOR_BLOCK = {16: 6, 32: 9, 64: 12, 128: 15, 256: 18, 512: 21}
_CH_MULT = (1, 2, 2, 4, 4, 8)


def encoder_plan(nf=64, ch_mult=_CH_MULT, num_res=2, resolution=512, attn_res=(16,),
                 emb_dim=256):
    """(kind, in, out) per block, in vqgan_arch.py's Encoder order."""
    plan, curr, in_ch = [("conv", 3, nf)], resolution, nf
    for i, m in enumerate(ch_mult):
        out_ch = nf * m
        for _ in range(num_res):
            plan.append(("res", in_ch, out_ch))
            in_ch = out_ch
            if curr in attn_res:
                plan.append(("attn", in_ch, in_ch))
        if i != len(ch_mult) - 1:
            plan.append(("down", in_ch, in_ch))
            curr //= 2
    return plan + [("res", in_ch, in_ch), ("attn", in_ch, in_ch), ("res", in_ch, in_ch),
                   ("norm", in_ch, in_ch), ("conv", in_ch, emb_dim)]


def generator_plan(nf=64, ch_mult=_CH_MULT, num_res=2, resolution=512, attn_res=(16,),
                   emb_dim=256):
    """(kind, in, out) per block, in vqgan_arch.py's Generator order."""
    in_ch = nf * ch_mult[-1]
    curr = resolution // 2 ** (len(ch_mult) - 1)
    plan = [("conv", emb_dim, in_ch), ("res", in_ch, in_ch), ("attn", in_ch, in_ch),
            ("res", in_ch, in_ch)]
    for i in reversed(range(len(ch_mult))):
        out_ch = nf * ch_mult[i]
        for _ in range(num_res):
            plan.append(("res", in_ch, out_ch))
            in_ch = out_ch
            if curr in attn_res:
                plan.append(("attn", in_ch, in_ch))
        if i != 0:
            plan.append(("up", in_ch, in_ch))
            curr *= 2
    return plan + [("norm", in_ch, in_ch), ("conv", in_ch, 3)]


def _norm(c: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, c, eps=1e-6)


class VQResBlock(nn.Module):
    def __init__(self, fin: int, fout: int):
        super().__init__()
        self.norm1, self.conv1 = _norm(fin), nn.Conv2d(fin, fout, 3, padding=1)
        self.norm2, self.conv2 = _norm(fout), nn.Conv2d(fout, fout, 3, padding=1)
        if fin != fout:
            self.conv_out = nn.Conv2d(fin, fout, 1)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        return (self.conv_out(x) if hasattr(self, "conv_out") else x) + h


class VQAttnBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.norm = _norm(c)
        self.q, self.k, self.v, self.proj_out = (nn.Conv2d(c, c, 1) for _ in range(4))

    def forward(self, x):
        b, c, h, w = x.shape
        hn = self.norm(x)
        q, k, v = (m(hn).reshape(b, c, h * w) for m in (self.q, self.k, self.v))
        att = torch.softmax(torch.matmul(q.transpose(1, 2), k) * c ** -0.5, dim=-1)
        out = torch.matmul(v, att.transpose(1, 2)).reshape(b, c, h, w)
        return x + self.proj_out(out)


class VQDownsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class VQUpsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv(resize_nearest(x, (2 * x.shape[2], 2 * x.shape[3])))


class VQBlocks(nn.Module):
    """The reference's indexed block list (`blocks.{i}`)."""

    def __init__(self, plan):
        super().__init__()
        make = {"conv": lambda i, o: nn.Conv2d(i, o, 3, padding=1), "res": VQResBlock,
                "attn": lambda i, o: VQAttnBlock(i), "down": lambda i, o: VQDownsample(i),
                "up": lambda i, o: VQUpsample(i), "norm": lambda i, o: _norm(i)}
        self.blocks = nn.ModuleList([make[kind](i, o) for kind, i, o in plan])

    def forward(self, x, taps=(), fuse=None):
        """All blocks in order (no activation between the final norm and
        conv, vqgan_arch.py:265-266); the outputs at `taps`, and fuse[i]
        applied after block i."""
        tapped = {}
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i in taps:
                tapped[i] = x
            if fuse and i in fuse:
                x = fuse[i](x)
        return x, tapped


class _SelfAttention(nn.Module):
    """torch MultiheadAttention's parameters (`in_proj_weight`,
    `in_proj_bias`, `out_proj`); q and k from one input, v from another."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, qk, v):
        b, t, c = v.shape
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        hd = c // self.heads

        def split(z):
            return z.reshape(b, t, self.heads, hd).transpose(1, 2)

        q, k = split(F.linear(qk, wq, bq)), split(F.linear(qk, wk, bk))
        att = torch.softmax(torch.matmul(q, k.transpose(2, 3)) / math.sqrt(hd), dim=-1)
        out = torch.matmul(att, split(F.linear(v, wv, bv)))
        return self.out_proj(out.transpose(1, 2).reshape(b, t, c))


class TransformerLayer(nn.Module):
    """Pre-LN self-attention layer (codeformer_arch.py:99): q and k from the
    position-embedded normed tokens, v from the normed tokens."""

    def __init__(self, dim: int = 512, heads: int = 8, dim_mlp: int = 1024):
        super().__init__()
        self.self_attn = _SelfAttention(dim, heads)
        self.linear1, self.linear2 = nn.Linear(dim, dim_mlp), nn.Linear(dim_mlp, dim)
        self.norm1, self.norm2 = nn.LayerNorm(dim), nn.LayerNorm(dim)

    def forward(self, x, pos):
        h = self.norm1(x)
        x = x + self.self_attn(h + pos, h)
        return x + self.linear2(F.gelu(self.linear1(self.norm2(x))))


class FuseSFT(nn.Module):
    """Fuse_sft_block (codeformer_arch.py:136): dec + w * (dec * scale + shift)."""

    def __init__(self, c: int):
        super().__init__()
        self.encode_enc = VQResBlock(2 * c, c)
        for name in ("scale", "shift"):
            setattr(self, name, nn.Sequential(nn.Conv2d(c, c, 3, padding=1),
                                              nn.LeakyReLU(0.2), nn.Conv2d(c, c, 3, padding=1)))

    def forward(self, enc_feat, dec_feat, w: float):
        h = self.encode_enc(torch.cat([enc_feat, dec_feat], 1))
        return dec_feat + w * (dec_feat * self.scale(h) + self.shift(h))


class CodeFormer(nn.Module):
    """(B, 3, R, R) in [-1, 1] -> (image, logits (B, T, codebook), lq_feat)."""

    def __init__(self, dim_embd: int = 512, n_head: int = 8, n_layers: int = 9,
                 codebook_size: int = 1024, latent_size: int = 256,
                 connect_list=(32, 64, 128, 256)):
        super().__init__()
        enc_plan = encoder_plan()
        self.encoder = VQBlocks(enc_plan)
        self.generator = VQBlocks(generator_plan())
        self.quantize = nn.Module()
        self.quantize.embedding = nn.Embedding(codebook_size, 256)
        self.position_emb = nn.Parameter(torch.zeros(latent_size, dim_embd))
        self.feat_emb = nn.Linear(256, dim_embd)
        self.ft_layers = nn.ModuleList([TransformerLayer(dim_embd, n_head, 2 * dim_embd)
                                        for _ in range(n_layers)])
        self.idx_pred_layer = nn.Sequential(nn.LayerNorm(dim_embd),
                                            nn.Linear(dim_embd, codebook_size, bias=False))
        self.connect_list = tuple(connect_list)
        self.fuse_encoder_block = dict(FUSE_ENCODER_BLOCK)
        self.fuse_generator_block = dict(FUSE_GENERATOR_BLOCK)
        self.fuse_convs_dict = nn.ModuleDict({
            str(s): FuseSFT(enc_plan[self.fuse_encoder_block[s]][2]) for s in self.connect_list})

    def forward(self, x, w: float = 0.0):
        b = x.shape[0]
        taps = {self.fuse_encoder_block[s]: s for s in self.connect_list}
        lq_feat, tapped = self.encoder(x, taps=tuple(taps))
        enc = {taps[i]: f for i, f in tapped.items()}
        q = self.feat_emb(lq_feat.flatten(2).transpose(1, 2))
        for layer in self.ft_layers:
            q = layer(q, self.position_emb[None])
        logits = self.idx_pred_layer(q)
        side = int(math.isqrt(q.shape[1]))
        quant = self.quantize.embedding.weight[logits.argmax(-1)]  # (B, T, 256)
        quant = quant.transpose(1, 2).reshape(b, -1, side, side)
        # with w == 0 the fuse residual is exactly zero, as the reference's skip
        fuse = {self.fuse_generator_block[s]: (lambda dec, s=s: self.fuse_convs_dict[str(s)](
            enc[s], dec, w)) for s in self.connect_list}
        out, _ = self.generator(quant, fuse=fuse)
        return out, logits, lq_feat


def codeformer_state_dict(state_dict: Mapping) -> dict[str, torch.Tensor]:
    """A CodeFormer state dict (reference file, whose weights sit in a
    `params_ema` envelope, or `convert.codeformer_state_dict_from_jax`) for
    a strict load."""
    sd = strip_module_prefix(unwrap_envelope(state_dict, "params_ema", "params"))
    return as_tensors(sd)


class CodeFormerEnhancer:
    """Aligned-crop restoration (the reference's CodeFormerInfer) at
    fidelity weight w: (B, H, W, 3) in [0, 255] in, the same shape out,
    float32; crops of another size are resized to 512 and back with
    `ops/resize.py`. It has no `fused_form` (`models/gpen.py::GPENEnhancer`):
    the JAX pipeline's one-program path reads a `_packed` attribute that
    JAX's CodeFormerEnhancer lacks, so JAX computes a CodeFormer swap only
    on its staged path, where the swap truncates the enhanced crop."""

    size = 512

    def __init__(self, state_dict: Mapping, w: float = 0.5, *, device=None, **arch):
        self.device = resolve_device(device)
        self.w = w
        self.model = CodeFormer(**arch)
        self.model.load_state_dict(codeformer_state_dict(state_dict), strict=True)
        self.model.to(self.device).eval().requires_grad_(False)

    def enhance_aligned(self, img255) -> torch.Tensor:
        return restore_aligned(self.model, img255, self.size, self.device, self.w)
