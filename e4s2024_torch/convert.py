"""JAX-package parameters -> port state dicts.

The inverse of the layout rules of the JAX package's checkpoint converter
(`e4s2024_tpu/convert/torch_loader.py`):

  flax kernel (in, out)       -> torch Linear (out, in)
  flax kernel HWIO            -> torch Conv2d OIHW
  ModulatedConv (kh, kw, I, O) -> (1, O, I, kh, kw)
  ToRGB bias (1, 1, 1, 3)     -> (1, 3, 1, 1)
  const input (1, 4, 4, C)    -> (1, C, 4, 4)
  LayerNorm scale, bias       -> weight, bias

The `*_from_jax` functions take nested dicts of numpy (or array-like)
leaves and return flat {reference name: torch.Tensor} dicts that the port's
modules load with `load_state_dict(strict=True)`.

Reference checkpoints themselves load natively: `load_reference_checkpoint`
reads a torch file into such a dict, `drop_generator_buffers` takes out the
fixed buffers a reference generator carries and the port keeps as
constants, and `fold_bgr_mean_into_stem` gives a RetinaFace checkpoint the
RGB input the JAX package's converter gives it.
"""

from __future__ import annotations

from typing import Mapping

import re

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _linear(p: Mapping, name: str, out: dict) -> None:
    out[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        out[f"{name}.bias"] = _t(p["bias"])


def _conv(p: Mapping, name: str, out: dict, key: str = "kernel") -> None:
    out[f"{name}.weight"] = _t(np.asarray(p[key]).transpose(3, 2, 0, 1))
    if "bias" in p:
        out[f"{name}.bias"] = _t(p["bias"])


def _modconv(p: Mapping, name: str, out: dict) -> None:
    out[f"{name}.weight"] = _t(np.asarray(p["weight"]).transpose(3, 2, 0, 1)[None])
    _linear(p["modulation"], f"{name}.modulation", out)


def _styled_conv(p: Mapping, name: str, out: dict) -> None:
    _modconv(p["conv"], f"{name}.conv", out)
    out[f"{name}.noise.weight"] = _t(p["noise_weight"])
    out[f"{name}.activate.bias"] = _t(p["act_bias"])


def _to_rgb(p: Mapping, name: str, out: dict) -> None:
    _modconv(p["conv"], f"{name}.conv", out)
    out[f"{name}.bias"] = _t(np.asarray(p["bias"]).transpose(0, 3, 1, 2))


def _count(p: Mapping, stem: str) -> int:
    n = 0
    while f"{stem}{n}" in p:
        n += 1
    return n


def _generator(p: Mapping, prefix: str, out: dict) -> None:
    out[f"{prefix}input.input"] = _t(np.asarray(p["input"]).transpose(0, 3, 1, 2))
    i = 1
    while f"style_{i}" in p:
        _linear(p[f"style_{i}"], f"{prefix}style.{i}", out)
        i += 1
    _styled_conv(p["conv1"], f"{prefix}conv1", out)
    _to_rgb(p["to_rgb1"], f"{prefix}to_rgb1", out)
    for i in range(_count(p, "convs_")):
        _styled_conv(p[f"convs_{i}"], f"{prefix}convs.{i}", out)
    for i in range(_count(p, "to_rgbs_")):
        _to_rgb(p[f"to_rgbs_{i}"], f"{prefix}to_rgbs.{i}", out)


def _encoder(p: Mapping, prefix: str, out: dict) -> None:
    _conv(p["input_conv"], f"{prefix}input_layer.0", out)
    out[f"{prefix}input_layer.2.weight"] = _t(p["input_prelu"]["alpha"])
    for i in range(_count(p, "body_")):
        u, name = p[f"body_{i}"], f"{prefix}body.{i}"
        _conv(u["conv1"], f"{name}.res_layer.1", out)
        out[f"{name}.res_layer.2.weight"] = _t(u["prelu"]["alpha"])
        _conv(u["conv2"], f"{name}.res_layer.3", out)
        _conv(u["se"]["fc1"], f"{name}.res_layer.5.fc1", out)
        _conv(u["se"]["fc2"], f"{name}.res_layer.5.fc2", out)
        if "shortcut_conv" in u:
            _conv(u["shortcut_conv"], f"{name}.shortcut_layer.0", out)


def generator_state_dict_from_jax(params: Mapping, prefix: str = "") -> dict[str, torch.Tensor]:
    """Generator params -> port Generator state dict."""
    out: dict[str, torch.Tensor] = {}
    _generator(params, prefix, out)
    return out


def encoder_state_dict_from_jax(params: Mapping, prefix: str = "") -> dict[str, torch.Tensor]:
    """FSEncoderPSP params -> port FSEncoderPSP state dict."""
    out: dict[str, torch.Tensor] = {}
    _encoder(params, prefix, out)
    return out


def rgi_state_dict_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """RGINet `{"params", "buffers"}` -> port RGINet state dict (`encoder.*`,
    `G.*`, `MLPs.*`, `latent_avg`)."""
    p = variables["params"]
    out = encoder_state_dict_from_jax(p["encoder"], "encoder.")
    out.update(generator_state_dict_from_jax(p["generator"], "G."))
    for i in range(_count(p, "mlp_")):
        _linear(p[f"mlp_{i}"]["fc1"], f"MLPs.{i}.mlp.0", out)
        _linear(p[f"mlp_{i}"]["fc2"], f"MLPs.{i}.mlp.2", out)
    out["latent_avg"] = _t(variables["buffers"]["latent_avg"])
    return out


def _bn(p: Mapping, name: str, out: dict) -> None:
    out[f"{name}.running_mean"] = _t(p["mean"])
    out[f"{name}.running_var"] = _t(p["var"])
    out[f"{name}.weight"] = _t(p["scale"])
    out[f"{name}.bias"] = _t(p["bias"])


def _convbnrelu(p: Mapping, name: str, out: dict) -> None:
    _conv(p["conv"], f"{name}.conv", out)
    _bn(p["bn"], f"{name}.bn", out)


def bisenet_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """BiSeNet params -> port BiSeNet state dict (`cp.resnet.*`, `cp.arm*`,
    `cp.conv_*`, `ffm.*`, `conv_out*`)."""
    out: dict[str, torch.Tensor] = {}
    r = params["resnet"]
    _conv(r["conv1"], "cp.resnet.conv1", out)
    _bn(r["bn1"], "cp.resnet.bn1", out)
    for layer in range(1, 5):
        for blk in range(2):
            b, name = r[f"layer{layer}_{blk}"], f"cp.resnet.layer{layer}.{blk}"
            _conv(b["conv1"], f"{name}.conv1", out)
            _bn(b["bn1"], f"{name}.bn1", out)
            _conv(b["conv2"], f"{name}.conv2", out)
            _bn(b["bn2"], f"{name}.bn2", out)
            if "down_conv" in b:
                _conv(b["down_conv"], f"{name}.downsample.0", out)
                _bn(b["down_bn"], f"{name}.downsample.1", out)
    for arm in ("arm16", "arm32"):
        _convbnrelu(params[arm]["conv"], f"cp.{arm}.conv", out)
        _conv(params[arm]["conv_atten"], f"cp.{arm}.conv_atten", out)
        _bn(params[arm]["bn_atten"], f"cp.{arm}.bn_atten", out)
    for head in ("conv_head32", "conv_head16", "conv_avg"):
        _convbnrelu(params[head], f"cp.{head}", out)
    _convbnrelu(params["ffm"]["convblk"], "ffm.convblk", out)
    _conv(params["ffm"]["conv1"], "ffm.conv1", out)
    _conv(params["ffm"]["conv2"], "ffm.conv2", out)
    for head in ("conv_out", "conv_out16", "conv_out32"):
        _convbnrelu(params[head]["conv"], f"{head}.conv", out)
        _conv(params[head]["conv_out"], f"{head}.conv_out", out)
    return out


def arcface_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """ArcFaceBackbone params -> port ArcFaceBackbone state dict in the
    reference's names (the inverse of the layout of `convert_arcface`)."""
    out: dict[str, torch.Tensor] = {}
    _conv(params["input_conv"], "input_layer.0", out)
    _bn(params["input_bn"], "input_layer.1", out)
    out["input_layer.2.weight"] = _t(params["input_prelu"]["alpha"])
    for i in range(_count(params, "body_")):
        u, name = params[f"body_{i}"], f"body.{i}"
        _bn(u["bn0"], f"{name}.res_layer.0", out)
        _conv(u["conv1"], f"{name}.res_layer.1", out)
        out[f"{name}.res_layer.2.weight"] = _t(u["prelu"]["alpha"])
        _conv(u["conv2"], f"{name}.res_layer.3", out)
        _bn(u["bn2"], f"{name}.res_layer.4", out)
        _conv(u["se"]["fc1"], f"{name}.res_layer.5.fc1", out)
        _conv(u["se"]["fc2"], f"{name}.res_layer.5.fc2", out)
        if "shortcut_conv" in u:
            _conv(u["shortcut_conv"], f"{name}.shortcut_layer.0", out)
            _bn(u["shortcut_bn"], f"{name}.shortcut_layer.1", out)
    _bn(params["output_bn"], "output_layer.0", out)
    out["output_layer.3.weight"] = _t(np.asarray(params["output_fc_kernel"]).T)
    out["output_layer.3.bias"] = _t(params["output_fc_bias"])
    _bn(params["output_bn1d"], "output_layer.4", out)
    return out


def lpips_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """LPIPS params -> port LPIPS state dict (`features.{0,3,6,8,10}`,
    `lin{i}.model.1.weight`; the inverse of the layout of `convert_lpips`)."""
    out: dict[str, torch.Tensor] = {}
    for idx in (0, 3, 6, 8, 10):
        _conv(params["net"][f"conv{idx}"], f"features.{idx}", out)
    for i in range(_count(params, "lin_")):
        out[f"lin{i}.model.1.weight"] = _t(np.asarray(params[f"lin_{i}"]).reshape(1, -1, 1, 1))
    return out


def _unet_conv2(p: Mapping, name: str, out: dict) -> None:
    for j in (1, 2):
        _conv(p[f"conv{j}"], f"{name}.conv{j}.0", out)
        _bn(p[f"bn{j}"], f"{name}.conv{j}.1", out)


def parsing_unet_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """ParsingUNet params -> port ParsingUNet state dict (the inverse of the
    layout of `convert_parsing_unet`: the flax transposed-convolution
    kernels flipped back into torch's (in, out, kh, kw))."""
    out: dict[str, torch.Tensor] = {}
    for blk in ("conv1", "conv2", "conv3", "conv4", "center"):
        _unet_conv2(params[blk], blk, out)
    for blk in ("up_concat4", "up_concat3", "up_concat2", "up_concat1"):
        up = params[blk]["up"]
        out[f"{blk}.up.weight"] = _t(np.asarray(up["kernel"])[::-1, ::-1].transpose(2, 3, 0, 1))
        out[f"{blk}.up.bias"] = _t(up["bias"])
        _unet_conv2(params[blk]["conv"], f"{blk}.conv", out)
    _conv(params["final"], "final", out)
    return out


def _layernorm(p: Mapping, name: str, out: dict) -> None:
    out[f"{name}.weight"] = _t(p["scale"])
    out[f"{name}.bias"] = _t(p["bias"])


def swin_block_state_dict_from_jax(params: Mapping, prefix: str = "") -> dict[str, torch.Tensor]:
    """SwinBlock params -> port SwinBlock state dict (`norm1`, `attn.*`,
    `norm2`, `mlp.fc1`, `mlp.fc2`)."""
    out: dict[str, torch.Tensor] = {}
    _layernorm(params["norm1"], f"{prefix}norm1", out)
    _layernorm(params["norm2"], f"{prefix}norm2", out)
    out[f"{prefix}attn.relative_position_bias_table"] = _t(params["attn"]["rel_bias_table"])
    _linear(params["attn"]["qkv"], f"{prefix}attn.qkv", out)
    _linear(params["attn"]["proj"], f"{prefix}attn.proj", out)
    _linear(params["fc1"], f"{prefix}mlp.fc1", out)
    _linear(params["fc2"], f"{prefix}mlp.fc2", out)
    return out


def swinir_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """SwinIR params -> port SwinIR state dict in the reference's names
    (`conv_first`, `patch_embed.norm`, `layers.{i}.residual_group.blocks.{j}.*`,
    `layers.{i}.conv`, `norm`, `conv_after_body`, `conv_before_upsample.0`,
    `conv_up1`, `conv_up2`, `conv_hr`, `conv_last`)."""
    out: dict[str, torch.Tensor] = {}
    _conv(params["conv_first"], "conv_first", out)
    _layernorm(params["patch_norm"], "patch_embed.norm", out)
    for i in range(_count(params, "layers_")):
        lp, name = params[f"layers_{i}"], f"layers.{i}"
        for j in range(_count(lp, "blocks_")):
            out.update(swin_block_state_dict_from_jax(
                lp[f"blocks_{j}"], f"{name}.residual_group.blocks.{j}."))
        _conv(lp["conv"], f"{name}.conv", out)
    _layernorm(params["norm"], "norm", out)
    _conv(params["conv_after_body"], "conv_after_body", out)
    _conv(params["conv_before_upsample"], "conv_before_upsample.0", out)
    for name in ("conv_up1", "conv_up2", "conv_hr", "conv_last"):
        _conv(params[name], name, out)
    return out


def _conv_bn_seq(p: Mapping, name: str, out: dict, conv_idx: int = 0, bn_idx: int = 1) -> None:
    _conv(p["conv"], f"{name}.{conv_idx}", out)
    _bn(p["bn"], f"{name}.{bn_idx}", out)


def retinaface_state_dict_from_jax(params: Mapping, cfg: Mapping) -> dict[str, torch.Tensor]:
    """RetinaFace params -> port RetinaFace state dict in the reference's
    names (the inverse of the layout of `convert_retinaface`; the stem
    stays as the params hold it, folded for RGB input)."""
    out: dict[str, torch.Tensor] = {}
    body = params["body"]
    if cfg["backbone"] == "mobilenet":
        _conv_bn_seq(body["stem"], "body.stage1.0", out)
        names = ([f"s1_{i}" for i in range(5)], [f"s2_{i}" for i in range(6)],
                 [f"s3_{i}" for i in range(2)])
        for stage, (first, keys) in enumerate(zip((1, 0, 0), names), start=1):
            for i, key in enumerate(keys):
                name = f"body.stage{stage}.{i + first}"
                _conv_bn_seq(body[key]["dw"], name, out)
                _conv_bn_seq(body[key]["pw"], name, out, 3, 4)
    else:
        _conv(body["conv1"], "body.conv1", out)
        _bn(body["bn1"], "body.bn1", out)
        for li, n in enumerate((3, 4, 6, 3)):
            for bi in range(n):
                blk, name = body[f"layer{li + 1}_{bi}"], f"body.layer{li + 1}.{bi}"
                for j in (1, 2, 3):
                    _conv(blk[f"conv{j}"], f"{name}.conv{j}", out)
                    _bn(blk[f"bn{j}"], f"{name}.bn{j}", out)
                if "down_conv" in blk:
                    _conv(blk["down_conv"], f"{name}.downsample.0", out)
                    _bn(blk["down_bn"], f"{name}.downsample.1", out)
    for key in ("output1", "output2", "output3", "merge1", "merge2"):
        _conv_bn_seq(params["fpn"][key], f"fpn.{key}", out)
    for i in range(1, 4):
        for key, ref in (("conv3x3", "conv3X3"), ("conv5x5_1", "conv5X5_1"),
                         ("conv5x5_2", "conv5X5_2"), ("conv7x7_2", "conv7X7_2"),
                         ("conv7x7_3", "conv7x7_3")):
            _conv_bn_seq(params[f"ssh{i}"][key], f"ssh{i}.{ref}", out)
    for i in range(3):
        _conv(params[f"class_head{i}"], f"ClassHead.{i}.conv1x1", out)
        _conv(params[f"bbox_head{i}"], f"BboxHead.{i}.conv1x1", out)
        _conv(params[f"landmark_head{i}"], f"LandmarkHead.{i}.conv1x1", out)
    return out


def _fan_convblock(p: Mapping, name: str, out: dict) -> None:
    for j in (1, 2, 3):
        _bn(p[f"bn{j}"], f"{name}.bn{j}", out)
        _conv(p[f"conv{j}"], f"{name}.conv{j}", out)
    if "down_conv" in p:
        _bn(p["down_bn"], f"{name}.downsample.0", out)
        _conv(p["down_conv"], f"{name}.downsample.2", out)


def fan_state_dict_from_jax(params: Mapping, num_modules: int = 4,
                            depth: int = 4) -> dict[str, torch.Tensor]:
    """FAN params -> port FAN state dict in face-alignment's names (the
    inverse of the layout of `convert_fan`)."""
    out: dict[str, torch.Tensor] = {}
    _conv(params["conv1"], "conv1", out)
    _bn(params["bn1"], "bn1", out)
    for key in ("conv2", "conv3", "conv4"):
        _fan_convblock(params[key], key, out)
    for i in range(num_modules):
        hg = params[f"m{i}"]
        for level in range(1, depth + 1):
            for b in ("b1", "b2", "b3"):
                _fan_convblock(hg[f"{b}_{level}"], f"m{i}.{b}_{level}", out)
        _fan_convblock(hg["b2_plus_1"], f"m{i}.b2_plus_1", out)
        _fan_convblock(params[f"top_m_{i}"], f"top_m_{i}", out)
        _conv(params[f"conv_last{i}"], f"conv_last{i}", out)
        _bn(params[f"bn_end{i}"], f"bn_end{i}", out)
        _conv(params[f"l{i}"], f"l{i}", out)
        if i < num_modules - 1:
            _conv(params[f"bl{i}"], f"bl{i}", out)
            _conv(params[f"al{i}"], f"al{i}", out)
    return out


def load_reference_checkpoint(path: str,
                              envelopes=("state_dict", "params_ema", "params")
                              ) -> dict[str, torch.Tensor]:
    """A reference torch checkpoint (.pt / .pth) as a flat {name: tensor}
    dict for `load_state_dict`: loaded with `weights_only=True`, the first
    envelope found unwrapped (tensors beside it, such as E4S's
    `latent_avg`, kept under their own names), DDP's `module.` prefix
    stripped, and BatchNorm's `num_batches_tracked` counters (which the
    port's frozen BNs do not keep) dropped."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    sd, extras = obj, {}
    for name in envelopes:
        if isinstance(obj, dict) and isinstance(obj.get(name), dict):
            sd = obj[name]
            extras = {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}
            break
    out = {}
    for k, v in list(sd.items()) + list(extras.items()):
        k = k[len("module."):] if k.startswith("module.") else k
        if isinstance(v, torch.Tensor) and not k.endswith("num_batches_tracked"):
            out.setdefault(k, v)
    return out


def fold_bgr_mean_into_stem(state_dict: Mapping, cfg: Mapping,
                            mean_bgr=(104.0, 117.0, 123.0)) -> dict[str, torch.Tensor]:
    """A reference RetinaFace state dict (trained on BGR minus
    (104, 117, 123), retinaface_detection.py:72-73) for RGB [0, 255] input,
    as the JAX package's converter makes it (`_fold_bgr_mean_into_stem`):
    the stem's input channels flipped and conv(W, mean) added to its BN's
    running mean. Inside the image this equals the reference; on the stem
    output's first rows and columns, where the reference's zero padding of
    (BGR - mean) differs from a zero padding of the raw image, it does not."""
    conv, bn = (("body.stage1.0.0", "body.stage1.0.1") if cfg["backbone"] == "mobilenet"
                else ("body.conv1", "body.bn1"))
    out = dict(state_dict)
    w = state_dict[f"{conv}.weight"]  # (O, I, kh, kw), I in BGR order
    shift = torch.einsum("oihw,i->o", w, torch.tensor(mean_bgr, dtype=w.dtype))
    out[f"{conv}.weight"] = w.flip(1).contiguous()
    out[f"{bn}.running_mean"] = state_dict[f"{bn}.running_mean"] + shift
    return out


_NOISE_KEY = re.compile(r"(^|\.)noises\.noise_\d+$")
_FIR_KEY = re.compile(r"\.(blur|upsample)\.kernel$")


def drop_generator_buffers(state_dict: Mapping) -> dict:
    """A reference E4S state dict without the generator's fixed buffers,
    which the port does not keep as state (`models/stylegan2.py`): the
    registered noise maps `*.noises.noise_*` (the port, like the JAX
    package, synthesises without noise) and the FIR `kernel` of every blur
    and upsample. Each dropped FIR kernel must equal the constant the port
    uses in its place, make_kernel([1, 3, 3, 1]) x 4 (both run at factor 2);
    a differing one raises. Every other key is kept, for a strict load."""
    from e4s2024_torch.models.stylegan2 import BLUR_TAPS
    from e4s2024_torch.ops.upfirdn import make_kernel

    fir = make_kernel(BLUR_TAPS) * 4
    out = {}
    for key, value in state_dict.items():
        if _NOISE_KEY.search(key):
            continue
        if _FIR_KEY.search(key):
            taps = torch.as_tensor(np.asarray(value) if not isinstance(value, torch.Tensor)
                                   else value).float().cpu()
            if taps.shape != fir.shape or not torch.allclose(taps, fir, rtol=0.0, atol=1e-7):
                raise ValueError(f"{key}: FIR taps {taps.tolist()} differ from the "
                                 f"generator's constant {fir.tolist()}")
            continue
        out[key] = value
    return out
