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
reads a torch file into such a dict, `drop_generator_buffers` and
`drop_fir_buffers` take out the fixed buffers a reference generator carries
and the port keeps as constants, `unwrap_envelope` opens basicsr's
`params_ema` envelope, `fold_spectral_norm` normalises spectral-norm
weights once, and `fold_bgr_mean_into_stem` gives a RetinaFace checkpoint
the RGB input the JAX package's converter gives it.
"""

from __future__ import annotations

from typing import Mapping

import re

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def as_tensors(state_dict: Mapping) -> dict[str, torch.Tensor]:
    """A state dict's values as tensors (numpy arrays converted, tensors
    kept), for `load_state_dict`."""
    return {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
            for k, v in state_dict.items()}


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


def drop_fir_buffers(state_dict: Mapping, fir_gains, noise=None) -> dict:
    """A reference state dict without the fixed buffers that the port keeps
    as constants: the keys matching the `noise` pattern (registered noise
    maps; the port, like the JAX package, runs without noise) and the FIR
    `kernel` buffers. `fir_gains` is a list of (pattern, gain): a key that
    matches a pattern is a FIR buffer that must equal the port's constant
    make_kernel([1, 3, 3, 1]) x gain; a differing one raises. Every other
    key is kept, for a strict load."""
    from e4s2024_torch.models.stylegan2 import BLUR_TAPS
    from e4s2024_torch.ops.upfirdn import make_kernel

    fir_gains = [(re.compile(p) if isinstance(p, str) else p, g) for p, g in fir_gains]
    noise = re.compile(noise) if isinstance(noise, str) else noise
    out = {}
    for key, value in state_dict.items():
        if noise is not None and noise.search(key):
            continue
        gain = next((g for pat, g in fir_gains if pat.search(key)), None)
        if gain is not None:
            fir = make_kernel(BLUR_TAPS) * gain
            taps = torch.as_tensor(np.asarray(value) if not isinstance(value, torch.Tensor)
                                   else value).float().cpu()
            if taps.shape != fir.shape or not torch.allclose(taps, fir, rtol=0.0, atol=1e-7):
                raise ValueError(f"{key}: FIR taps {taps.tolist()} differ from the "
                                 f"port's constant {fir.tolist()}")
            continue
        out[key] = value
    return out


def drop_generator_buffers(state_dict: Mapping) -> dict:
    """A reference E4S state dict without the generator's fixed buffers,
    which the port does not keep as state (`models/stylegan2.py`): the
    registered noise maps `*.noises.noise_*` and the FIR `kernel` of every
    blur and upsample, each of which must equal make_kernel([1, 3, 3, 1]) x 4
    (both run at factor 2; `drop_fir_buffers`)."""
    return drop_fir_buffers(state_dict, [(_FIR_KEY, 4.0)], _NOISE_KEY)


def unwrap_envelope(state_dict: Mapping, *names: str) -> dict:
    """The weights inside a checkpoint envelope ('params_ema', 'params'):
    the first name found, as a nested dict or as a key prefix; the dict
    unchanged when none is found (the JAX package's `unwrap_envelope`)."""
    for name in names:
        if isinstance(state_dict.get(name), Mapping):
            return dict(state_dict[name])
        p = name + "."
        if any(k.startswith(p) for k in state_dict):
            return {k[len(p):]: v for k, v in state_dict.items() if k.startswith(p)}
    return dict(state_dict)


def strip_module_prefix(state_dict: Mapping) -> dict:
    """Without DDP's 'module.' prefix."""
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in state_dict.items()}


def fold_spectral_norm(state_dict: Mapping) -> dict:
    """A state dict with every spectral-normalised weight replaced by its
    normalised value, computed once (the JAX converter's `_spectral_conv`):
    `X.weight_orig`, `X.weight_u` and `X.weight_v` become
    `X.weight = weight_orig / sigma` with sigma = u . (W_mat v), W_mat the
    weight flattened to (out, -1). The port keeps no spectral-norm hooks."""
    out = {}
    for key, value in state_dict.items():
        if key.endswith((".weight_u", ".weight_v")):
            continue
        if key.endswith(".weight_orig"):
            stem = key[: -len("_orig")]
            w = torch.as_tensor(np.asarray(value)) if not isinstance(value, torch.Tensor) else value
            u, v = (torch.as_tensor(np.asarray(state_dict[f"{stem}_{x}"])) for x in "uv")
            sigma = torch.dot(u.float(), w.float().reshape(w.shape[0], -1) @ v.float())
            out[stem] = (w.float() / sigma).to(w.dtype)
            continue
        out[key] = value
    return out


# ------------------------------------------------------------------ the zoo

def _convlayer(p: Mapping, name: str, out: dict, downsample: bool = False,
               activate: bool = True) -> None:
    """A ConvLayer Sequential: [Blur,] EqualConv2d [, FusedLeakyReLU]."""
    i = 1 if downsample else 0
    _conv(p["conv"], f"{name}.{i}", out, key="weight")
    if activate:
        out[f"{name}.{i + 1}.bias"] = _t(p["act_bias"])


def gpen_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """GPENFullGenerator params -> port GPENFullGenerator state dict in the
    reference's names (`ecd{i}.0.*`, `final_linear.0`, `generator.*`; the
    inverse of the layout of `convert_gpen`)."""
    out: dict[str, torch.Tensor] = {}
    _generator(params["generator"], "generator.", out)
    _linear(params["final_linear"], "final_linear.0", out)
    _convlayer(params["ecd_0"], "ecd0.0", out)
    for i in range(1, _count(params, "ecd_")):
        _convlayer(params[f"ecd_{i}"], f"ecd{i}.0", out, downsample=True)
    return out


def rrdbnet_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """RRDBNet params -> port RRDBNet state dict (`conv_first`,
    `body.{i}.rdb{r}.conv{c}`, `conv_body`, `conv_up1`, `conv_up2`,
    `conv_hr`, `conv_last`)."""
    out: dict[str, torch.Tensor] = {}
    for name in ("conv_first", "conv_body", "conv_up1", "conv_up2", "conv_hr", "conv_last"):
        _conv(params[name], name, out)
    for i in range(_count(params, "body_")):
        for r in (1, 2, 3):
            for c in range(1, 6):
                _conv(params[f"body_{i}"][f"rdb{r}"][f"conv{c}"], f"body.{i}.rdb{r}.conv{c}", out)
    return out


def _spade(p: Mapping, name: str, out: dict) -> None:
    _conv(p["mlp_shared"], f"{name}.mlp_shared.1", out)
    _conv(p["mlp_gamma"], f"{name}.mlp_gamma", out)
    _conv(p["mlp_beta"], f"{name}.mlp_beta", out)


def _spade_resblock(p: Mapping, name: str, out: dict) -> None:
    for key in ("norm_0", "norm_1", "norm_s"):
        if key in p:
            _spade(p[key], f"{name}.{key}", out)
    for key in ("conv_0", "conv_1", "conv_s"):
        if key in p:
            _conv(p[key], f"{name}.{key}", out)


def _unet_res(p: Mapping, name: str, out: dict) -> None:
    for key in ("bn1", "bn2"):
        _bn(p[key], f"{name}.{key}", out)
    for key in ("conv1", "conv2"):
        _conv(p[key], f"{name}.{key}", out)
    _conv(p["sqz"], f"{name}.sqz_layer", out)


def blender_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """Blender params -> port Blender state dict in the reference's names,
    the spectral-norm weights as their normalised values (`.weight`; the
    inverse of the layout of `convert_blender`)."""
    out: dict[str, torch.Tensor] = {}
    fpn = params["FPN"]
    for i in range(1, 6):
        _conv(fpn[f"layer{i}"], f"referencer.FPN.layer{i}.0", out)
    for key in ("head_0", "G_middle_0", "G_middle_1"):
        _spade_resblock(fpn[key], f"referencer.FPN.{key}", out)
    out["referencer.trainable_tao"] = _t(np.asarray(params["trainable_tao"]).reshape(1))
    u = params["unet"]
    inp = u["input_encoder_layer"]
    _conv(inp["conv1"], "unet.input_encoder_layer.conv1", out)
    _bn(inp["bn1"], "unet.input_encoder_layer.bn1", out)
    _conv(inp["conv2"], "unet.input_encoder_layer.conv2", out)
    _conv(inp["sqz"], "unet.input_encoder_layer.sqz_layer", out)
    for key in ("res_en_layer2", "res_en_layer3", "res_bridge_layer", "res_de_layer3",
                "res_de_layer2", "res_de_layer1"):
        _unet_res(u[key], f"unet.{key}", out)
    _conv(u["output_decoder_layer"], "unet.output_decoder_layer.0", out)
    return out


def _gcfsr_styled(p: Mapping, name: str, out: dict) -> None:
    _modconv(p["conv"], f"{name}.modulated_conv", out)
    out[f"{name}.weight"] = _t(p["noise_weight"])
    out[f"{name}.activate.bias"] = _t(p["act_bias"])


def _gcfsr_to_rgb(p: Mapping, name: str, out: dict) -> None:
    _modconv(p["conv"], f"{name}.modulated_conv", out)
    out[f"{name}.bias"] = _t(np.asarray(p["bias"]).transpose(0, 3, 1, 2))


def gcfsr_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """FaceInpainting params -> port FaceInpainting state dict in basicsr's
    names (the inverse of the layout of `convert_gcfsr`)."""
    out: dict[str, torch.Tensor] = {}
    _convlayer(params["conv_body_first"], "conv_body_first", out)
    _convlayer(params["final_conv"], "final_conv", out)
    _convlayer(params["final_down1"], "final_down1", out, downsample=True)
    _convlayer(params["final_down2"], "final_down2", out, downsample=True)
    _linear(params["final_linear"], "final_linear", out)
    _gcfsr_styled(params["style_conv1"], "style_conv1", out)
    _gcfsr_to_rgb(params["to_rgb1"], "to_rgb1", out)
    for i in range(_count(params, "conv_body_down_")):
        _convlayer(params[f"conv_body_down_{i}"], f"conv_body_down.{i}", out, downsample=True)
    for j in range(_count(params, "condition_scale1_")):
        _linear(params[f"condition_scale1_{j}"], f"condition_scale1.{j}", out)
        _linear(params[f"condition_scale2_{j}"], f"condition_scale2.{j}", out)
        _convlayer(params[f"condition_shift_{j}"], f"condition_shift.{j}", out, activate=False)
    for k in range(_count(params, "style_convs_")):
        _gcfsr_styled(params[f"style_convs_{k}"], f"style_convs.{k}", out)
    for k in range(_count(params, "to_rgbs_")):
        _gcfsr_to_rgb(params[f"to_rgbs_{k}"], f"to_rgbs.{k}", out)
    return out


def _groupnorm(p: Mapping, name: str, out: dict) -> None:
    out[f"{name}.weight"] = _t(p["scale"])
    out[f"{name}.bias"] = _t(p["bias"])


def _vq_res(p: Mapping, name: str, out: dict) -> None:
    for key in ("norm1", "norm2"):
        _groupnorm(p[key], f"{name}.{key}", out)
    for key in ("conv1", "conv2", "conv_out"):
        if key in p:
            _conv(p[key], f"{name}.{key}", out)


def _vq_blocks(p: Mapping, plan, prefix: str, out: dict) -> None:
    for i, (kind, *_) in enumerate(plan):
        q, name = p[f"blocks_{i}"], f"{prefix}.blocks.{i}"
        if kind == "conv":
            _conv(q, name, out)
        elif kind == "res":
            _vq_res(q, name, out)
        elif kind == "attn":
            _groupnorm(q["norm"], f"{name}.norm", out)
            for key in ("q", "k", "v", "proj_out"):
                _conv(q[key], f"{name}.{key}", out)
        elif kind in ("down", "up"):
            _conv(q["conv"], f"{name}.conv", out)
        else:
            _groupnorm(q, name, out)


def codeformer_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """CodeFormer params -> port CodeFormer state dict in the reference's
    names (the inverse of the layout of `convert_codeformer`)."""
    from e4s2024_torch.models import codeformer

    out: dict[str, torch.Tensor] = {}
    _vq_blocks(params["encoder"], codeformer.encoder_plan(), "encoder", out)
    _vq_blocks(params["generator"], codeformer.generator_plan(), "generator", out)
    out["quantize.embedding.weight"] = _t(params["codebook"])
    out["position_emb"] = _t(params["position_emb"])
    _linear(params["feat_emb"], "feat_emb", out)
    for n in range(_count(params, "ft_layers_")):
        q, name = params[f"ft_layers_{n}"], f"ft_layers.{n}"
        out[f"{name}.self_attn.in_proj_weight"] = _t(np.asarray(q["qkv_kernel"]).T)
        out[f"{name}.self_attn.in_proj_bias"] = _t(q["qkv_bias"])
        _linear(q["out_proj"], f"{name}.self_attn.out_proj", out)
        for key in ("linear1", "linear2"):
            _linear(q[key], f"{name}.{key}", out)
        for key in ("norm1", "norm2"):
            _layernorm(q[key], f"{name}.{key}", out)
    _layernorm(params["idx_norm"], "idx_pred_layer.0", out)
    _linear(params["idx_pred"], "idx_pred_layer.1", out)
    for key in sorted(k for k in params if k.startswith("fuse_")):
        q, name = params[key], f"fuse_convs_dict.{key[len('fuse_'):]}"
        _vq_res(q["encode_enc"], f"{name}.encode_enc", out)
        for head in ("scale", "shift"):
            _conv(q[f"{head}_0"], f"{name}.{head}.0", out)
            _conv(q[f"{head}_2"], f"{name}.{head}.2", out)
    return out


def _clean_modconv(p: Mapping, name: str, out: dict) -> None:
    out[f"{name}.weight"] = _t(np.asarray(p["weight"]).transpose(3, 2, 0, 1)[None])
    _linear(p["modulation"], f"{name}.modulation", out)


def _clean_layer(p: Mapping, name: str, out: dict) -> None:
    _clean_modconv(p["conv"], f"{name}.modulated_conv", out)
    if "noise_weight" in p:
        out[f"{name}.weight"] = _t(p["noise_weight"])
    out[f"{name}.bias"] = _t(np.asarray(p["bias"]).transpose(0, 3, 1, 2))


def gfpgan_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """GFPGANv1Clean params -> port GFPGANv1Clean state dict in the
    reference's names (the inverse of the layout of `convert_gfpgan`)."""
    out: dict[str, torch.Tensor] = {}
    for name in ("conv_body_first", "final_conv"):
        _conv(params[name], name, out)
    _linear(params["final_linear"], "final_linear", out)
    for stem in ("conv_body_down_", "conv_body_up_"):
        for i in range(_count(params, stem)):
            for key in ("conv1", "conv2", "skip"):
                _conv(params[f"{stem}{i}"][key], f"{stem[:-1]}.{i}.{key}", out)
    for i in range(_count(params, "conv_body_up_")):
        for head in ("scale", "shift"):
            for j in (0, 2):
                _conv(params[f"condition_{head}_{i}_{j}"], f"condition_{head}.{i}.{j}", out)
    dec, prefix = params["stylegan_decoder"], "stylegan_decoder"
    out[f"{prefix}.constant_input.weight"] = _t(
        np.asarray(dec["constant_input"]).transpose(0, 3, 1, 2))
    _clean_layer(dec["style_conv1"], f"{prefix}.style_conv1", out)
    _clean_layer(dec["to_rgb1"], f"{prefix}.to_rgb1", out)
    for k in range(_count(dec, "style_convs_")):
        _clean_layer(dec[f"style_convs_{k}"], f"{prefix}.style_convs.{k}", out)
    for k in range(_count(dec, "to_rgbs_")):
        _clean_layer(dec[f"to_rgbs_{k}"], f"{prefix}.to_rgbs.{k}", out)
    return out


def misf_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """MISFGenerator params -> port MISFGenerator state dict in the
    reference's names (the inverse of the layout of `convert_misf`: the
    flax transposed-convolution kernels flipped back into torch's
    (in, out, kh, kw))."""
    out: dict[str, torch.Tensor] = {}
    for name, ref in (("encoder0", "encoder0.1"), ("encoder1", "encoder1.0"),
                      ("encoder2", "encoder2.0"), ("decoder2", "decoder.7")):
        _conv(params[name], ref, out)
    for name, ref in (("decoder0", "decoder.0"), ("decoder1", "decoder.3")):
        out[f"{ref}.weight"] = _t(np.asarray(params[name]["kernel"])[::-1, ::-1]
                                  .transpose(2, 3, 0, 1))
        out[f"{ref}.bias"] = _t(params[name]["bias"])
    kpn = params["kpn_model"]
    for i in (1, 2, 3, 4, 7, 8, 9):
        for j in range(3):
            _conv(kpn[f"conv{i}"][f"conv{j}"], f"kpn_model.conv{i}.conv1.{2 * j}", out)
    _conv(kpn["kernels"], "kpn_model.kernels", out)
    _conv(kpn["core_img"], "kpn_model.core_img", out)
    for i in range(_count(params, "middle")):
        _conv(params[f"middle{i}"]["conv1"], f"middle.{i}.conv_block.1", out)
        _conv(params[f"middle{i}"]["conv2"], f"middle.{i}.conv_block.5", out)
    return out


# ------------------------------------------------------------ reenactment

def nest_flat_checkpoint(ckpt: Mapping) -> dict:
    """A checkpoint of several nets, {'net': {param: value}} or the flattened
    {'net.param': value}, as the nested form."""
    if any(isinstance(v, Mapping) for v in ckpt.values()):
        return {k: dict(v) for k, v in ckpt.items() if isinstance(v, Mapping)}
    nested: dict[str, dict] = {}
    for key, value in ckpt.items():
        head, _, rest = key.partition(".")
        nested.setdefault(head, {})[rest] = value
    return nested


def drop_antialias_buffers(state_dict: Mapping, scales: Mapping[str, float]) -> dict:
    """A state dict without the fixed Gaussian of each AntiAliasInterpolation2d
    named in `scales` (key -> scale factor): a present buffer must equal the
    port's constant (`models/facevid2vid.py::antialias_kernel`, repeated per
    channel) within 1e-6, or this raises."""
    from e4s2024_torch.models.facevid2vid import antialias_kernel

    out = dict(state_dict)
    for key, scale in scales.items():
        if key not in out:
            continue
        got = torch.as_tensor(np.asarray(out.pop(key))).float().cpu()
        want = torch.from_numpy(antialias_kernel(scale)).float()
        if got.ndim != 4 or got.shape[1] != 1 or got.shape[2:] != want.shape \
                or not torch.allclose(got, want.expand_as(got), rtol=0.0, atol=1e-6):
            raise ValueError(f"{key}: the anti-alias kernel {tuple(got.shape)} differs from "
                             f"the port's constant for scale {scale}")
    return out


def _conv3(p: Mapping, name: str, out: dict) -> None:
    out[f"{name}.weight"] = _t(np.asarray(p["kernel"]).transpose(4, 3, 0, 1, 2))
    if "bias" in p:
        out[f"{name}.bias"] = _t(p["bias"])


def _resnet_block(p: Mapping, name: str, out: dict, convs=(1, 2, 3)) -> None:
    for j in convs:
        _conv(p[f"conv{j}"], f"{name}.conv{j}", out)
        _bn(p[f"bn{j}"], f"{name}.bn{j}", out)
    if "down_conv" in p:
        _conv(p["down_conv"], f"{name}.downsample.0", out)
        _bn(p["down_bn"], f"{name}.downsample.1", out)


def hopenet_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """Hopenet params -> port Hopenet state dict in the reference's names
    (the inverse of the layout of `convert_hopenet`)."""
    out: dict[str, torch.Tensor] = {}
    _conv(params["conv1"], "conv1", out)
    _bn(params["bn1"], "bn1", out)
    for key in sorted(k for k in params if k.startswith("layer")):
        li, bi = key[len("layer"):].split("_")
        _resnet_block(params[key], f"layer{li}.{bi}", out)
    for head in ("fc_yaw", "fc_pitch", "fc_roll"):
        _linear(params[head], head, out)
    return out


def _convnorm(p: Mapping, name: str, out: dict, conv3d: bool = False) -> None:
    (_conv3 if conv3d else _conv)(p["conv"], f"{name}.conv", out)
    _bn(p["norm"], f"{name}.norm", out)


def _fv2v_spade_block(p: Mapping, name: str, out: dict) -> None:
    for key in ("norm_0", "norm_1", "norm_s"):
        if key in p:
            _conv(p[key]["mlp_shared"], f"{name}.{key}.mlp_shared.0", out)
            _conv(p[key]["mlp_gamma"], f"{name}.{key}.mlp_gamma", out)
            _conv(p[key]["mlp_beta"], f"{name}.{key}.mlp_beta", out)
    for key in ("conv_0", "conv_1", "conv_s"):
        if key in p:
            _conv(p[key], f"{name}.{key}", out)


def facevid2vid_state_dicts_from_jax(params: Mapping) -> dict[str, dict[str, torch.Tensor]]:
    """FaceVid2VidDriver params {'kp_detector', 'he_estimator', 'generator'}
    -> the port's three state dicts in the reference's names (the inverse of
    the layouts of `convert_facevid2vid_kp`, `_he` and `_generator`; the
    spectral norms are the folded weights)."""
    kp, he, gen = params["kp_detector"], params["he_estimator"], params["generator"]
    kp_sd: dict[str, torch.Tensor] = {}
    pred = kp["predictor"]
    _conv(pred["conv"], "predictor.conv", kp_sd)
    for i in range(_count(pred, "down_")):
        _convnorm(pred[f"down_{i}"], f"predictor.down_blocks.down{i}", kp_sd)
    for i in range(_count(pred, "up_")):
        _convnorm(pred[f"up_{i}"], f"predictor.up_blocks.up{i}", kp_sd, conv3d=True)
    _conv3(kp["kp"], "kp", kp_sd)

    he_sd: dict[str, torch.Tensor] = {}
    for i in range(1, 6):
        _conv(he[f"conv{i}"], f"conv{i}", he_sd)
        _bn(he[f"norm{i}"], f"norm{i}", he_sd)
    blocks = {f"{b}_{i}": f"{b}.b{b[-1]}_{i}" for b, n in
              (("block1", 3), ("block3", 3), ("block5", 5), ("block7", 2)) for i in range(n)}
    blocks.update({b: b for b in ("block2", "block4", "block6")})
    for key, name in blocks.items():
        q = he[key]
        for j in (1, 2, 3):
            _conv(q[f"conv{j}"], f"{name}.conv{j}", he_sd)
            _bn(q[f"norm{j}"], f"{name}.norm{j}", he_sd)
        if "skip" in q:
            _conv(q["skip"], f"{name}.skip", he_sd)
            _bn(q["norm4"], f"{name}.norm4", he_sd)
    for fc in ("fc_roll", "fc_pitch", "fc_yaw", "fc_t", "fc_exp"):
        _linear(he[fc], fc, he_sd)

    g_sd: dict[str, torch.Tensor] = {}
    _convnorm(gen["first"], "first", g_sd)
    _convnorm(gen["third"], "third", g_sd)
    _conv(gen["second"], "second", g_sd)
    _conv(gen["fourth"], "fourth", g_sd)
    for i in range(_count(gen, "down_blocks_")):
        _convnorm(gen[f"down_blocks_{i}"], f"down_blocks.{i}", g_sd)
    for i in range(_count(gen, "resblocks_3d_")):
        r, name = gen[f"resblocks_3d_{i}"], f"resblocks_3d.3dr{i}"
        for j in (1, 2):
            _conv3(r[f"conv{j}"], f"{name}.conv{j}", g_sd)
            _bn(r[f"norm{j}"], f"{name}.norm{j}", g_sd)
    dm, name = gen["dense_motion_network"], "dense_motion_network"
    _conv3(dm["compress"], f"{name}.compress", g_sd)
    _bn(dm["norm"], f"{name}.norm", g_sd)
    _conv3(dm["mask"], f"{name}.mask", g_sd)
    _conv(dm["occlusion"], f"{name}.occlusion", g_sd)
    hg = dm["hourglass"]
    _conv3(hg["conv"], f"{name}.hourglass.decoder.conv", g_sd)
    _bn(hg["norm"], f"{name}.hourglass.decoder.norm", g_sd)
    for i in range(_count(hg, "down_")):
        _convnorm(hg[f"down_{i}"], f"{name}.hourglass.encoder.down_blocks.{i}", g_sd, True)
        _convnorm(hg[f"up_{i}"], f"{name}.hourglass.decoder.up_blocks.{i}", g_sd, True)
    dec = gen["decoder"]
    _conv(dec["fc"], "decoder.fc", g_sd)
    _conv(dec["conv_img"], "decoder.conv_img", g_sd)
    for key in [f"G_middle_{i}" for i in range(_count(dec, "G_middle_"))] + ["up_0", "up_1"]:
        _fv2v_spade_block(dec[key], f"decoder.{key}", g_sd)
    return {"kp_detector": kp_sd, "he_estimator": he_sd, "generator": g_sd}


def _instance_norm(p: Mapping, name: str, out: dict) -> None:
    out[f"{name}.weight"] = _t(p["scale"])
    out[f"{name}.bias"] = _t(p["bias"])


def _tps_cn(p: Mapping, name: str, out: dict) -> None:
    _conv(p["conv"], f"{name}.conv", out)
    _instance_norm(p["norm"], f"{name}.norm", out)


def tpsmm_state_dicts_from_jax(params: Mapping) -> dict[str, dict[str, torch.Tensor]]:
    """TPSMMDriver params {'kp_detector', 'dense_motion', 'inpainting'} ->
    the port's {'kp_detector', 'dense_motion_network', 'inpainting_network'}
    state dicts in the reference's names (the inverse of the layout of
    `convert_tpsmm`)."""
    kp, dm, inp = params["kp_detector"], params["dense_motion"], params["inpainting"]
    kp_sd: dict[str, torch.Tensor] = {}
    _conv(kp["conv1"], "fg_encoder.conv1", kp_sd)
    _bn(kp["bn1"], "fg_encoder.bn1", kp_sd)
    _linear(kp["fc"], "fg_encoder.fc", kp_sd)
    for key in sorted(k for k in kp if k.startswith("layer")):
        li, bi = key[len("layer"):].split("_")
        _resnet_block(kp[key], f"fg_encoder.layer{li}.{bi}", kp_sd, convs=(1, 2))
    dm_sd: dict[str, torch.Tensor] = {}
    hg = dm["hourglass"]
    for i in range(_count(hg, "down")):
        _tps_cn(hg[f"down{i}"], f"hourglass.encoder.down_blocks.{i}", dm_sd)
        _tps_cn(hg[f"up{i}"], f"hourglass.decoder.up_blocks.{i}", dm_sd)
    _conv(dm["maps"], "maps", dm_sd)
    for i in range(_count(dm, "occlusion")):
        _conv(dm[f"occlusion{i}"], f"occlusion.{i}", dm_sd)
    for i in range(_count(dm, "up")):
        _tps_cn(dm[f"up{i}"], f"up.{i}", dm_sd)
    in_sd: dict[str, torch.Tensor] = {}
    _tps_cn(inp["first"], "first", in_sd)
    _conv(inp["final"], "final", in_sd)
    for i in range(_count(inp, "down")):
        _tps_cn(inp[f"down{i}"], f"down_blocks.{i}", in_sd)
        _tps_cn(inp[f"up{i}"], f"up_blocks.{i}", in_sd)
    for i in range(_count(inp, "res")):
        r, name = inp[f"res{i}"], f"resblock.{i}"
        for j in (1, 2):
            _conv(r[f"conv{j}"], f"{name}.conv{j}", in_sd)
            _instance_norm(r[f"norm{j}"], f"{name}.norm{j}", in_sd)
    return {"kp_detector": kp_sd, "dense_motion_network": dm_sd, "inpainting_network": in_sd}


def _fomm_hourglass(p: Mapping, name: str, out: dict) -> None:
    for i in range(_count(p, "down")):
        _convnorm(p[f"down{i}"], f"{name}.encoder.down_blocks.{i}", out)
        _convnorm(p[f"up{i}"], f"{name}.decoder.up_blocks.{i}", out)


def dagan_state_dicts_from_jax(params: Mapping) -> dict[str, dict[str, torch.Tensor]]:
    """DaGANDriver params -> the port's {'generator', 'kp_detector',
    'depth_encoder', 'depth_decoder'} state dicts in the reference's names
    (the inverse of the layout of `convert_dagan`)."""
    gen, kp = params["generator"], params["kp_detector"]
    enc, dec = params["depth_encoder"], params["depth_decoder"]
    g_sd: dict[str, torch.Tensor] = {}
    for key in ("first", "src_first"):
        _convnorm(gen[key], key, g_sd)
    _conv(gen["final"], "final", g_sd)
    attn = gen["AttnModule"]
    for key in ("query_conv", "key_conv", "value_conv"):
        _conv(attn[key], f"AttnModule.{key}", g_sd)
    g_sd["AttnModule.gamma"] = _t(attn["gamma"])
    for stem, name in (("down", "down_blocks"), ("src_down", "src_down_blocks"),
                       ("up", "up_blocks")):
        for i in range(_count(gen, stem)):
            _convnorm(gen[f"{stem}{i}"], f"{name}.{i}", g_sd)
    for i in range(_count(gen, "bottleneck_r")):
        r, name = gen[f"bottleneck_r{i}"], f"bottleneck.r{i}"
        for j in (1, 2):
            _conv(r[f"conv{j}"], f"{name}.conv{j}", g_sd)
            _bn(r[f"norm{j}"], f"{name}.norm{j}", g_sd)
    dm = gen["dense_motion_network"]
    _fomm_hourglass(dm["hourglass"], "dense_motion_network.hourglass", g_sd)
    _conv(dm["mask"], "dense_motion_network.mask", g_sd)
    if "occlusion" in dm:
        _conv(dm["occlusion"], "dense_motion_network.occlusion", g_sd)
    kp_sd: dict[str, torch.Tensor] = {}
    _fomm_hourglass(kp["predictor"], "predictor", kp_sd)
    _conv(kp["kp"], "kp", kp_sd)
    if "jacobian" in kp:
        _conv(kp["jacobian"], "jacobian", kp_sd)
    enc_sd: dict[str, torch.Tensor] = {}
    _conv(enc["conv1"], "encoder.conv1", enc_sd)
    _bn(enc["bn1"], "encoder.bn1", enc_sd)
    for key in sorted(k for k in enc if k.startswith("layer")):
        li, bi = key[len("layer"):].split("_")
        _resnet_block(enc[key], f"encoder.layer{li}.{bi}", enc_sd)
    dec_sd: dict[str, torch.Tensor] = {}
    for i in range(4, -1, -1):
        for j in (0, 1):
            _conv(dec[f"upconv_{i}_{j}"], f"decoder.{2 * (4 - i) + j}.conv.conv", dec_sd)
    _conv(dec["dispconv_0"], "decoder.10.conv", dec_sd)
    return {"generator": g_sd, "kp_detector": kp_sd, "depth_encoder": enc_sd,
            "depth_decoder": dec_sd}


def lia_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """LIAGenerator params -> port LIAGenerator state dict in the
    reference's names (the inverse of the layout of `convert_lia`; the
    activation biases in the port's (C,) form)."""
    out: dict[str, torch.Tensor] = {}
    app, prefix = params["enc"]["net_app"], "enc.net_app.convs"
    _convlayer(app["conv0"], f"{prefix}.0", out)
    n = _count(app, "res")
    for j in range(n):
        r = app[f"res{j}"]
        _convlayer(r["conv1"], f"{prefix}.{j + 1}.conv1", out)
        _convlayer(r["conv2"], f"{prefix}.{j + 1}.conv2", out, downsample=True)
        _conv(r["skip"]["conv"], f"{prefix}.{j + 1}.skip.1", out, key="weight")
    _conv(app["final"], f"{prefix}.{n + 1}", out, key="weight")
    for i in range(5):
        _linear(params["enc"][f"fc{i}"], f"enc.fc.{i}", out)
    dec = params["dec"]
    out["dec.direction.weight"] = _t(dec["direction"]["weight"])
    out["dec.input.input"] = _t(np.asarray(dec["input"]).transpose(0, 3, 1, 2))
    _styled_conv(dec["conv1"], "dec.conv1", out)
    for i in range(_count(dec, "convs_")):
        _styled_conv(dec[f"convs_{i}"], f"dec.convs.{i}", out)
    for j in range(_count(dec, "to_rgbs_")):
        rgb, name = dec[f"to_rgbs_{j}"], f"dec.to_rgbs.{j}"
        _conv(rgb["conv"], f"{name}.conv.0", out, key="weight")
        out[f"{name}.conv.1.bias"] = _t(rgb["act_bias"])
        out[f"{name}.bias"] = _t(np.asarray(rgb["bias"]).transpose(0, 3, 1, 2))
        flow, name = dec[f"to_flows_{j}"], f"dec.to_flows.{j}"
        _modconv(flow["conv"], f"{name}.conv", out)
        out[f"{name}.bias"] = _t(np.asarray(flow["bias"]).transpose(0, 3, 1, 2))
    return out


def dcnv2pack_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """DCNv2Pack params -> port DCNv2Pack state dict (`conv_offset`,
    `weight`, `bias`; the JAX package's offset layout, not basicsr's)."""
    out: dict[str, torch.Tensor] = {}
    _conv(params["conv_offset"], "conv_offset", out)
    out["weight"] = _t(np.asarray(params["weight"]).transpose(3, 2, 0, 1))
    out["bias"] = _t(params["bias"])
    return out
