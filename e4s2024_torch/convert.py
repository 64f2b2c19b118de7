"""JAX-package parameters -> port state dicts.

The inverse of the layout rules of the JAX package's checkpoint converter
(`e4s2024_tpu/convert/torch_loader.py`):

  flax kernel (in, out)       -> torch Linear (out, in)
  flax kernel HWIO            -> torch Conv2d OIHW
  ModulatedConv (kh, kw, I, O) -> (1, O, I, kh, kw)
  ToRGB bias (1, 1, 1, 3)     -> (1, 3, 1, 1)
  const input (1, 4, 4, C)    -> (1, C, 4, 4)
  LayerNorm scale, bias       -> weight, bias

The functions take nested dicts of numpy (or array-like) leaves and return
flat {reference name: torch.Tensor} dicts that the port's modules load with
`load_state_dict(strict=True)`.
"""

from __future__ import annotations

from typing import Mapping

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
