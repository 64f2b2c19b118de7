"""Seeded weights drawn on the device, in a few large calls.

A net is built on the meta device, which gives every parameter's and
buffer's shape and the module that owns it. Each tensor is drawn as its
module's default initialisation draws it:

- `nn.Conv2d`, `nn.ConvTranspose2d`, `nn.Linear`: weight and bias uniform
  in +-1/sqrt(fan_in) (PyTorch's kaiming_uniform with a = sqrt 5);
- `nn.BatchNorm*`, `nn.InstanceNorm*` with affine or stats: weight 1,
  bias 0, running mean 0, running variance 1;
- `nn.PReLU`: 0.25;
- any other module names its own rules in `init_rules()`:
  {name: ("normal", std) | ("uniform", bound) | ("const", value)}.

All normal draws of a net come from one `torch.randn` call, all uniform
draws from one `torch.rand`, and the constants from one fill, on the card,
from a `torch.Generator` seeded with the run's seed; each tensor is a view
of its buffer. The same seed gives the same weights.
"""

from __future__ import annotations

import fnmatch
import math

import torch
from torch import nn

_UNIFORM_FAN_IN = (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d, nn.Linear)
_NORMS = (nn.modules.batchnorm._NormBase,)


def _fan_in(weight_shape) -> int:
    return weight_shape[1] * math.prod(weight_shape[2:])


def _rule(module: nn.Module, name: str, tensor: torch.Tensor):
    rules = getattr(module, "init_rules", None)
    if rules is not None and name in rules():
        return rules()[name]
    if isinstance(module, _UNIFORM_FAN_IN) and name in ("weight", "bias"):
        return ("uniform", 1.0 / math.sqrt(_fan_in(module.weight.shape)))
    if isinstance(module, _NORMS):
        return {"weight": ("const", 1.0), "bias": ("const", 0.0),
                "running_mean": ("const", 0.0), "running_var": ("const", 1.0),
                "num_batches_tracked": ("const", 0.0)}[name]
    if isinstance(module, nn.PReLU) and name == "weight":
        return ("const", 0.25)
    raise KeyError(f"no initialisation rule for {type(module).__name__}.{name}")


def plan(net: nn.Module, overrides: dict | None = None) -> list:
    """[(key, shape, dtype, rule)] for every tensor of `net`'s state dict.
    `overrides` maps fnmatch patterns of keys to rules that replace the
    module's own."""
    out = []
    for mod_name, module in net.named_modules():
        tensors = list(module.named_parameters(recurse=False))
        tensors += [(n, b) for n, b in module.named_buffers(recurse=False)
                    if n not in module._non_persistent_buffers_set]
        for name, t in tensors:
            key = f"{mod_name}.{name}" if mod_name else name
            rule = None
            for pattern, r in (overrides or {}).items():
                if fnmatch.fnmatchcase(key, pattern):
                    rule = tuple(r)
            out.append((key, tuple(t.shape), t.dtype, rule or _rule(module, name, t)))
    return out


def draw(tensors: list, seed: int, device, dtype=torch.float32) -> dict:
    """A state dict for a `plan`: floating tensors in `dtype`, drawn from
    `seed` on `device` in one call per kind of draw."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    kinds: dict[str, list] = {"normal": [], "uniform": [], "const": []}
    for key, shape, t_dtype, (kind, arg) in tensors:
        kinds[kind].append((key, shape, t_dtype, float(arg)))
    state = {}
    for kind, items in kinds.items():
        if not items:
            continue
        sizes = [math.prod(shape) for _, shape, _, _ in items]
        total = sum(sizes)
        scale = torch.repeat_interleave(
            torch.tensor([a for *_, a in items], dtype=dtype, device=device),
            torch.tensor(sizes, device=device), output_size=total)
        if kind == "normal":
            flat = torch.randn(total, generator=gen, device=device, dtype=dtype).mul_(scale)
        elif kind == "uniform":
            flat = torch.rand(total, generator=gen, device=device, dtype=dtype)
            flat = flat.mul_(2.0).sub_(1.0).mul_(scale)
        else:
            flat = scale
        for (key, shape, t_dtype, _), part in zip(items, torch.split(flat, sizes)):
            part = part.view(shape)
            state[key] = part if t_dtype.is_floating_point else part.to(t_dtype)
    return state


def seeded_state(nets: dict, seed: int, device, overrides: dict | None = None) -> dict:
    """{net name: state dict} for meta-built `nets`, each net drawn from its
    own seed derived from `seed` and its name, so that adding a net leaves
    the others' weights as they were."""
    out = {}
    for name, net in nets.items():
        sub = (int(seed) * 1_000_003 + sum(map(ord, name)) * 7919) % (2 ** 63)
        out[name] = draw(plan(net, (overrides or {}).get(name)), sub, device)
    return out
