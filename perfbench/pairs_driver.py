"""What the drivers of the swap entry points share: a pool of (driven,
target) calls from the traffic file, a closed-loop call that ends when the
swapped images are on the host, and a check that runs the reference once
over every pool entry the window used and compares every call with it.

A subclass names the program (`PROGRAM_MODULES`, imported before set-up's
first part, `build_program`, `program_call`), the
reference (`REFERENCE`, `reference_cfg`, `reference_swap`) and what is
compared (`COMPARED`: (output key, check name, function of (program's,
reference's)) triples). Each check's value is the worst call's.
"""

from __future__ import annotations

import torch

from perfbench import traffic, weights


def seeded(ref_cls, cfg: dict, ctx):
    """A reference of `ref_cls` built on the meta device, its weights drawn
    from the run's seed on the run's device; also its state, for the
    program."""
    ref = ref_cls(cfg, device="meta")
    state = weights.seeded_state(ref.nets(), ctx.seed, ctx.device,
                                 ctx.config.get("init_overrides"))
    return ref, state


def swap_config(cfg: dict):
    """The port's SwapConfig of a configuration's `swap` group."""
    from e4s2024_torch.pipelines.swap import SwapConfig

    keys = SwapConfig.__dataclass_fields__
    return SwapConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                         for k, v in cfg.items() if k in keys})


def face_swapper(cfg: dict, state: dict, device):
    """The port's FaceSwapper on a seeded state."""
    from e4s2024_torch.pipelines.swap import FaceSwapper

    return FaceSwapper(state["rgi"], state["bisenet"], swap_config(cfg), device=device,
                       encoder_num_units=tuple(cfg["encoder_num_units"]))


class PairsDriver:
    PROGRAM_MODULES: tuple = ()
    REFERENCE = None      # the reference class
    COMPARED: tuple = ()

    def __init__(self, ctx):
        self.ctx = ctx
        self.outputs = []
        self._ref = None

    # ---- the program

    def build_program(self, state: dict):
        raise NotImplementedError

    def program_call(self, driven, target) -> dict:
        raise NotImplementedError

    # ---- the reference

    def reference_cfg(self) -> dict:
        raise NotImplementedError

    def reference_swap(self, ref, driven, target) -> dict:
        raise NotImplementedError

    # ---- the run

    def build(self):
        self.pool = traffic.make(self.ctx.traffic, self.ctx.config["swap"]["out_size"],
                                 self.ctx.seed, self.ctx.device)
        self.ctx.lap("traffic")
        _, state = seeded(self.REFERENCE, self.reference_cfg(), self.ctx)
        self.ctx.lap("weights")
        self.program = self.build_program(state)
        del state
        self.ctx.lap("program")

    def _on_device(self, j: int):
        driven, target = self.pool[j]
        dev = self.ctx.device
        return torch.from_numpy(driven).to(dev), torch.from_numpy(target).to(dev)

    def warm(self):
        for i in range(int(self.ctx.workload["warm_calls"])):
            self.call(i)
        self.outputs.clear()

    def call(self, i: int) -> int:
        j = i % len(self.pool)
        driven, target = self.pool[j]
        with torch.profiler.record_function("entry_point"):
            out = self.program_call(driven, target)
        with torch.profiler.record_function("image_to_host"):
            out["image"] = out["image"].cpu()
        self.outputs.append((j, {key: out[key] for key, _, _ in self.COMPARED}))
        return driven.shape[0]

    def release(self):
        self.program = None

    def _reference(self):
        if self._ref is None:
            self._ref, state = seeded(self.REFERENCE, self.reference_cfg(), self.ctx)
            self._ref.load(state, self.ctx.device)
        return self._ref

    def reference_call(self):
        self.reference_swap(self._reference(), *self._on_device(0))

    def check(self) -> list:
        worst = {name: 0.0 for _, name, _ in self.COMPARED}
        by_entry: dict = {}
        for j, out in self.outputs:
            by_entry.setdefault(j, []).append(out)
        for j, outs in sorted(by_entry.items()):
            ref = self.reference_swap(self._reference(), *self._on_device(j))
            for out in outs:
                for key, name, fn in self.COMPARED:
                    worst[name] = max(worst[name], fn(out[key], ref[key]))
        self.outputs.clear()
        limits = self.ctx.workload["limits"]
        return [{"name": k, "value": v, "limit": limits[k]} for k, v in worst.items()]
