"""One typed configuration tree (counterpart of `e4s2024_tpu/config.py`).

It stands for the reference's six argparse option classes (reference
options/: TrainOptions, TestOptions, OptimOptions, EditOptions, UIOptions,
OurSwapFacePipelineOptions). Every field keeps the reference default;
`from_args` maps command-line flags onto one section, so that
`python -m e4s2024_torch.train --batch_size 4 ...` works as the
reference's train.py does.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass, field

from e4s2024_torch.pipelines.swap import SwapConfig
from e4s2024_torch.training.coach import TrainConfig
from e4s2024_torch.training.pti import PTIConfig, StitchingConfig


@dataclass
class OptimConfig:
    """W-space refinement (reference options/optim_options.py:37-39)."""

    W_steps: int = 150
    lr: float = 1e-2
    opt_name: str = "adam"
    id_lambda: float = 0.1
    face_parsing_lambda: float = 0.1


@dataclass
class DataConfig:
    celeba_root: str = ""
    ffhq_root: str = ""
    dataset_name: str = "celeba"
    flip_p: float = 0.5
    ds_frac: float = 1.0


@dataclass
class CheckpointConfig:
    """Paths of the reference's torch checkpoints (reference README.md:55-68
    pretrained/ tree)."""

    e4s: str = ""                 # E4S iteration_300000.pt
    stylegan2_ffhq: str = ""      # stylegan2-ffhq-config-f.pt
    ir_se50: str = ""             # model_ir_se50.pth
    bisenet: str = ""             # 79999_iter.pth
    parsing_unet: str = ""        # faceseg model.pth
    lpips_alex: str = ""          # torchvision alexnet weights
    lpips_lin: str = ""           # LPIPS v0.1 lin heads


@dataclass
class VideoPipelineConfig:
    """Video swap orchestration (reference
    options/our_swap_face_pipeline_options.py)."""

    pti: PTIConfig = field(default_factory=PTIConfig)
    stitching: StitchingConfig = field(default_factory=StitchingConfig)
    erode_radius: int = 3
    outer_dilation: int = 15
    frames_per_batch: int = 8


@dataclass
class E4SConfig:
    """The top of the tree."""

    exp_dir: str = "work_dirs/exp"
    train: TrainConfig = field(default_factory=TrainConfig)
    swap: SwapConfig = field(default_factory=SwapConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    data: DataConfig = field(default_factory=DataConfig)
    checkpoints: CheckpointConfig = field(default_factory=CheckpointConfig)
    video: VideoPipelineConfig = field(default_factory=VideoPipelineConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    @classmethod
    def from_args(cls, argv: list[str] | None = None, section: str = "train") -> "E4SConfig":
        """Flags onto the fields of one section (bools, ints, floats and
        strings), plus `--exp_dir`."""
        cfg = cls()
        sec = getattr(cfg, section)
        parser = argparse.ArgumentParser()
        parser.add_argument("--exp_dir", type=str, default=cfg.exp_dir)

        def _bool(v: str) -> bool:
            if v.lower() in ("1", "true", "yes", "on"):
                return True
            if v.lower() in ("0", "false", "no", "off"):
                return False
            raise argparse.ArgumentTypeError(f"not a bool: {v!r}")

        for f in dataclasses.fields(sec):
            cur = getattr(sec, f.name)
            if isinstance(cur, bool):
                # type=bool would read "--flag False" as True
                parser.add_argument(f"--{f.name}", type=_bool, default=cur)
            elif isinstance(cur, (int, float, str)) or cur is None:
                parser.add_argument(f"--{f.name}", type=type(cur), default=cur)
        args = parser.parse_args(argv)
        updates = {k: v for k, v in vars(args).items() if k != "exp_dir"}
        return dataclasses.replace(cfg, exp_dir=args.exp_dir,
                                   **{section: dataclasses.replace(sec, **updates)})


def load_all_loss_params(ckpts: CheckpointConfig) -> dict:
    """The frozen loss nets whose reference files are set, as state dicts
    in the port's names ("arcface", "lpips", "parser"), for
    `losses.recon.ReconCriterion` and the Coach."""
    from e4s2024_torch.convert import load_reference_checkpoint, lpips_state_dict_from_reference

    out = {}
    if ckpts.ir_se50:
        out["arcface"] = load_reference_checkpoint(ckpts.ir_se50)
    if ckpts.lpips_alex and ckpts.lpips_lin:
        out["lpips"] = lpips_state_dict_from_reference(
            load_reference_checkpoint(ckpts.lpips_alex),
            load_reference_checkpoint(ckpts.lpips_lin))
    if ckpts.parsing_unet:
        out["parser"] = load_reference_checkpoint(ckpts.parsing_unet)
    return out
