"""Pose-drive backend registry (counterpart of
`e4s2024_tpu/pipelines/pose_drive.py`).

The reference selects among faceVid2Vid / TPSMM / DaGAN / LIA / PIRender
via `pose_drive` (reference Face_swap_with_two_imgs.py:705-769); its own
README notes that only faceVid2Vid ships public checkpoints, the others
pointing at internal cluster paths. faceVid2Vid (`models/facevid2vid.py`),
TPSMM (`models/tpsmm.py`), DaGAN (`models/dagan.py`) and LIA
(`models/lia.py`) are implemented and take the reference's state dicts;
PIRender raises, as it cannot run in the reference either.
"""

from __future__ import annotations

from typing import Any, Callable

_BACKENDS: dict[str, Callable[..., Any]] = {}


def register_pose_driver(name: str):
    def deco(fn):
        _BACKENDS[name] = fn
        return fn
    return deco


@register_pose_driver("faceVid2Vid")
def _facevid2vid(ckpt, **kw):
    from e4s2024_torch.models.facevid2vid import FaceVid2VidDriver

    return FaceVid2VidDriver(ckpt, **kw)


@register_pose_driver("TPSMM")
def _tpsmm(ckpt, **kw):
    if ckpt is None:
        raise ValueError(
            "TPSMM needs weights (the reference's checkpoint is an internal cluster "
            "path, TPSMM/demo.py:145): pass the checkpoint's {'kp_detector', "
            "'dense_motion_network', 'inpainting_network'} state dicts")
    from e4s2024_torch.models.tpsmm import TPSMMDriver

    return TPSMMDriver(ckpt, **kw)


@register_pose_driver("DaGAN")
def _dagan(state_dicts, **kw):
    if state_dicts is None:
        raise ValueError(
            "DaGAN needs weights (the reference's checkpoints are internal cluster "
            "paths, face_swap_for_video.py:311-313): pass {'generator', 'kp_detector', "
            "'depth_encoder', 'depth_decoder'} state dicts")
    from e4s2024_torch.models.dagan import DaGANDriver

    return DaGANDriver(state_dicts, **kw)


@register_pose_driver("LIA")
def _lia(state_dict, **kw):
    if state_dict is None:
        raise ValueError(
            "LIA needs weights (the reference's checkpoint is an internal cluster "
            "path, LIA/run_demo.py:54): pass its 'gen' state dict")
    from e4s2024_torch.models.lia import LIADriver

    return LIADriver(state_dict, **kw)


def _pirender_missing(params=None, **kw):
    raise NotImplementedError(
        "pose-drive backend 'PIRender' is not runnable even in the reference:"
        " it imports Deep3DFaceRecon_pytorch.drive, a package the reference "
        "does not ship (face_swap_for_video.py:285), and depends on licensed "
        "BFM 3DMM assets; use 'faceVid2Vid', 'TPSMM', 'DaGAN' or 'LIA'")


_BACKENDS["PIRender"] = _pirender_missing


def make_pose_driver(name: str, params=None, **kw):
    """The driver `name` over `params` (its reference state dicts); unknown
    names raise KeyError."""
    if name not in _BACKENDS:
        raise KeyError(f"unknown pose-drive backend {name!r}; available: {sorted(_BACKENDS)}")
    return _BACKENDS[name](params, **kw)
