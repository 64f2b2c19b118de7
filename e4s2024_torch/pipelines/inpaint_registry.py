"""Inpainting backends by name (`e4s2024_tpu/pipelines/inpaint_registry.py`):
"gcfsr", the reference's live default (swap_face_fine/face_inpainting.py),
and "misf", its alternative (swap_face_fine/MISF/inpainting.py), whose
reference checkpoint is not public, so it needs weights of one's own.
"""

from __future__ import annotations

_BACKENDS = {}


def register_inpainter(name):
    def deco(fn):
        _BACKENDS[name] = fn
        return fn
    return deco


@register_inpainter("gcfsr")
def _gcfsr(state_dict, **kw):
    from e4s2024_torch.models.gcfsr import FaceInpainter

    return FaceInpainter(state_dict, **kw)


@register_inpainter("misf")
def _misf(state_dict=None, **kw):
    if state_dict is None:
        raise ValueError(
            "MISF needs InpaintGenerator weights (the reference ships no public "
            "checkpoint: MISF/inpainting.py:16 reads an internal cluster path)")
    from e4s2024_torch.models.misf import MISFInpainter

    return MISFInpainter(state_dict, **kw)


def make_inpainter(name, state_dict=None, **kw):
    """The inpainter `name` over `state_dict` (the backend's reference state
    dict); keyword arguments go to its constructor (e.g. `device=`)."""
    if name not in _BACKENDS:
        raise KeyError(f"unknown inpainting backend {name!r}; available: {sorted(_BACKENDS)}")
    return _BACKENDS[name](state_dict, **kw)
