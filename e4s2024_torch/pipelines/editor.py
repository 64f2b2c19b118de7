"""Face editing API, the library form of the reference's editing tools.

Counterpart of `e4s2024_tpu/pipelines/editor.py` (reference
good_editing.py:122-620 `Editor`, and the re-render of the mask-painting
UI, run_UI.py:35 and ui_run/mouse_event.py: every brush stroke edits the
12-class label map and re-synthesises through `generate_from_label`):

- reconstruct an image from its (possibly hand-edited) label map,
- swap a component's style between two faces (good_editing.py:149-191),
- swap a component's mask between two faces (:193-240),
- translate a component inside the mask (:242-262),
- interpolate styles between two faces (:459-533),
- global latent-direction editing (w + alpha * direction, :586-620).

As in the JAX package, images enter and leave in NHWC, (1, S, S, 3) in
[-1, 1], and label maps are (1, H, W) integer maps (numpy or tensors); the
net runs NCHW in its own dtype on its own device. The generator runs K1-K3
(`kernels/csrc/`) on a card.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from e4s2024_torch import resolve_device
from e4s2024_torch.convert import as_tensors, drop_generator_buffers
from e4s2024_torch.data.labels import FACE_PARSER_LABELS, NUM_SEG_CLASSES
from e4s2024_torch.models.rgi import RGINet, fsencoder_type_of

_SKIN = FACE_PARSER_LABELS.index("skin")


class Editor:
    """Holds a frozen RGI net (its weights, device and dtype are the
    editor's) and runs inversion, re-synthesis and the edits."""

    def __init__(self, net: RGINet):
        self.net = net.eval().requires_grad_(False)
        self.device = net.latent_avg.device
        self.dtype = net.latent_avg.dtype

    @classmethod
    def from_state_dict(cls, rgi_state_dict: Mapping, *, device=None,
                        compute_dtype: str = "float32", **rgi_kwargs) -> "Editor":
        """An editor over an RGINet built from reference-named weights
        (`RGINet`'s keyword arguments in `rgi_kwargs`), on `device` (CUDA
        unless "cpu" is given) in `compute_dtype`."""
        net = RGINet(fsencoder_type=fsencoder_type_of(rgi_state_dict), **rgi_kwargs)
        net.load_state_dict(as_tensors(drop_generator_buffers(rgi_state_dict)), strict=True)
        dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[compute_dtype]
        return cls(net.to(device=resolve_device(device), dtype=dtype))

    # ---------------- core ----------------

    def onehot(self, label_map) -> torch.Tensor:
        """(B, H, W) integer map -> (B, K, H, W) one-hot in the net's dtype."""
        lbl = torch.as_tensor(label_map, device=self.device).long()
        return F.one_hot(lbl, NUM_SEG_CLASSES).permute(0, 3, 1, 2).to(self.dtype)

    def invert(self, img, label_map) -> torch.Tensor:
        """img (1, S, S, 3) in [-1, 1]; label_map (1, H, W) -> style vectors
        (1, K, 1280) in the net's dtype."""
        with torch.inference_mode():
            x = torch.as_tensor(img, device=self.device).permute(0, 3, 1, 2).to(self.dtype)
            sv, _ = self.net.get_style_vectors(x, self.onehot(label_map))
        return sv

    def generate_from_label(self, style_vectors, label_map,
                            regional_mode: str = "exact") -> torch.Tensor:
        """Re-synthesise with a (possibly edited) label map, the UI's hot
        path. Returns (B, S, S, 3) float32 in about [-1, 1]."""
        with torch.inference_mode():
            sv = torch.as_tensor(style_vectors, device=self.device).to(self.dtype)
            codes = self.net.cal_style_codes(sv)
            img, _, _ = self.net.gen_img(None, codes, self.onehot(label_map),
                                         regional_mode=regional_mode)
        return img.float().permute(0, 2, 3, 1)

    # ---------------- edits ----------------

    @staticmethod
    def component_index(name: str) -> int:
        return FACE_PARSER_LABELS.index(name)

    @classmethod
    def _selected(cls, components, k: int, device) -> torch.Tensor:
        """(K,) bool: the components given by name or index."""
        idx = [cls.component_index(c) if isinstance(c, str) else int(c) for c in components]
        sel = torch.zeros(k, dtype=torch.bool, device=device)
        sel[idx] = True
        return sel

    def swap_component_style(self, sv_a, sv_b, components) -> torch.Tensor:
        """`components` (names or indices) of b's style into a's
        (good_editing.py:172)."""
        sel = self._selected(components, sv_a.shape[1], sv_a.device)
        return torch.where(sel[None, :, None], sv_b, sv_a)

    def interpolate_styles(self, sv_a, sv_b, t: float, components=None) -> torch.Tensor:
        """Linear style interpolation, optionally restricted to components
        (good_editing.py:459)."""
        mixed = (1.0 - t) * sv_a + t * sv_b
        if components is None:
            return mixed
        sel = self._selected(components, sv_a.shape[1], sv_a.device)
        return torch.where(sel[None, :, None], mixed, sv_a)

    @classmethod
    def swap_component_mask(cls, label_a, label_b, component) -> torch.Tensor:
        """Replace the component's region in a with b's shape
        (good_editing.py:193): a's old region becomes skin, b's region
        paints the component."""
        comp = cls.component_index(component) if isinstance(component, str) else int(component)
        a, b = torch.as_tensor(label_a), torch.as_tensor(label_b)
        out = torch.where(a == comp, torch.full_like(a, _SKIN), a)
        return torch.where(b.to(a.device) == comp, torch.full_like(a, comp), out)

    @staticmethod
    def translate_component(label_map, component: int, dy: int = 0, dx: int = 0) -> torch.Tensor:
        """Shift a component's region (good_editing.py:242): the vacated
        region is filled with skin, the shifted region painted on top."""
        lbl = torch.as_tensor(label_map)
        region = lbl == component
        out = torch.where(region, torch.full_like(lbl, _SKIN), lbl)
        shifted = torch.roll(region, shifts=(dy, dx), dims=(-2, -1))
        return torch.where(shifted, torch.full_like(lbl, component), out)

    @staticmethod
    def apply_latent_direction(style_vectors, direction, alpha: float) -> torch.Tensor:
        """Global editing: every component's style vector moved along a
        learned direction (good_editing.py:586). direction: (1280,) or
        (K, 1280)."""
        d = torch.as_tensor(direction, device=style_vectors.device).to(style_vectors.dtype)
        if d.ndim == 1:
            d = d[None, None]
        elif d.ndim == 2:
            d = d[None]
        return style_vectors + alpha * d
