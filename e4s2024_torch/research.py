"""Research drivers: comparison figures, mouth transfer, interpolation strips.

Counterpart of `e4s2024_tpu/research.py`, the library and CLI form of the
reference's figure scripts (swap_face_comp_figs.py, comp_images.py,
Face_swap_frontal.py), which batch-swap CelebA-HQ pairs from an index file
and compose side-by-side figures. The drivers reuse the port's pipelines
and take paths as arguments.

- `load_pair_index`: the "src tgt" index file (comp_images.py:10-20, a
  header line, then pairs).
- `comparison_grid`: a horizontal strip of panels (comp_images.py:57-77).
- `mouth_transfer`: mask-gated mouth transfer with a multi-band blended
  seam (swap_face_comp_figs.py:131-145).
- `interpolation_strip`: style interpolation between two faces
  (swap_face_comp_figs.py:599-672).
- `run_comp_figs`: pair swaps -> grids on disk.

Images are (H, W, 3) arrays in [0, 255], numpy, as in the JAX package.
Image files are read with PIL, imported inside the readers; grids are
written with `utils.image.save_png`.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from e4s2024_torch import resolve_device
from e4s2024_torch.ops.blend import laplacian_pyramid_blend_planar
from e4s2024_torch.ops.morphology import dilation, erosion
from e4s2024_torch.ops.resize import resize_bilinear
from e4s2024_torch.utils.image import from_pm1, save_png, to_pm1


def load_pair_index(path: str) -> list[tuple[str, str]]:
    """Parse a pair index file: one header line, then `src tgt` per line
    (reference comp_images.py:10-20)."""
    with open(path) as f:
        lines = [line.strip().split() for line in f.readlines()[1:] if line.strip()]
    return [(line[0], line[1]) for line in lines]


def comparison_grid(images: list[np.ndarray], pad: int = 4, pad_value: int = 255) -> np.ndarray:
    """A horizontal strip of images with white gutters, the comparison
    figures' layout (reference comp_images.py:57-77); shorter panels are
    resized bilinearly to the strip's height."""
    h = max(im.shape[0] for im in images)
    cols = []
    for im in images:
        im = np.asarray(im)
        if im.ndim == 2:
            im = np.repeat(im[..., None], 3, axis=-1)
        if im.shape[0] != h:
            w = int(round(im.shape[1] * h / im.shape[0]))
            t = torch.as_tensor(np.asarray(im, np.float32)).permute(2, 0, 1)
            im = resize_bilinear(t, (h, w)).permute(1, 2, 0).numpy()
        cols.append(np.clip(im, 0, 255).astype(np.uint8))
        cols.append(np.full((h, pad, 3), pad_value, np.uint8))
    return np.concatenate(cols[:-1], axis=1)


def expansion_seam(mask: torch.Tensor, radius: int = 5) -> torch.Tensor:
    """The band on both sides of a mask's edge, dilation minus erosion
    (reference swap_face_comp_figs.py:57-74, 'expansion'). mask: (B, C, H, W)."""
    m = mask.float()
    size = 2 * radius + 1
    return torch.clamp(dilation(m, size) - erosion(m, size), 0.0, 1.0)


def mouth_transfer(source255, target255, mouth_mask, seam_radius: int = 5,
                   num_levels: int = 8, device=None):
    """Paste `source`'s mouth region onto `target` along a multi-band blended
    seam (reference swap_face_comp_figs.py:131-145: a hard mask composite,
    then `blending` over the expansion seam), on `device` (CUDA unless
    "cpu" is given).

    source255, target255: (H, W, 3) in [0, 255]; mouth_mask: (H, W) {0, 1}
    (the mouth classes of a 12-class map), resized bilinearly to the image
    where its size differs. Returns (combined, mouth mask, seam mask), each
    uint8 numpy."""
    dev = resolve_device(device)
    s = torch.as_tensor(np.asarray(source255, np.float32), device=dev).permute(2, 0, 1)[None]
    t = torch.as_tensor(np.asarray(target255, np.float32), device=dev).permute(2, 0, 1)[None]
    m = (torch.as_tensor(np.asarray(mouth_mask, np.float32), device=dev) > 0).float()
    h, w = s.shape[-2:]
    if m.shape != (h, w):
        m = (resize_bilinear(m, (h, w)) > 0).float()
    m = m[None, None]
    seam = expansion_seam(m, seam_radius)
    combined = s * m + t * (1.0 - m)
    while num_levels > 1 and (h % 2 ** (num_levels - 1) or w % 2 ** (num_levels - 1)):
        num_levels -= 1  # the pyramid's depth capped by the size's divisibility
    # the seam band takes the source's bands over the hard composite
    # (reference blending(source, combined, seam))
    blended = laplacian_pyramid_blend_planar(s, combined, seam, num_levels=num_levels)
    out = torch.clamp(blended[0], 0, 255).permute(1, 2, 0)
    return (out.to(torch.uint8).cpu().numpy(),
            (m[0, 0] * 255).to(torch.uint8).cpu().numpy(),
            (seam[0, 0] * 255).to(torch.uint8).cpu().numpy())


def interpolation_strip(editor, img_a255: np.ndarray, img_b255: np.ndarray,
                        label_a: np.ndarray, label_b: np.ndarray, steps: int = 5,
                        components=None) -> np.ndarray:
    """A strip interpolating A's style toward B's on A's geometry (reference
    swap_face_comp_figs.py:599-672). `editor` is a `pipelines.editor.Editor`;
    labels are (H, W) 12-class maps."""
    sv_a = editor.invert(to_pm1(np.asarray(img_a255, np.float32))[None], np.asarray(label_a)[None])
    sv_b = editor.invert(to_pm1(np.asarray(img_b255, np.float32))[None], np.asarray(label_b)[None])
    panels = [np.asarray(img_a255, np.uint8)]
    for i in range(steps):
        t = (i + 1) / (steps + 1)
        sv = editor.interpolate_styles(sv_a, sv_b, t, components=components)
        img = editor.generate_from_label(sv, np.asarray(label_a)[None])
        panels.append(from_pm1(img[0].cpu().numpy()))
    panels.append(np.asarray(img_b255, np.uint8))
    return comparison_grid(panels)


def run_comp_figs(swap_fn, pairs: list[tuple[str, str]], image_dirs, out_dir: str,
                  save_panels: bool = False) -> list[str]:
    """Pair swaps -> comparison grids (reference comp_images.py's main loop;
    swap_face_comp_figs.py:207 `faceSwapping_pipeline`).

    `swap_fn(source_rgb_u8, target_rgb_u8) -> swapped_rgb_u8`, e.g.
    `FaceSwapper.swap`. `image_dirs` is searched in order for
    `<index>.jpg` / `.png` / `.jpeg` (the reference falls back from the
    test to the train split, comp_images.py:44-49). Returns the grids'
    paths."""
    from PIL import Image

    if isinstance(image_dirs, str):
        image_dirs = [image_dirs]

    def find(idx: str) -> str:
        for d in image_dirs:
            for ext in (".jpg", ".png", ".jpeg", ""):
                p = os.path.join(d, idx + ext)
                if os.path.exists(p):
                    return p
        raise FileNotFoundError(f"{idx} not under {image_dirs}")

    os.makedirs(out_dir, exist_ok=True)
    written = []
    for src_idx, tgt_idx in pairs:
        src = np.asarray(Image.open(find(src_idx)).convert("RGB"))
        tgt = np.asarray(Image.open(find(tgt_idx)).convert("RGB"))
        out = np.asarray(swap_fn(src, tgt))
        path = os.path.join(out_dir, f"{src_idx}_to_{tgt_idx}.png")
        save_png(path, comparison_grid([src, tgt, out]))
        if save_panels:
            save_png(os.path.join(out_dir, f"{src_idx}_to_{tgt_idx}_swap.png"),
                     np.asarray(out, np.uint8))
        written.append(path)
    return written


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="Batch comparison figures from a pair index file "
                    "(reference comp_images.py / swap_face_comp_figs.py)")
    ap.add_argument("--pairs", required=True, help="index file: header + 'src tgt' lines")
    ap.add_argument("--image-dirs", required=True, nargs="+")
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--rgi", required=True, help="RGINet torch checkpoint")
    ap.add_argument("--bisenet", required=True, help="BiSeNet torch checkpoint")
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--aligned", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from e4s2024_torch.pipelines.swap import FaceSwapper, SwapConfig
    from e4s2024_torch.swap_cli import load_params

    swapper = FaceSwapper(load_params(args.rgi), load_params(args.bisenet),
                          SwapConfig(out_size=args.size), device=args.device)
    if args.aligned:
        def swap_fn(s, t):
            return swapper.swap_aligned(s[None], t[None])["image"][0].cpu().numpy()
    else:
        swap_fn = swapper.swap
    for p in run_comp_figs(swap_fn, load_pair_index(args.pairs), args.image_dirs, args.out_dir):
        print(p)


if __name__ == "__main__":
    main()
