"""Command-line face swap (the main program of the reference's
`Face_swap_with_two_imgs.py`, :966), on the port.

Checkpoints are the reference's torch files (`iteration_300000.pt`,
`79999_iter.pth`), read natively. Landmarks come from the RetinaFace + FAN
stack (weights from --weights-dir or $E4S_WEIGHTS); `--landmarks-json`
gives precomputed 68-point landmarks instead, and `--aligned` skips
detection for FFHQ-aligned crops. Runs on the card unless --device cpu.

Usage:
  python -m e4s2024_torch.swap_cli --source s.png --target t.png --out o.png \\
      --rgi rgi.pt --bisenet bisenet.pth [--aligned] [--size 1024] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def load_params(path: str) -> dict:
    """A torch checkpoint file -> its state dict, without the fixed
    generator buffers a reference E4S checkpoint carries
    (`convert.drop_generator_buffers`). A directory (an orbax tree of the
    JAX package) is refused with the command that converts it: the
    repository's `orbax_to_torch.py zoo`, run where JAX and orbax are."""
    from e4s2024_torch.convert import drop_generator_buffers, load_reference_checkpoint

    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory: the port reads torch checkpoint files (.pt/.pth), not "
            "orbax checkpoint trees; convert a JAX zoo where JAX and orbax are installed with "
            "`python orbax_to_torch.py zoo <orbax_root> <out_dir>` and pass "
            "<out_dir>/<name>.pt")
    return drop_generator_buffers(load_reference_checkpoint(path))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--source", required=True, help="identity image")
    ap.add_argument("--target", required=True, help="attribute/pose image")
    ap.add_argument("--out", required=True, help="output image path")
    ap.add_argument("--rgi", required=True, help="RGI checkpoint (torch file)")
    ap.add_argument("--bisenet", required=True, help="BiSeNet checkpoint (torch file)")
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--remaining_layer_idx", type=int, default=13)
    ap.add_argument("--regional_mode", default="fast", choices=("fast", "exact"))
    ap.add_argument("--compute_dtype", default="bfloat16")
    ap.add_argument("--aligned", action="store_true",
                    help="inputs are already aligned crops (skip warping)")
    ap.add_argument("--landmarks-json", default=None,
                    help="json {path: [[x, y] * 68]} of precomputed landmarks for "
                         "unaligned inputs (overrides the detector)")
    ap.add_argument("--weights-dir", default=None,
                    help="dir holding RetinaFace-mobile0.25.pth / 2DFAN4.pth for the "
                         "default detector (else $E4S_WEIGHTS)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from PIL import Image

    from e4s2024_torch.pipelines import detect
    from e4s2024_torch.pipelines.swap import FaceSwapper, SwapConfig

    rgi_sd = load_params(args.rgi)
    bise_sd = load_params(args.bisenet)

    landmark_fn = None
    if args.landmarks_json:
        with open(args.landmarks_json) as f:
            table = {os.path.abspath(k): np.asarray(v, np.float64)
                     for k, v in json.load(f).items()}
        paths = iter([os.path.abspath(args.source), os.path.abspath(args.target)])

        def landmark_fn(_img):  # noqa: ANN001
            return table[next(paths)]

    cfg = SwapConfig(out_size=args.size, remaining_layer_idx=args.remaining_layer_idx,
                     regional_mode=args.regional_mode, compute_dtype=args.compute_dtype)
    swapper = FaceSwapper(rgi_sd, bise_sd, cfg, landmark_fn=landmark_fn, device=args.device)

    src = np.asarray(Image.open(args.source).convert("RGB"))
    tgt = np.asarray(Image.open(args.target).convert("RGB"))

    if args.aligned:
        s = args.size
        if src.shape[:2] != (s, s):
            src = np.asarray(Image.fromarray(src).resize((s, s)))
        if tgt.shape[:2] != (s, s):
            tgt = np.asarray(Image.fromarray(tgt).resize((s, s)))
        out = swapper.swap_aligned(src[None], tgt[None])["image"][0].cpu().numpy()
    else:
        if landmark_fn is None and args.weights_dir:
            swapper.landmark_fn = detect.default_landmarker(args.weights_dir,
                                                            device=swapper.device)
        # otherwise FaceSwapper.swap builds the default stack from
        # $E4S_WEIGHTS (random weights and a warning when unset)
        out = swapper.swap(src, tgt)

    Image.fromarray(out).save(args.out)
    print(f"wrote {args.out} ({out.shape[1]}x{out.shape[0]})")


if __name__ == "__main__":
    main()
