"""Faults planted in the port's timed path, for the readings that show
the comparison with the reference catches them: on the card at a cell's
own size (`control.py --faults`) and on the CPU at a tiny size (the
tests). Each is a context manager that breaks one method of the port
while it is open, named by the driver whose entry point it breaks."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(cls, name: str, make):
    """`cls.name` replaced by `make(original)` while open."""
    old = getattr(cls, name)
    setattr(cls, name, make(old))
    try:
        yield
    finally:
        setattr(cls, name, old)


def _plus_one(image: torch.Tensor) -> torch.Tensor:
    return (image.to(torch.int16) + 1).clamp(0, 255).to(torch.uint8)


def _swapper():
    from e4s2024_torch.pipelines.swap import FaceSwapper

    return FaceSwapper


def _pipeline():
    from e4s2024_torch.pipelines.full_swap import FullFaceSwapPipeline

    return FullFaceSwapPipeline


def aligned_answer_altered():
    """Every swapped image one level up where the composite produces it."""
    return _patched(_swapper(), "_composite",
                    lambda f: lambda *a, **k: _plus_one(f(*a, **k)))


def aligned_swap_undone():
    """The target returned where the synthesis and composite would run."""
    def make(_):
        def undone(self, swapped_sv, swapped_mask, hole_mask, t_pm1):
            return ((t_pm1 + 1.0) * 127.5).round().clamp(0, 255).permute(0, 2, 3, 1).to(
                torch.uint8)
        return undone
    return _patched(_swapper(), "_synth_and_composite", make)


def batch_answer_altered():
    """Every image of the batch one level up where the pipeline packs it."""
    def make(_):
        def package(self, swapped, driven, result, intermediates=False):
            return {"image": _plus_one(torch.clamp(swapped, 0, 255).to(torch.uint8))}
        return package
    return _patched(_pipeline(), "_package", make)


def batch_half_left_out():
    """The first half of the batch swapped and repeated over the rest."""
    def make(run):
        def half(self, src, tgt, *a, **k):
            h = max(1, src.shape[0] // 2)
            out = run(self, src[:h], tgt[:h], *a, **k)
            return {key: torch.cat([v, v])[:src.shape[0]] for key, v in out.items()}
        return half
    return _patched(_pipeline(), "_run", make)


def batch_one_pair_swapped():
    """The first image of the batch swapped from the second pair's driven
    face: one wrong pair, the rest of the batch sound."""
    def make(run):
        def wrong_pair(self, src, tgt, *a, **k):
            src = src.clone()
            src[0] = src[1]
            return run(self, src, tgt, *a, **k)
        return wrong_pair
    return _patched(_pipeline(), "_run", make)


def batch_one_index_wrong():
    """The first image of the batch answered with the second pair's image:
    one answer at a wrong index, the rest of the batch sound."""
    def make(run):
        def wrong_index(self, src, tgt, *a, **k):
            out = run(self, src, tgt, *a, **k)
            image = out["image"].clone()
            image[0] = image[1]
            return dict(out, image=image)
        return wrong_index
    return _patched(_pipeline(), "_run", make)


def batch_one_swap_undone():
    """The first image of the batch returned as its target, unswapped; the
    rest of the batch sound."""
    def make(run):
        def undone(self, src, tgt, *a, **k):
            out = run(self, src, tgt, *a, **k)
            image = out["image"].clone()
            image[0] = tgt[0]
            return dict(out, image=image)
        return undone
    return _patched(_pipeline(), "_run", make)


FAULTS = {
    "swap_aligned": {"answer_altered": aligned_answer_altered,
                     "swap_undone": aligned_swap_undone},
    "swap_batch": {"answer_altered": batch_answer_altered,
                   "half_batch_left_out": batch_half_left_out,
                   "one_pair_swapped": batch_one_pair_swapped,
                   "one_index_wrong": batch_one_index_wrong,
                   "one_swap_undone": batch_one_swap_undone},
}
