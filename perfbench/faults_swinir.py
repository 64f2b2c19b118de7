"""Faults planted in the port's SwinIR-enhanced swap (the driver
`swap_enhanced`): four in SwinIR, and the aligned swap's two of
`faults.py`, for the readings that show its comparison with the reference
catches them: on the card at the cell's own size (`control_swinir.py`) and
on the CPU at a tiny size (the tests). Each is a context manager that
breaks the port while it is open; the program must be built inside it."""

from __future__ import annotations

import contextlib

import torch

from perfbench.faults import _patched, aligned_answer_altered, aligned_swap_undone


def _swinir():
    from e4s2024_torch.models import swinir

    return swinir


@contextlib.contextmanager
def _each_swinir(change):
    """`change(model)` applied to every SwinIR built while open."""
    cls = _swinir().SwinIR

    def make(init):
        def init_then_change(self, *a, **k):
            init(self, *a, **k)
            change(self)
        return init_then_change

    with _patched(cls, "__init__", make):
        yield


def shifted_block_unshifted():
    """The first RSTB's second block (a shifted one) run unshifted."""
    def change(model):
        model.layers[0].residual_group.blocks[1].shift = 0
    return _each_swinir(change)


def bias_left_out():
    """The first block's relative-position bias left out (zeros)."""
    def make(biases):
        def without_first(self):
            out = biases(self)
            return [[torch.zeros_like(b) if (i, j) == (0, 0) else b for j, b in enumerate(row)]
                    for i, row in enumerate(out)]
        return without_first
    return _patched(_swinir().SwinIR, "_biases", make)


@contextlib.contextmanager
def rstb_conv_skipped():
    """The first RSTB's closing conv skipped: its blocks' output goes to the
    residual as it is."""
    mod = _swinir()

    def change(model):
        model.layers[0].conv.skipped = True

    def make(conv):
        def maybe(m, x):
            return x if getattr(m, "skipped", False) else conv(m, x)
        return maybe

    with _each_swinir(change), _patched(mod, "_conv", make):
        yield


def enhancer_undone():
    """The driven crop handed on unenhanced."""
    def make(_):
        def undone(self, crops255):
            return torch.as_tensor(crops255).to(self.upscaler.device, torch.float32)
        return undone
    return _patched(_swinir().SwinIREnhancer, "enhance_aligned", make)


FAULTS = {"swap_enhanced": {"shifted_block_unshifted": shifted_block_unshifted,
                            "bias_left_out": bias_left_out,
                            "rstb_conv_skipped": rstb_conv_skipped,
                            "enhancer_undone": enhancer_undone,
                            "answer_altered": aligned_answer_altered,
                            "swap_undone": aligned_swap_undone}}
