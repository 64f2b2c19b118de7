"""ms per call of the port's `merge` spans over the traced slice (layer: stage
models): `swap_head_mask` and `swap_comp_style_vector`; its interval on the
card's stream, between two CUDA events."""

from perfbench import spans


def read(r):
    return spans.per_call_ms(r, "merge")
