"""ms per call of the port's `core_swap` spans over the traced slice (layer:
stage models): the zoo's core swap (parse, invert, merge, synthesis,
composite on the batch); its interval on the card's stream, between two CUDA
events."""

from perfbench import spans


def read(r):
    return spans.per_call_ms(r, "core_swap")
