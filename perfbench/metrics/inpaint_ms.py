"""ms per call of the port's `inpaint` spans over the traced slice (layer:
stage models): the zoo's inpaint stage (GCFSR and the soft composite); its
interval on the card's stream, between two CUDA events."""

from perfbench import spans


def read(r):
    return spans.per_call_ms(r, "inpaint")
