"""ms per call of the port's `enhance` spans over the traced slice (layer:
stage models): the zoo's enhance stage (GPEN-512); its interval on the
card's stream, between two CUDA events."""

from perfbench import spans


def read(r):
    return spans.per_call_ms(r, "enhance")
