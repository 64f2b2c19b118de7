"""ms per call of the port's `composite` spans over the traced slice (layer:
stage models): the soft-eroded masks and the multi-band blend
(`FaceSwapper._composite`); its interval on the card's stream, between two
CUDA events."""

from perfbench import spans


def read(r):
    return spans.per_call_ms(r, "composite")
