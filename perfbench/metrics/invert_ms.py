"""ms per call of the port's `invert` spans over the traced slice (layer: stage
models): the RGI inversion to style vectors (`FaceSwapper._parse_invert`);
its interval on the card's stream, between two CUDA events."""

from perfbench import spans


def read(r):
    return spans.per_call_ms(r, "invert")
