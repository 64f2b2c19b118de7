"""ms per call of the port's `parse` spans over the traced slice (layer: stage
models): BiSeNet's parse of the driven and target crops and the 12-class map
(`FaceSwapper._parse_invert`); its interval on the card's stream, between
two CUDA events."""

from perfbench import spans


def read(r):
    return spans.per_call_ms(r, "parse")
