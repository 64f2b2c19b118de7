"""ms per call of the port's `upload` spans over the traced slice (layer: stage
models): the crops moved from the host to the card (`FaceSwapper._as_u8`,
once a tensor); its interval on the card's stream, between two CUDA events."""

from perfbench import spans


def read(r):
    return spans.per_call_ms(r, "upload")
