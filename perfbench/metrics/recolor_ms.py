"""ms per call of the port's `recolor` spans over the traced slice (layer:
stage models): the zoo's recolor stage (Blender, RealESRGAN x4, the
edge-aware blend); its interval on the card's stream, between two CUDA
events."""

from perfbench import spans


def read(r):
    return spans.per_call_ms(r, "recolor")
