"""ms per call of the port's `upscale` spans over the traced slice (layer:
stage models): RealESRGAN x4 inside the zoo's recolor stage; its interval
on the card's stream, between two CUDA events. None on a program that
opens no such span."""

from perfbench import spans


def read(r):
    return spans.per_call_ms(r, "upscale")
