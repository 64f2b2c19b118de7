"""ms per call of the port's `synthesis` spans over the traced slice (layer:
stage models): the style codes and the regional StyleGAN2 synthesis
(`cal_style_codes`, `gen_img`); its interval on the card's stream, between
two CUDA events."""

from perfbench import spans


def read(r):
    return spans.per_call_ms(r, "synthesis")
