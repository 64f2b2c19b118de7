"""ms per call of the port's `swin_tail` spans over the traced slice (layer:
stage models): SwinIR's tail, `norm` through `conv_last` (the x4 conv
upsampler, to 4096^2 from a 1024^2 crop), inside the enhance stage; its
interval on the card's stream, between two CUDA events. None on a program
that opens no such span."""

from perfbench import spans


def read(r):
    return spans.per_call_ms(r, "swin_tail")
