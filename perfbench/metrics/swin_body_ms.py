"""ms per call of the port's `swin_body` spans over the traced slice (layer:
stage models): SwinIR's six RSTBs (36 Swin blocks, each one launch of K5,
and six 3x3 convs), inside the enhance stage; its interval on the card's
stream, between two CUDA events. None on a program that opens no such
span."""

from perfbench import spans


def read(r):
    return spans.per_call_ms(r, "swin_body")
