"""ms per call of the port's `swap_aligned` spans over the traced slice (layer:
entry point): the host's enqueue of a whole `swap_aligned` call, which
returns before the device finishes; the host's clock."""

from perfbench import spans


def read(r):
    return spans.per_call_ms(r, "swap_aligned", "host_ms")
