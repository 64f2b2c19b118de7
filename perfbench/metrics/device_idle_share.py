"""The device's idle share over the traced slice, in %: 1 - the union of its
kernel, memcpy and memset intervals over the slice's wall time (layer:
device)."""


def read(r):
    if r.trace is None or r.slice_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.slice_s)
