"""Host kernel launches per call of the entry point, from the traced
slice's CPU-side launch events (layer: entry point, host dispatch)."""


def read(r):
    if r.trace is None or not r.slice_calls:
        return None
    return r.trace.launches / r.slice_calls
