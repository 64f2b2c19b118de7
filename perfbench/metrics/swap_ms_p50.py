"""The median latency of the window's calls, in ms (layer: entry point):
the steadier neighbour of `swap_ms_p95`."""

import statistics


def read(r):
    return 1e3 * statistics.median(r.latencies_s) if r.latencies_s else None
