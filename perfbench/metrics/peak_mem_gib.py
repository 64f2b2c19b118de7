"""Peak device memory allocated over the window, in GiB (layer: device):
`torch.cuda.max_memory_allocated()` after `reset_peak_memory_stats()` at
the window's start."""


def read(r):
    return r.peak_mem_bytes / 2 ** 30 if r.peak_mem_bytes else None
