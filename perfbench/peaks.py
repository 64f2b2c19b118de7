"""The table of peaks the benchmark's shares are taken against.

Dense bfloat16 tensor-core FLOP/s and HBM bytes/s by
`torch.cuda.get_device_name`, from NVIDIA's H100 SXM5 data sheet (the
port's `utils/mfu.py` table, copied). An unknown card raises: a default
would make every share on another card wrong.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"flops_bf16": 989.4e12, "bytes_per_s": 3.35e12},
}


def peak(kind: str, what: str) -> float:
    if kind not in PEAKS:
        raise ValueError(f"no peak known for {kind!r} (known: {sorted(PEAKS)})")
    return PEAKS[kind][what]


def bound_seconds(nbytes: float, kind: str) -> float:
    """The least time to move `nbytes` through the card's memory."""
    return nbytes / peak(kind, "bytes_per_s")
