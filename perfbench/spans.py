"""What the readers of the port's spans share: the port's span buffer
(`e4s2024_torch.utils.observability.recorded_spans`), summed by span name
over the traced slice and divided by the slice's calls.

The port records spans only while a torch.profiler is active or a
StageTimer is attached, and the drivers attach none, so after a run the
buffer holds the traced slice's spans and no others. A program without
the buffer, or one that recorded no span of the name, reads as None,
never as 0.
"""

from __future__ import annotations


def recorded() -> list:
    """The port's recorded spans as dicts (id, name, parent, call, host_ms,
    device_ms, ...); [] where the port has no span buffer."""
    from e4s2024_torch.utils import observability

    read = getattr(observability, "recorded_spans", None)
    return [] if read is None else read()


def total_ms(buffer: list, name: str, key: str = "device_ms") -> float | None:
    """Σ `key` over the spans named `name`, each counted once: a span
    inside another span of the same name is in its ancestor's time and is
    left out. None where no span of the name was recorded, or one of them
    has no such time (no device)."""
    by_id = {s["id"]: s for s in buffer}

    def nested(s) -> bool:
        p = by_id.get(s["parent"])
        while p is not None:
            if p["name"] == name:
                return True
            p = by_id.get(p["parent"])
        return False

    times = [s[key] for s in buffer if s["name"] == name and not nested(s)]
    if not times or any(t is None for t in times):
        return None
    return float(sum(times))


def per_call_ms(r, name: str, key: str = "device_ms") -> float | None:
    """`total_ms` of the port's buffer over the reading's traced calls."""
    if not r.slice_calls:
        return None
    ms = total_ms(recorded(), name, key)
    return None if ms is None else ms / r.slice_calls
