"""The port's K1-K3 CUDA kernels against their memory bound, in % (layer:
kernels): the summed least time of their launches in the traced slice
(bytes of the reference's plain calls, each input read once and each
output written once, over the card's HBM bandwidth) over their summed
device time in the trace.

Reported only where the port's launch counters over the slice equal, call
for call, the reference's count of the plain calls; otherwise the bytes
would not be the launches' and the reader returns nothing, with a note."""

from perfbench import peaks
from perfbench.reference.plain_kernels import KERNEL_NAMES


def read(r):
    if r.trace is None or r.ref_tally is None or not r.slice_calls:
        return None
    bound = device = 0.0
    for name, patterns in KERNEL_NAMES.items():
        want = r.ref_tally.calls.get(name, 0) * r.slice_calls
        got = r.port_launches.get(name, 0)
        if got != want:
            r.notes.append(f"kernels_roofline: {name} launched {got} times in the slice, "
                           f"the reference's count is {want}; not reported")
            return None
        bound += r.ref_tally.bytes.get(name, 0) * r.slice_calls
        device += sum(s for k, s in r.trace.kernel_s.items()
                      if any(p in k for p in patterns))
    if device <= 0:
        return None
    return 100.0 * peaks.bound_seconds(bound, r.kind) / device
