"""The port's kernel K5 (`fused_swin_block`, one whole Swin block) against
its compute bound, in % (layer: kernels): the summed least time of its
launches in the traced slice over their summed device time in the trace
(`swin_block_kernel`). A launch's least time is its operations
(`reference/swinir.py::block_operations`, which the reference's blocks add
to its tally) at the 3xTF32 rate: K5 computes each float32 product as
three TF32 products, so a third of the dense TF32 peak, a sixth of the
dense bfloat16 peak (`perfbench/peaks.py`).

Reported only where the port's K5 launches over the slice equal the
reference's blocks a call times the slice's calls (36 a call for
SwinIR-M); otherwise the operations would not be the launches' and the
reader returns nothing, with a note."""

from perfbench import peaks

NAME = "fused_swin_block"
KERNEL = "swin_block_kernel"
TF32X3_SHARE_OF_BF16 = 1 / 6


def read(r):
    if r.trace is None or r.ref_tally is None or not r.slice_calls:
        return None
    blocks = r.ref_tally.calls.get(NAME, 0)
    got = r.port_launches.get(NAME, 0)
    if not blocks or got != blocks * r.slice_calls:
        r.notes.append(f"swin_block_roofline: {NAME} launched {got} times in the slice, the "
                       f"reference's count is {blocks * r.slice_calls}; not reported")
        return None
    device = sum(s for k, s in r.trace.kernel_s.items() if KERNEL in k)
    if device <= 0:
        return None
    ops = vars(r.ref_tally)["operations"][NAME] * r.slice_calls
    rate = peaks.peak(r.kind, "flops_bf16") * TF32X3_SHARE_OF_BF16
    return 100.0 * ops / rate / device
