"""The share of their roofline, in percent, of the kernels that read their
DFA table from global memory: the kernels whose launch lies inside the
program's ``rf.engine.global_table`` spans (K1 and K2 on their global
route), each paired with its launch as ``benchmark/spans.py`` pairs them.
Their least time (each input byte of the window's calls read once and each
answer byte written once at the card's memory rate, ``trace.bound_s``: the
yardstick of ``kernels.roofline_pct``) over their summed device time in the
window. ``None`` where no kernel launched inside such a span."""

from benchmark import spans
from benchmark.trace import bound_s

SPAN = "rf.engine.global_table"


def read(tr):
    marks = [e for e in spans.program(tr) if e.name == SPAN]
    found = spans.enqueued(tr) if marks else None
    if found is None or not tr.bytes_in:
        return None
    kernels = [(dev, call) for dev, call in found[0] if dev.cat == "kernel"]
    inside = spans.inside([call for _, call in kernels], marks)
    busy = sum(min(dev.end, tr.t1) - max(dev.ts, tr.t0)
               for (dev, _), hit in zip(kernels, inside)
               if hit and dev.end > tr.t0 and dev.ts < tr.t1) * 1e-6
    if busy <= 0:
        return None
    return 100.0 * bound_s(tr.bytes_in, tr.bytes_out) / busy
