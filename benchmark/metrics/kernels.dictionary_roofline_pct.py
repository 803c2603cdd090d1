"""The share of their roofline, in percent, of the dictionary path's
kernels: those whose launch lies inside one of the window's
``rf.engine.k1`` chunk spans (K1's speculation, K2's counting pass on the
global-table route and the verdict) or ``rf.engine.pattern_fold`` spans
(the fold of the per-state histogram into per-pattern counts), each paired
with its launch as ``benchmark/spans.py`` pairs them. Their least time
(each input byte of the window's calls read once and each answer byte
written once at the card's memory rate, ``trace.bound_s``: the yardstick of
``kernels.roofline_pct``) over their summed device time in the window.
``None`` where no kernel launched inside such a span."""

from benchmark import spans
from benchmark.trace import bound_s

MARKS = ("rf.engine.k1", "rf.engine.pattern_fold")


def read(tr):
    marks = [e for e in spans.program(tr) if e.name in MARKS]
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
