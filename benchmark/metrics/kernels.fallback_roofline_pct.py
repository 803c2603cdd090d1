"""The share of their roofline, in percent, of the exact fallback's
kernels: those whose launch lies inside one of the program's stage spans of
the fallback (``rf.engine.fallback.fns``: K6's pass 1;
``rf.engine.fallback.combine``: its combine; ``rf.engine.fallback.pass2``:
K1's full mode and the counts), each paired with its launch as
``benchmark/spans.py`` pairs them. Their least time (each input byte of the
window's calls read once and each answer byte written once at the card's
memory rate, ``trace.bound_s``: the yardstick of ``kernels.roofline_pct``)
over their summed device time in the window. ``None`` where no kernel
launched inside such a span (a program that records no stage spans, or
calls that never took the fallback)."""

from benchmark import spans
from benchmark.trace import bound_s

STAGE = "rf.engine.fallback."


def read(tr):
    marks = [e for e in spans.program(tr) if e.name.startswith(STAGE)]
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
