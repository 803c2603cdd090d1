"""Device-idle time per call, in milliseconds, while the innermost program
span is an engine's (``rf.engine.*``): chunk ids, padding, launch
preparation, the control reads and the positions compaction, with the card
waiting on them. Each idle interval is placed on the host clock by the
launch of the work that ends it and cut exactly at the program's span
bounds (``benchmark.spans``)."""

from benchmark import spans


def read(tr):
    idle = spans.idle_by_span(tr)
    if idle is None or not tr.calls:
        return None
    us = sum(d for name, d in idle.items() if name.startswith(spans.ENGINE))
    return us * 1e-3 / tr.calls
