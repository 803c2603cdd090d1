"""Device-idle time per call, in milliseconds, while the innermost program
span is the API's own (``rf.api.*``): the public call's Python with the
card waiting on it. Each idle interval is placed on the host clock by the
launch of the work that ends it and cut exactly at the program's span
bounds (``benchmark.spans``)."""

from benchmark import spans


def read(tr):
    idle = spans.idle_by_span(tr)
    if idle is None or not tr.calls:
        return None
    us = sum(d for name, d in idle.items() if name.startswith(spans.API))
    return us * 1e-3 / tr.calls
