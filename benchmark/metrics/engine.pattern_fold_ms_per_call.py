"""Milliseconds a call of the program's fold of per-state counts into
per-pattern counts: the summed host time of the window's
``rf.engine.pattern_fold`` spans (one a chunk of ``count_patterns``, inside
the chunk's chain pass; its gather and scatter-add are only queued there)
over the window's calls. ``None`` where the window holds no such span (a
program that does not fold on the device)."""

from benchmark import spans

FOLD = "rf.engine.pattern_fold"


def read(tr):
    folds = [e for e in spans.program(tr) if e.name == FOLD]
    if not folds or not tr.calls:
        return None
    return sum(min(e.end, tr.t1) - max(e.ts, tr.t0) for e in folds) * 1e-3 / tr.calls
