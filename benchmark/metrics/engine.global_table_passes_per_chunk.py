"""Chain passes per chunk where the DFA table lies in global memory: the
window's ``rf.engine.pass`` spans inside the ``rf.engine.k1`` chunk spans
that hold an ``rf.engine.global_table`` span (a K1 or K2 launch on the
global route), over the number of those chunks. 1.0 when every speculative
guess of the chunks' entry states verifies; each Jacobi round adds one.
``None`` where no chunk launched on that route."""

from benchmark import spans

SPAN = "rf.engine.global_table"


def read(tr):
    prog = spans.program(tr)
    marks = [e for e in prog if e.name == SPAN]
    chunks = [e for e in prog if e.name == "rf.engine.k1"]
    chunks = [c for c in chunks
              if any(c.ts <= m.ts and m.end <= c.end for m in marks)]
    if not chunks:
        return None
    passes = [e for e in prog if e.name == spans.PASS]
    return sum(spans.inside(passes, chunks)) / len(chunks)
