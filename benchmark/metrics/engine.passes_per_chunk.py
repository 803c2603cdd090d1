"""Chain passes per chunk on the chain engines: the window's
``rf.engine.pass`` spans inside a chunk span (``rf.engine.kgram`` on K3,
``rf.engine.k1`` on K1 or K2) over the number of those chunk spans. 1.0
when every speculative guess of the chunks' entry states verifies; each
Jacobi round adds one (and a chunk that leaves speculation also runs its
output pass again)."""

from benchmark import spans


def read(tr):
    prog = spans.program(tr)
    chunks = [e for e in prog if e.name in spans.CHUNKS]
    if not chunks:
        return None
    passes = [e for e in prog if e.name == spans.PASS]
    return sum(spans.inside(passes, chunks)) / len(chunks)
