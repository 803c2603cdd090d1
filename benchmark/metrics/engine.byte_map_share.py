"""The share of K1/K2 chunks whose chain kernels mapped the raw bytes
themselves: the window's ``rf.engine.k1`` chunk spans that hold an
``rf.engine.byte_map`` span (a K1 or K2 launch given the byte-to-class map),
over the ``rf.engine.k1`` chunk spans that launched a kernel on the card.
1.0 when every chunk's lanes divide it; a chunk that the engine maps and
pads itself counts against it, and so does every chunk of a program that
records no such span (0.0). ``None`` where no such chunk ran on the card
(the plain versions on the CPU launch none)."""

from benchmark import spans

SPAN = "rf.engine.byte_map"


def _holds(chunk, events) -> bool:
    return any(chunk.ts <= e.ts and e.end <= chunk.end for e in events)


def read(tr):
    prog = spans.program(tr)
    launches = [e for e in tr.of("cuda_runtime", "cuda_driver")
                if any(n in e.name for n in spans.ENQUEUE["kernel"])]
    chunks = [c for c in prog if c.name == "rf.engine.k1" and _holds(c, launches)]
    if not chunks:
        return None
    marks = [e for e in prog if e.name == SPAN]
    return sum(_holds(c, marks) for c in chunks) / len(chunks)
