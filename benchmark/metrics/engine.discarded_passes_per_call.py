"""Chain passes a call whose results were thrown away: the window's
``rf.engine.pass`` spans inside the ``rf.engine.kgram`` chunks of a public
call (``rf.api.*``) that holds an ``rf.engine.rescan`` span (K3 diverged and
the stream was scanned again), and those inside the ``rf.engine.k1`` chunks
that hold an ``rf.engine.fallback`` span (the chunk's rounds ran out and the
exact fallback scanned it), over the window's calls. 0 when every guess
settles within the rounds. ``None`` where the window holds neither an
``rf.engine.rescan`` span nor a stage span of the fallback
(``rf.engine.fallback.*``): a program that does not record them, or calls
that never diverged."""

from benchmark import spans

RESCAN = "rf.engine.rescan"
FALLBACK = "rf.engine.fallback"


def _holding(chunks, marks) -> list:
    return [c for c in chunks if any(c.ts <= m.ts and m.end <= c.end for m in marks)]


def read(tr):
    prog = spans.program(tr)
    rescans = [e for e in prog if e.name == RESCAN]
    fallbacks = [e for e in prog if e.name == FALLBACK]
    if not tr.calls or not (rescans or any(
            e.name.startswith(FALLBACK + ".") for e in prog)):
        return None
    calls = _holding([e for e in prog if e.name.startswith(spans.API)], rescans)
    kgram = [e for e in prog if e.name == "rf.engine.kgram"]
    chunks = spans.inside(kgram, calls) if calls else [False] * len(kgram)
    thrown = [c for c, hit in zip(kgram, chunks) if hit]
    thrown += _holding([e for e in prog if e.name == "rf.engine.k1"], fallbacks)
    passes = [e for e in prog if e.name == spans.PASS]
    return sum(spans.inside(passes, thrown)) / tr.calls if thrown else 0.0
