"""The native host walker, built from source without ``-march=native``.

The lazy subset DFA (``models.LazyDfa``) walks the host through the C++
scanners of ``native/golden_scan.cpp``, and so do the forward stage of
span extraction (``anchored_spans``), the Snort verify's pcre check
(``dfa_scan``, the single-cursor DFA walk) and the host backend of
``DfaMatcher`` that the engine router (``ops/router.py``) chooses
(``dfa_scan_multi``, the interleaved multi-cursor walk, and
``dfa_scan_speculative``, one stream split into speculative segments). The JAX package loads them from a
library committed beside that source and built with ``-march=native``, which
can die of an illegal instruction on another CPU instead of raising. The
port never opens that file: at first use it compiles the same source with
``g++ -O3 -shared -fPIC`` (portable code for the running architecture) into
``build/native/`` at the repository root, under a name that carries a digest
of the source and the flags. Every ``LazyDfa`` of the port and every binding here call this library;
the JAX package's bindings are neither imported nor touched. A missing ``g++`` or a failed build raises;
the port never drops to a Python walk.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

__all__ = ["BUILD_DIR", "SOURCE", "GXX_FLAGS", "anchored_spans", "available",
           "dfa_scan", "dfa_scan_multi", "dfa_scan_speculative", "library",
           "nfa_match_positions", "nfa_scan"]

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "native" / "golden_scan.cpp"
BUILD_DIR = ROOT / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")


def _declare(lib: ctypes.CDLL) -> None:
    """The ctypes signatures of the scanners in ``native/golden_scan.cpp``."""
    i32p = ctypes.POINTER(ctypes.c_int32)
    i16p = ctypes.POINTER(ctypes.c_int16)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    sigs = {
        "nfa_scan": (ctypes.c_int,
                     [i32p, i32p, u8p, i64, i64, u8p, i64, i64p, i32p, i64]),
        "dfa_scan": (i32, [i32p, i32p, u8p, i64, u8p, i64, i32, i64p, u8p]),
        "dfa_scan_multi": (None, [i32p, i32p, u8p, i64, u8p, i64p, i64, i32p,
                                  i64p, i32p]),
        "dfa_scan_multi16": (None, [i16p, i32p, u8p, i64, u8p, i64p, i64,
                                    i32p, i64p, i32p]),
        "lazy_walk": (i64, [i32p, i64, u8p, u8p, u8p, u8p, i64, i32p, i64p]),
        "kgram_level1": (None, [u8p, i64, u8p, i32p, i64, i32p]),
        "kgram_pair": (None, [i32p, i64, i32p, i64, i32p]),
        "lazy_walk_multi": (i64, [i32p, i64, u8p, u8p, u8p, u8p, i64p, i64p,
                                  i32p, i64, i64p, i32, i64]),
        "anchored_spans": (i64, [i32p, u8p, u8p, i32, i32, i64, u8p, i64,
                                 i64p, i64, i64p, i64]),
        "nfa_match_positions": (i64, [i32p, i32p, u8p, i64, i64, u8p, i64,
                                      i32p, i64, i64p, i64]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


@functools.cache
def _built_path() -> Path:
    """Where the build of this source with these flags lives."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libgolden_scan_{digest.hexdigest()[:16]}.so"


def _build() -> Path:
    """Compile the walker (once per source digest) and return its path."""
    lib = _built_path()
    if lib.exists():
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native host walker cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed with exit code {proc.returncode}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent process never loads a partial file
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The portable walker, built and loaded once per process."""
    lib = ctypes.CDLL(str(_build()))
    _declare(lib)
    return lib


def available() -> bool:
    """Whether the host walker can run here: a build of this source exists
    or ``g++`` is on the path. The walker is then built and loaded, and a
    build that fails raises."""
    if library.cache_info().currsize:
        return True
    if not (_built_path().exists() or shutil.which("g++")):
        return False
    library()
    return True


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def dfa_scan(table: np.ndarray, class_of: np.ndarray, accept: np.ndarray,
             stream: np.ndarray, start: int = 0, want_mask: bool = True):
    """The single-cursor DFA walk over ``table`` (C, S) int32 with byte
    classes ``class_of`` (256,): accept is counted before each byte and the
    last byte's accept is dropped. Returns (counts (S,) int64, match mask
    (len,) bool or None, final state). Raises on a transition out of
    [0, S): the C walk indexes the table unchecked."""
    lib = library()
    _, s = table.shape
    _check_table_domain(np.asarray(table), s)
    table = np.ascontiguousarray(table, dtype=np.int32)
    class_of = np.ascontiguousarray(class_of, dtype=np.int32)
    accept8 = np.ascontiguousarray(accept, dtype=np.uint8)
    stream = np.ascontiguousarray(stream, dtype=np.uint8)
    counts = np.zeros(s, dtype=np.int64)
    mask = np.zeros(len(stream), dtype=np.uint8) if want_mask else None
    final = lib.dfa_scan(
        _ptr(table, ctypes.c_int32), _ptr(class_of, ctypes.c_int32),
        _ptr(accept8, ctypes.c_uint8), s,
        _ptr(stream, ctypes.c_uint8), len(stream), int(start),
        _ptr(counts, ctypes.c_int64),
        _ptr(mask, ctypes.c_uint8) if want_mask else None,
    )
    return counts, (mask.astype(bool) if want_mask else None), int(final)


def _check_table_domain(table: np.ndarray, s: int) -> None:
    """The host side of the ``domain_ok`` guard: a transition target out of
    [0, S) (a corrupt build or a truncated file) raises here instead of
    walking off the counts and accept arrays."""
    if not ((table >= 0) & (table < s)).all():
        raise RuntimeError(
            "native DFA walk: transition table contains out-of-domain "
            "state ids (SURVEY.md §5.2 guard) — corrupt table"
        )


def nfa_match_positions(delta: np.ndarray, class_of: np.ndarray,
                        accept: np.ndarray, stream: np.ndarray,
                        active: np.ndarray | None = None,
                        active_cap: int = 1024) -> np.ndarray:
    """Byte offsets where an accepting NFA state is active (the native
    active-set walk over the dense (C, S+1, K) table; oracle timing: one
    byte late, the final position's accept dropped), from the ``active``
    list (sentinel S pads it; default: the start state 0 in a list of
    ``active_cap``). Raises on active-set overflow. Returns ascending int64
    offsets."""
    lib = library()
    _, s1, k = delta.shape
    s = s1 - 1
    delta = np.ascontiguousarray(delta, dtype=np.int32)
    class_of = np.ascontiguousarray(class_of, dtype=np.int32)
    accept8 = np.ascontiguousarray(accept, dtype=np.uint8)
    stream = np.ascontiguousarray(stream, dtype=np.uint8)
    if active is None:
        active = np.full(active_cap, s, dtype=np.int32)
        active[0] = 0
    active = np.ascontiguousarray(active, dtype=np.int32)
    cap = max(1024, len(stream) // 4)
    while True:
        out = np.empty(cap, dtype=np.int64)
        n = lib.nfa_match_positions(
            _ptr(delta, ctypes.c_int32), _ptr(class_of, ctypes.c_int32),
            _ptr(accept8, ctypes.c_uint8), s, k,
            _ptr(stream, ctypes.c_uint8), len(stream),
            _ptr(active, ctypes.c_int32), len(active),
            _ptr(out, ctypes.c_int64), cap,
        )
        if n == -2:
            raise RuntimeError("native nfa_match_positions: active-set "
                               "capacity exceeded")
        if n >= 0:
            return out[:n]
        cap = min(cap * 4, len(stream) + 1)


def anchored_spans(table: np.ndarray, accept: np.ndarray,
                   accept_eof: np.ndarray, start_state: int, dead: int,
                   stream: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """The forward stage of span extraction: from each ascending candidate
    start, the longest match of the anchored DFA (``table`` (256, S) int32,
    indexed by the raw byte), skipping starts inside an earlier span.
    Returns an (n, 2) int64 array of (start, end)."""
    lib = library()
    _, s = table.shape
    table = np.ascontiguousarray(table, dtype=np.int32)
    accept8 = np.ascontiguousarray(accept, dtype=np.uint8)
    eof8 = np.ascontiguousarray(accept_eof, dtype=np.uint8)
    stream = np.ascontiguousarray(stream, dtype=np.uint8)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    cap = max(16, len(starts))  # at most one span per start
    while True:
        out = np.empty((cap, 2), dtype=np.int64)
        n = lib.anchored_spans(
            _ptr(table, ctypes.c_int32), _ptr(accept8, ctypes.c_uint8),
            _ptr(eof8, ctypes.c_uint8), int(start_state), int(dead), s,
            _ptr(stream, ctypes.c_uint8), len(stream),
            _ptr(starts, ctypes.c_int64), len(starts),
            _ptr(out, ctypes.c_int64), cap,
        )
        if n >= 0:
            return out[:n]
        cap *= 2


def nfa_scan(delta: np.ndarray, class_of: np.ndarray, accept: np.ndarray,
             stream: np.ndarray, active: np.ndarray | None = None,
             counts: np.ndarray | None = None, active_cap: int = 1024):
    """The serial active-set NFA walk over the dense (C, S+1, K) table
    (sentinel S), resumable: pass the ``active`` list and ``counts`` that a
    call returned. Returns (counts (S+1,) int64, final active (cap,) int32).
    Raises on an active-set overflow."""
    lib = library()
    _, s1, k = delta.shape
    s = s1 - 1
    delta = np.ascontiguousarray(delta, dtype=np.int32)
    class_of = np.ascontiguousarray(class_of, dtype=np.int32)
    accept8 = np.ascontiguousarray(accept, dtype=np.uint8)
    stream = np.ascontiguousarray(stream, dtype=np.uint8)
    if counts is None:
        counts = np.zeros(s + 1, dtype=np.int64)
    if active is None:
        active = np.full(active_cap, s, dtype=np.int32)
        active[0] = 0
    active = np.ascontiguousarray(active, dtype=np.int32)
    rc = lib.nfa_scan(
        _ptr(delta, ctypes.c_int32), _ptr(class_of, ctypes.c_int32),
        _ptr(accept8, ctypes.c_uint8), s, k,
        _ptr(stream, ctypes.c_uint8), len(stream),
        _ptr(counts, ctypes.c_int64), _ptr(active, ctypes.c_int32), len(active),
    )
    if rc:
        raise RuntimeError("native nfa_scan: active-set capacity exceeded")
    return counts, active


def _as_bytes(stream) -> np.ndarray:
    if isinstance(stream, (bytes, bytearray, memoryview)):
        stream = np.frombuffer(stream, dtype=np.uint8)
    return np.ascontiguousarray(stream, dtype=np.uint8)


#: int16 copies of tables, keyed by the source array's identity; the entry
#: holds the source too, so that its id is not reused while the entry lives.
#: A host scan of many chunks then converts its table once.
_TAB16_MEMO: dict = {}


def _as_table16(table: np.ndarray) -> np.ndarray:
    hit = _TAB16_MEMO.get(id(table))
    if hit is not None and hit[0] is table:
        return hit[1]
    conv = np.ascontiguousarray(table, dtype=np.int16)
    if len(_TAB16_MEMO) >= 8:
        _TAB16_MEMO.pop(next(iter(_TAB16_MEMO)))
    _TAB16_MEMO[id(table)] = (table, conv)
    return conv


#: inputs below this many bytes walk in one call: a thread split costs more
#: than it saves there
THREAD_MIN_BYTES = 1 << 21


def dfa_scan_multi(table: np.ndarray, class_of: np.ndarray,
                   accept: np.ndarray, streams, starts=0):
    """The interleaved multi-cursor DFA walk (the host backend of the engine
    router): per-stream per-state accept-visit counts and final states of
    every stream, with the single-cursor walk's timing (accept counted
    before each byte, the last byte's accept dropped). The table goes to the
    walker as int16 while S < 2^15 (half the cache footprint). Above 2 MiB
    the streams are cut into one range a core, balanced by bytes, and the
    ranges walk side by side (ctypes releases the GIL). Returns (counts (n,
    S) int64, finals (n,) int32). Raises on a transition out of [0, S)."""
    lib = library()
    _, s = table.shape
    _check_table_domain(np.asarray(table), s)
    use16 = s < (1 << 15)
    table = (_as_table16(table) if use16
             else np.ascontiguousarray(table, dtype=np.int32))
    entry = lib.dfa_scan_multi16 if use16 else lib.dfa_scan_multi
    tab_t = ctypes.c_int16 if use16 else ctypes.c_int32
    class_of = np.ascontiguousarray(class_of, dtype=np.int32)
    accept8 = np.ascontiguousarray(accept, dtype=np.uint8)
    bufs = [_as_bytes(st) for st in streams]
    n = len(bufs)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(b) for b in bufs], out=offsets[1:])
    concat = np.concatenate(bufs) if n else np.zeros(0, np.uint8)
    starts = np.ascontiguousarray(np.broadcast_to(np.asarray(starts), (n,)),
                                  dtype=np.int32)
    counts = np.zeros((n, s), dtype=np.int64)
    finals = np.zeros(n, dtype=np.int32)

    def run(lo: int, hi: int) -> None:
        # each range writes its own rows of counts and finals, in place
        off = offsets[lo : hi + 1] - offsets[lo]
        sub = concat[offsets[lo] : offsets[hi]]
        entry(_ptr(table, tab_t), _ptr(class_of, ctypes.c_int32),
              _ptr(accept8, ctypes.c_uint8), s,
              _ptr(sub, ctypes.c_uint8), _ptr(off, ctypes.c_int64), hi - lo,
              _ptr(starts[lo:hi], ctypes.c_int32),
              _ptr(counts[lo:hi], ctypes.c_int64),
              _ptr(finals[lo:hi], ctypes.c_int32))

    threads = min(os.cpu_count() or 1, n)
    if n == 0:
        pass
    elif threads <= 1 or int(offsets[-1]) < THREAD_MIN_BYTES:
        run(0, n)
    else:
        target = int(offsets[-1]) / threads
        cuts = [0]
        for t in range(1, threads):
            cut = int(np.searchsorted(offsets, t * target))
            cuts.append(max(cuts[-1], min(cut, n)))
        cuts.append(n)
        with ThreadPoolExecutor(max_workers=threads) as ex:
            list(ex.map(lambda ab: run(*ab),
                        [(a, b) for a, b in zip(cuts, cuts[1:]) if b > a]))
    return counts, finals


def dfa_scan_speculative(table: np.ndarray, class_of: np.ndarray,
                         accept: np.ndarray, stream, start: int = 0,
                         segments: int = 32, overlap: int = 64):
    """One stream at the multi-cursor rate: the stream is cut into
    ``segments``; each segment's entry state is guessed by replaying the
    ``overlap`` bytes before it from ``start``; all segments walk as cursors
    of one ``dfa_scan_multi``; then the seams are checked (the final state of
    segment i must be the entry of segment i+1) and the segments after a
    wrong guess walk again from the corrected entry, until every seam holds.
    Exact by the same induction as the device engine; an automaton whose
    seams never close falls back to the serial walk. Returns (counts (S,)
    int64, final state)."""
    stream = _as_bytes(stream)
    n = len(stream)
    seg = n // max(segments, 1)
    if segments <= 1 or seg < 4 * max(overlap, 16):
        c, _, f = dfa_scan(table, class_of, accept, stream, start=start,
                           want_mask=False)
        return c, f
    bounds = [i * seg for i in range(segments)] + [n]
    parts = [stream[bounds[i] : bounds[i + 1]] for i in range(segments)]
    tails = [stream[max(b - overlap, 0) : b] for b in bounds[1:-1]]
    _, tail_finals = dfa_scan_multi(table, class_of, accept, tails,
                                    starts=start)
    entries = np.empty(segments, np.int32)
    entries[0] = start
    entries[1:] = tail_finals
    counts, finals = dfa_scan_multi(table, class_of, accept, parts,
                                    starts=entries)
    for _ in range(segments):
        bad = np.nonzero(finals[:-1] != entries[1:])[0]
        if len(bad) == 0:
            return counts.sum(axis=0), int(finals[-1])
        redo = bad + 1
        entries[redo] = finals[redo - 1]
        c2, f2 = dfa_scan_multi(table, class_of, accept,
                                [parts[i] for i in redo], starts=entries[redo])
        counts[redo] = c2
        finals[redo] = f2
    c, _, f = dfa_scan(table, class_of, accept, stream, start=start,
                       want_mask=False)
    return c, f
