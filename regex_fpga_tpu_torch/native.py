"""The native host walker, built from source without ``-march=native``.

The lazy subset DFA (``models.LazyDfa``) walks the host through the C++
scanners of ``native/golden_scan.cpp``, and so do the forward stage of
span extraction (``anchored_spans``) and the Snort verify's pcre check
(``dfa_scan``, the single-cursor DFA walk). The JAX package loads them from a
library committed beside that source and built with ``-march=native``, which
can die of an illegal instruction on another CPU instead of raising. The
port never opens that file: at first use it compiles the same source with
``g++ -O3 -shared -fPIC`` (portable code for the running architecture) into
``build/native/`` at the repository root, under a name that carries a digest
of the source and the flags. Every ``LazyDfa`` of the port,
``nfa_match_positions``, ``anchored_spans`` and ``dfa_scan`` call this
library; the JAX
package's bindings are neither imported nor touched. A missing ``g++`` or a failed build raises;
the port never drops to a Python walk.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["BUILD_DIR", "SOURCE", "GXX_FLAGS", "anchored_spans", "dfa_scan",
           "library", "nfa_match_positions"]

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


def _build() -> Path:
    """Compile the walker (once per source digest) and return its path."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    lib = BUILD_DIR / f"libgolden_scan_{digest.hexdigest()[:16]}.so"
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
                        active_cap: int) -> np.ndarray:
    """Byte offsets where an accepting NFA state is active (the native
    active-set walk over the dense (C, S+1, K) table; oracle timing: one
    byte late, the final position's accept dropped). Raises on active-set
    overflow. Returns ascending int64 offsets."""
    lib = library()
    _, s1, k = delta.shape
    s = s1 - 1
    delta = np.ascontiguousarray(delta, dtype=np.int32)
    class_of = np.ascontiguousarray(class_of, dtype=np.int32)
    accept8 = np.ascontiguousarray(accept, dtype=np.uint8)
    stream = np.ascontiguousarray(stream, dtype=np.uint8)
    active = np.full(active_cap, s, dtype=np.int32)
    active[0] = 0
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
