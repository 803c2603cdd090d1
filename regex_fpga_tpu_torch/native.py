"""The native host walker, built from source without ``-march=native``.

The lazy subset DFA (``models.LazyDfa``) walks the host through the C++
scanners of ``native/golden_scan.cpp``. The JAX package loads them from a
library committed beside that source and built with ``-march=native``, which
can die of an illegal instruction on another CPU instead of raising. The
port never opens that file: at first use it compiles the same source with
``g++ -O3 -shared -fPIC`` (portable code for the running architecture) into
``build/native/`` at the repository root, under a name that carries a digest
of the source and the flags, and hands that library to every native helper
and every ``LazyDfa`` it creates (``lazy_dfa``). A missing ``g++`` or a
failed build raises; the port never drops to the Python walk.
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

from regex_fpga_tpu.utils import native as _shared

from .models import CsrAutomaton, LazyDfa

__all__ = ["BUILD_DIR", "SOURCE", "GXX_FLAGS", "library", "lazy_dfa",
           "nfa_match_positions"]

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "native" / "golden_scan.cpp"
BUILD_DIR = ROOT / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")


def _declare(lib: ctypes.CDLL) -> None:
    """The ctypes signatures of ``regex_fpga_tpu/utils/native.py``."""
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
    """The portable walker, built and loaded once per process. It is also
    installed as the JAX package's native library, so every helper there
    (``LazyDfa``'s walks, ``nfa_match_positions_native``) calls it instead of
    opening the committed build."""
    lib = ctypes.CDLL(str(_build()))
    _declare(lib)
    _shared._LIB = lib
    return lib


def lazy_dfa(aut: CsrAutomaton) -> LazyDfa:
    """A lazy subset DFA whose host walks run on the portable library."""
    lib = library()
    ld = LazyDfa(aut)
    ld._native = lib
    return ld


def nfa_match_positions(delta: np.ndarray, class_of: np.ndarray,
                        accept: np.ndarray, stream: np.ndarray,
                        active_cap: int) -> np.ndarray:
    """Byte offsets where an accepting NFA state is active (the native
    active-set walk over the dense (C, S+1, K) table). Raises on active-set
    overflow. Returns ascending int64 offsets."""
    library()
    return _shared.nfa_match_positions_native(delta, class_of, accept, stream,
                                              active_cap=active_cap)
