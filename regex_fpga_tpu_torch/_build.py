"""Build and load the port's hand-written CUDA kernels.

The kernels in ``csrc/*.cu`` expose a plain C interface. The first time a
CUDA tensor reaches one of their wrappers, they are compiled with ``nvcc`` for
Hopper (``sm_90a``) into one shared library under ``build/kernels/`` at the
repository root, and loaded with ``ctypes``. The library's name carries a
digest of the sources and flags, so an edited source is never served by a
stale build. Nothing here runs at import time: the CPU-only tests never look
for ``nvcc``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["BuildInfo", "build", "library", "check"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: str
    seconds: float  # nvcc wall time; 0.0 when an existing build was reused
    log: str        # nvcc's output, including ptxas' register/smem report


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


@functools.cache
def build() -> BuildInfo:
    """Compile ``csrc/*.cu`` into one shared library (once per process, and
    only when no library with the same source digest exists)."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    lib = BUILD_DIR / f"libregex_hopper_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return BuildInfo(str(lib), 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent process never loads a partial file
    return BuildInfo(str(lib), seconds, proc.stdout + proc.stderr)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, with every entry point's signature declared
    (pointers and the stream as ``c_void_p``, so none is cut to 32 bits)."""
    lib = ctypes.CDLL(build().path)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dfa_chain.argtypes = [
        p, i, ll, ll, p, p, i, i, p, i, i, p, p, p, ll, ll, p,
    ]
    lib.dfa_chain_counts.argtypes = [p, i, ll, ll, p, p, i, i, p, i, i, p, p, i, p]
    lib.dfa_chain_route.argtypes = [i, i, i, i, i, i]
    lib.dfa_chain_lanes_per_cta.argtypes = []
    lib.kgram_chain.argtypes = [p, i, ll, ll, p, i, i, p, i, i, p, p, p]
    lib.kgram_chain_route.argtypes = [i, i]
    lib.nfa_active_scan.argtypes = [p, p, p, i, p, p, p, p, i, i, i, i, p, p, p, p]
    lib.nfa_active_route.argtypes = [i, i, i, i, i]
    for fn in (lib.dfa_chain, lib.dfa_chain_counts, lib.dfa_chain_route,
               lib.dfa_chain_lanes_per_cta, lib.kgram_chain,
               lib.kgram_chain_route, lib.nfa_active_scan,
               lib.nfa_active_route):
        fn.restype = i
    return lib


def check(rc: int, name: str) -> None:
    """Raise when a kernel's C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
