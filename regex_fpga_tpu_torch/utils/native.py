"""The native host walker under the JAX package's names.

``regex_fpga_tpu/utils/native.py`` binds the C++ scanners of
``native/golden_scan.cpp`` as ``native_available`` and ``*_native``; the
port's bindings are ``regex_fpga_tpu_torch.native`` (``available``,
``dfa_scan``, ``nfa_scan``, ...), which build that source portably and stay
the implementation. Each function here has the JAX name and signature and
forwards to its binding there, so code written against the JAX module runs
on the port by changing the package name. Arrays in and out are numpy, as
in JAX.
"""

from __future__ import annotations

import numpy as np

from .. import native

__all__ = [
    "native_available",
    "nfa_scan_native",
    "dfa_scan_native",
    "dfa_scan_multi_native",
    "dfa_scan_speculative_native",
    "anchored_spans_native",
    "nfa_match_positions_native",
]


def native_available() -> bool:
    """Whether the walker can be built and loaded here; ``False`` instead of
    raising when the build or the load fails."""
    try:
        return native.available()
    except (RuntimeError, OSError):
        return False


def nfa_scan_native(
    delta: np.ndarray,      # (C, S+1, K) int32
    class_of: np.ndarray,   # (256,) int32
    accept: np.ndarray,     # (S+1,) bool/uint8
    stream: np.ndarray,     # (len,) uint8
    active: np.ndarray | None = None,
    counts: np.ndarray | None = None,
    active_cap: int = 1024,
):
    """Returns (counts (S+1,) int64, final_active (cap,) int32); raises on
    an active-set overflow (``native.nfa_scan``)."""
    return native.nfa_scan(delta, class_of, accept, stream, active=active,
                           counts=counts, active_cap=active_cap)


def dfa_scan_native(
    table: np.ndarray,      # (C, S) int32
    class_of: np.ndarray,   # (256,) int32
    accept: np.ndarray,     # (S,) bool/uint8
    stream: np.ndarray,     # (len,) uint8
    start: int = 0,
    want_mask: bool = True,
):
    """Returns (counts (S,) int64, match_mask (len,) bool | None, final)
    (``native.dfa_scan``)."""
    return native.dfa_scan(table, class_of, accept, stream, start=start,
                           want_mask=want_mask)


def dfa_scan_multi_native(
    table: np.ndarray,      # (C, S) int32
    class_of: np.ndarray,   # (256,) int32
    accept: np.ndarray,     # (S,) bool/uint8
    streams: list,          # list of uint8 arrays / bytes
    starts: np.ndarray | int = 0,
):
    """Returns (counts (n, S) int64, finals (n,) int32)
    (``native.dfa_scan_multi``)."""
    return native.dfa_scan_multi(table, class_of, accept, streams,
                                 starts=starts)


def dfa_scan_speculative_native(
    table: np.ndarray,      # (C, S) int32
    class_of: np.ndarray,   # (256,) int32
    accept: np.ndarray,     # (S,) bool/uint8
    stream: np.ndarray,
    start: int = 0,
    segments: int = 32,
    overlap: int = 64,
):
    """Returns (counts (S,) int64, final int)
    (``native.dfa_scan_speculative``)."""
    return native.dfa_scan_speculative(table, class_of, accept, stream,
                                       start=start, segments=segments,
                                       overlap=overlap)


def anchored_spans_native(
    table: np.ndarray,       # (256, S) int32, raw-byte indexed anchored DFA
    accept: np.ndarray,      # (S,) bool/uint8
    accept_eof: np.ndarray,  # (S,) bool/uint8
    start_state: int,
    dead: int,
    stream: np.ndarray,      # (len,) uint8
    starts: np.ndarray,      # sorted candidate start offsets
) -> np.ndarray:
    """Returns an (n, 2) int64 span array (``native.anchored_spans``)."""
    return native.anchored_spans(table, accept, accept_eof, start_state,
                                 dead, stream, starts)


def nfa_match_positions_native(
    delta: np.ndarray,      # (C, S+1, K) int32
    class_of: np.ndarray,   # (256,) int32
    accept: np.ndarray,     # (S+1,) bool/uint8
    stream: np.ndarray,     # (len,) uint8
    active: np.ndarray | None = None,
    active_cap: int = 1024,
) -> np.ndarray:
    """Returns ascending int64 match offsets
    (``native.nfa_match_positions``)."""
    return native.nfa_match_positions(delta, class_of, accept, stream,
                                      active=active, active_cap=active_cap)
