"""Bounded active-set NFA engine: the bit-exact conformance path.

The counterpart of ``regex_fpga_tpu/ops/nfa_engine.py``. The active set is
carried as a bounded sorted list of NFA states (sentinel ``S`` as padding);
one step counts the accepting states of the list before the byte, gathers
their successors and keeps the A smallest distinct ones, flagging overflow
when the bound is exceeded. The whole byte loop is one launch of K4
(``hopper_nfa.nfa_active_scan``) for tensors on a CUDA card, and its plain
version on the CPU.

Match semantics: a state is counted iff it accepts and is in the list when
a byte is scanned; accepts entered by the final byte are never counted.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .hopper_nfa import nfa_active_scan
from .tables import NfaCsr, host_to_device

__all__ = ["DEFAULT_ACTIVE_BOUND", "NfaScanResult", "initial_active",
           "nfa_scan", "nfa_scan_batch", "nfa_scan_streams"]

DEFAULT_ACTIVE_BOUND = 128


class NfaScanResult(NamedTuple):
    counts: torch.Tensor        # (S,) or (N, S) int32 per-state match counts
    final_active: torch.Tensor  # (A,) or (N, A) int32 sorted, sentinel-padded
    overflowed: torch.Tensor    # () or (N,) bool: the active bound was exceeded


def initial_active(num_states: int, active_bound: int, n: int = 1,
                   device=None) -> torch.Tensor:
    """(n, A) start lists: state 0, then sentinels."""
    act = torch.full((n, active_bound), num_states, dtype=torch.int32,
                     device=device)
    act[:, 0] = 0
    return act


def _as_bytes(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.uint8)
    return host_to_device(x, device, np.uint8)


def nfa_scan_streams(tables: NfaCsr, data: torch.Tensor, starts, lengths,
                     active_bound: int = DEFAULT_ACTIVE_BOUND,
                     start_active: torch.Tensor | None = None,
                     counts_init: torch.Tensor | None = None) -> NfaScanResult:
    """N streams, slices of the flat uint8 ``data`` (on the tables' device),
    in one pass. ``start_active`` (N, A) and ``counts_init`` (N, S+1) resume
    each stream from a carry. Returns the (N, S+1) counts, sentinel slot
    included, so that they chain as the next ``counts_init``."""
    s = tables.num_states
    n = len(starts)
    dev = tables.device
    if start_active is None:
        start_active = initial_active(s, active_bound, n, dev)
    if counts_init is None:
        counts_init = torch.zeros((n, s + 1), dtype=torch.int32, device=dev)
    return NfaScanResult(*nfa_active_scan(tables, data, starts, lengths,
                                          start_active, counts_init))


def nfa_scan(tables: NfaCsr, stream, active_bound: int = DEFAULT_ACTIVE_BOUND,
             start_active: torch.Tensor | None = None,
             counts_init: torch.Tensor | None = None) -> NfaScanResult:
    """Scan one uint8 stream; returns per-state counts (S,), the final list
    (A,) and the overflow flag.

    ``start_active`` (A,) and ``counts_init`` (S+1,) resume a stream across
    chunk boundaries: pass the previous chunk's ``final_active`` and its
    counts with a zero appended."""
    dev = tables.device
    data = _as_bytes(stream, dev).reshape(-1)
    res = nfa_scan_streams(
        tables, data, [0], [data.shape[0]], active_bound,
        None if start_active is None
        else start_active.to(dev, torch.int32).reshape(1, -1),
        None if counts_init is None
        else counts_init.to(dev, torch.int32).reshape(1, -1),
    )
    return NfaScanResult(res.counts[0, :tables.num_states],
                         res.final_active[0], res.overflowed[0])


def nfa_scan_batch(tables: NfaCsr, streams,
                   active_bound: int = DEFAULT_ACTIVE_BOUND) -> NfaScanResult:
    """Batched scan over (B, L) streams, each from the start list; per-stream
    counts (B, S), lists (B, A) and flags (B,)."""
    data = _as_bytes(streams, tables.device)
    b, l = data.shape
    res = nfa_scan_streams(tables, data.reshape(-1), np.arange(b) * l,
                           np.full(b, l), active_bound)
    return NfaScanResult(res.counts[:, :tables.num_states], res.final_active,
                         res.overflowed)
