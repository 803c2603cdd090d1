"""Exact DFA scans that need no convergence: the fallback of the fast engine.

The counterpart of ``regex_fpga_tpu/ops/dfa_engine.py``, in plain torch. The
blocked scan composes transition functions: pass 1 steps all S start states
through each block, giving the block's function f: S -> S; an exclusive
prefix composition (log depth, ``torch.gather``) gives every block its true
entry state; pass 2 rescans each block from it. It is exact for any
automaton, including those the fast engine's Jacobi seams never settle
(parity counters), at S times the work of a chain pass. It has no Hopper
kernel yet: ``DfaMatcher`` reaches it only when the fast engine reports
non-convergence.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .tables import DfaTables

__all__ = [
    "DfaScanResult",
    "block_entry_states",
    "block_transition_functions",
    "compose",
    "dfa_scan_blocked",
    "dfa_scan_serial",
]


class DfaScanResult(NamedTuple):
    counts: torch.Tensor             # (S,) int32 per-state match counts
    final_state: torch.Tensor        # () int32 state after the full stream
    match_mask: torch.Tensor         # (L,) bool: accept fired before byte i
    states: torch.Tensor | None = None  # (L,) int32: state before byte i


def compose(f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Composition of transition functions: apply ``f`` first, then ``g``.
    Shapes (..., S); returns h with h[s] = g[f[s]]."""
    return torch.gather(g, -1, f.long())


def _as_numpy_bytes(stream) -> np.ndarray:
    if isinstance(stream, torch.Tensor):
        return stream.cpu().numpy().astype(np.uint8, copy=False)
    return np.asarray(stream, dtype=np.uint8)


def dfa_scan_serial(tables: DfaTables, stream, start: int = 0) -> DfaScanResult:
    """Strictly serial scan: a host loop with one table lookup per byte.

    It loops once per byte, so it is used only on short tails: the fewer
    than k bytes after the last whole k-gram step of ``DfaMatcher.count``,
    and the fewer than 1024 bytes after the last whole block of an
    exact-fallback chunk. Results lie on the tables' device."""
    data = _as_numpy_bytes(stream)
    table = tables.table.cpu().numpy()
    class_of = tables.class_of.cpu().numpy()
    accept = tables.accept.cpu().numpy()
    counts = np.zeros(tables.num_states, dtype=np.int32)
    mask = np.zeros(len(data), dtype=bool)
    states = np.empty(len(data), dtype=np.int32)
    s = int(start)
    for i, byte in enumerate(data.tolist()):
        states[i] = s
        if accept[s]:
            mask[i] = True
            counts[s] += 1
        s = int(table[class_of[byte], s])
    dev = tables.device
    return DfaScanResult(
        counts=torch.as_tensor(counts, device=dev),
        final_state=torch.tensor(s, dtype=torch.int32, device=dev),
        match_mask=torch.as_tensor(mask, device=dev),
        states=torch.as_tensor(states, device=dev),
    )


def block_transition_functions(tables: DfaTables,
                               classes: torch.Tensor) -> torch.Tensor:
    """Pass 1. ``classes``: (NB, B) byte-class ids. Returns (NB, S) int32
    block functions: f[n, s] = state after block n when entered in state s."""
    nb = classes.shape[0]
    s = tables.num_states
    flat = tables.table.reshape(-1)
    states = torch.arange(s, dtype=torch.int32, device=classes.device)
    states = states.expand(nb, s)
    for t in range(classes.shape[1]):
        states = torch.take(flat, classes[:, t:t + 1].long() * s + states)
    return states


def block_entry_states(block_fns: torch.Tensor,
                       start: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Combine. Returns (entry_states (NB,), final_state ()).

    entry_states[n] is the state at the start of block n when the stream is
    entered at ``start``: an exclusive prefix composition of the block
    functions, computed by log-depth doubling."""
    prefix = block_fns
    n = prefix.shape[0]
    d = 1
    while d < n:
        prefix = torch.cat([prefix[:d], compose(prefix[:-d], prefix[d:])])
        d *= 2
    first = torch.full((1,), start, dtype=torch.int32, device=block_fns.device)
    entry = torch.cat([first, prefix[:-1, start].to(torch.int32)])
    return entry, prefix[-1, start].to(torch.int32)


def dfa_scan_blocked(
    tables: DfaTables,
    stream: torch.Tensor,
    block_size: int = 1024,
    start: int = 0,
) -> DfaScanResult:
    """Block-parallel scan with exact reference match semantics; ``stream``
    is (L,) bytes with L a multiple of ``block_size``."""
    l = stream.shape[0]
    if l % block_size:
        raise ValueError("pad stream to a multiple of block_size")
    nb = l // block_size
    s = tables.num_states
    classes = torch.take(tables.class_of, stream.long()).reshape(nb, block_size)

    entry, final_state = block_entry_states(
        block_transition_functions(tables, classes), start
    )
    # pass 2: exact rescan of each block from its true entry state
    flat = tables.table.reshape(-1)
    visited = torch.empty((nb, block_size), dtype=torch.int32,
                          device=stream.device)
    state = entry
    for t in range(block_size):
        visited[:, t] = state
        state = torch.take(flat, classes[:, t].long() * s + state)
    visited = visited.reshape(-1)
    is_match = torch.take(tables.accept, visited.long())
    counts = torch.bincount(visited[is_match].long(), minlength=s)[:s]
    return DfaScanResult(
        counts=counts.to(torch.int32),
        final_state=final_state,
        match_mask=is_match,
        states=visited,
    )
