"""Exact DFA scans that need no convergence: the fallback of the fast engine.

The counterpart of ``regex_fpga_tpu/ops/dfa_engine.py`` (K6). The blocked
scan composes transition functions: pass 1 steps all S start states through
each block, giving the block's function f: S -> S (``dfa_block_fns``, the
Hopper kernel ``csrc/dfa_block_fns.cu`` on the card, where chains that meet
merge); the combine, an exclusive prefix composition of one start state,
gives every block its true entry state (``dfa_fn_combine``, a kernel of the
same file on the card; log-depth doubling with ``torch.gather`` on the CPU);
pass 2 rescans each block from it (K1's full mode, ``dfa_chain``). It is
exact for any automaton, including those the fast engine's Jacobi seams
never settle (parity counters).
``DfaMatcher`` reaches it only when the fast engine reports non-convergence.

The (NB, S) block functions grow with S (219 MB at 65,536 blocks and
S = 836), so the blocks go through in groups of at most ``FN_GROUP_BYTES``
of functions: the first block of a group is entered in the final state of
the group before it, which keeps the result exact for any S.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .hopper_dfa import check_fn_range, dfa_block_fns, dfa_chain, dfa_fn_combine
from .tables import DfaTables

__all__ = [
    "DfaScanResult",
    "block_entry_states",
    "block_transition_functions",
    "compose",
    "dfa_match_positions",
    "dfa_scan_blocked",
    "dfa_scan_serial",
]

#: the most bytes of block functions that one group of blocks holds
FN_GROUP_BYTES = 64 << 20


class DfaScanResult(NamedTuple):
    counts: torch.Tensor             # (S,) int32 per-state match counts
    final_state: torch.Tensor        # () int32 state after the full stream
    match_mask: torch.Tensor | None  # (L,) bool: accept fired before byte i
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
    block functions: f[n, s] = state after block n when entered in state s
    (K6, ``dfa_block_fns``)."""
    return dfa_block_fns(tables.table, classes)


def block_entry_states(block_fns: torch.Tensor,
                       start=0) -> tuple[torch.Tensor, torch.Tensor]:
    """Combine. Returns (entry_states (NB,), final_state ()).

    entry_states[n] is the state at the start of block n when the stream is
    entered at ``start`` (an int, or a one-element tensor on the functions'
    device): an exclusive prefix composition of the block functions (K6's
    combine, ``dfa_fn_combine``: a kernel on the card, log-depth doubling
    on the CPU). The functions may come from anywhere, so their range is
    checked first on either device (``check_fn_range``: one ``aminmax``
    and one host read): an entry or a ``start`` outside [0, S) raises the
    same ``ValueError`` on the card as on the CPU."""
    check_fn_range(block_fns, start)
    return dfa_fn_combine(block_fns, start)


def dfa_scan_blocked(
    tables: DfaTables,
    stream: torch.Tensor,
    block_size: int = 1024,
    start: int = 0,
    collect_matches: bool = True,
) -> DfaScanResult:
    """Block-parallel scan with exact reference match semantics; ``stream``
    is (L,) bytes with L a multiple of ``block_size``. The blocks go
    through in groups of as many as ``FN_GROUP_BYTES`` of block functions
    hold, each entered in the final state of the one before. Without
    ``collect_matches`` the result keeps no match mask and no states.

    Pass 1 writes every function entry in [0, S), so its functions go to
    the combine unchecked: the scan waits for the device nowhere."""
    l = stream.shape[0]
    if l % block_size:
        raise ValueError("pad stream to a multiple of block_size")
    nb = l // block_size
    s = tables.num_states
    # class ids fit one byte (C <= 256)
    classes = torch.take(tables.class_of.to(torch.uint8),
                         stream.long()).reshape(nb, block_size)
    group = max(1, FN_GROUP_BYTES // (4 * s))
    counts = torch.zeros(s, dtype=torch.int64, device=stream.device)
    masks, states = [], []
    cur = torch.tensor([start], dtype=torch.int32, device=stream.device)
    for g0 in range(0, nb, group):
        cls_g = classes[g0 : g0 + group]
        entry, cur = dfa_fn_combine(block_transition_functions(tables, cls_g),
                                    cur)
        # pass 2: exact rescan of each block from its true entry state (K1's
        # full mode over the block-major class ids: its outputs are stored
        # block-major, so their transposes flatten to stream order)
        _, visited, acc = dfa_chain(tables.table, tables.accept, cls_g.T,
                                    entry, mode="full")
        visited, acc = visited.T.reshape(-1), acc.T.reshape(-1)
        counts += torch.bincount(visited[acc].long(), minlength=s)[:s]
        if collect_matches:
            masks.append(acc)
            states.append(visited)
    if not collect_matches:
        return DfaScanResult(counts=counts.to(torch.int32),
                             final_state=cur.reshape(()), match_mask=None)
    empty = torch.zeros(0, dtype=torch.int32, device=stream.device)
    return DfaScanResult(
        counts=counts.to(torch.int32),
        final_state=cur.reshape(()),
        match_mask=torch.cat(masks) if masks else empty.bool(),
        states=torch.cat(states) if states else empty,
    )


def dfa_match_positions(result: DfaScanResult) -> torch.Tensor:
    """Positions (0-based byte offsets) at which a match fired, int64. With
    the reference timing, a match at position p was entered by byte p-1."""
    if result.match_mask is None:
        raise ValueError("the scan kept no match mask")
    return torch.nonzero(result.match_mask).reshape(-1)
