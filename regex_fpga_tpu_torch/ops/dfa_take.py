"""Jacobi chain scan for large state spaces (lazy subset DFAs), on K1/K2.

The counterpart of ``regex_fpga_tpu/ops/dfa_take.py``. A step of each block
lane is one table load ``table[cls, state]`` from the (C, M+1) snapshot of a
lazy subset DFA, whose last state ``M`` is the absorbing UNKNOWN sentinel
for the unexpanded frontier. That is the K1/K2 chain step, so every pass
here runs on ``hopper_dfa`` (on the card the table is read through the
global-memory route when it exceeds shared memory).

Block entries are first guessed by overlap synchronization: lane n replays
the last ``sync_overlap`` bytes of block n-1 from the hub state
``sync_state``. A Jacobi fixpoint (entries <- shifted finals, at most
``max_iters`` passes, a host check of a device flag per pass) then settles
them, as the JAX ``while_loop`` does, with the same iteration count.

``start`` may be a 0-d tensor on the device, so that the chunks of one
stream chain through their final states without a host sync.

Unknown-frontier semantics: positions at and after the first unknown visit
in a block are garbage, everything before is exact; a chunk whose LAST
transition lands on the unknown state counts as touching the frontier too.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .hopper_dfa import dfa_chain, dfa_chain_counts

__all__ = ["TakeCountsResult", "TakeScanResult", "dfa_scan_take",
           "dfa_scan_take_counts"]


class TakeScanResult(NamedTuple):
    final_state: torch.Tensor   # () int32
    states: torch.Tensor        # (L,) int32: state before consuming byte i
    converged: bool
    iterations: int


class TakeCountsResult(NamedTuple):
    final_state: torch.Tensor   # () int32
    visits_acc: torch.Tensor    # (M+1,) int32 accumulated visits (see below)
    converged: bool
    unknown_hit: torch.Tensor   # () bool: the chunk touched the frontier
    iterations: int


def _blocks(classes: torch.Tensor, num_blocks: int) -> torch.Tensor:
    """(B, NB) class columns: a block-major view of the stream, no copy."""
    l = classes.shape[0]
    if num_blocks < 1 or l % num_blocks:
        raise ValueError(f"{l} bytes do not split into {num_blocks} blocks")
    return classes.reshape(num_blocks, l // num_blocks).T


def _start(start, device) -> torch.Tensor:
    return torch.as_tensor(start, dtype=torch.int32, device=device).reshape(1)


def _settle(table, accept, cls_seq, start, sync_overlap, sync_state, max_iters):
    """Overlap-synchronized guesses, then the Jacobi fixpoint. Returns
    (entries (NB,), converged, iterations)."""
    b, nb = cls_seq.shape
    w = min(sync_overlap, b)
    if w <= 0:
        entries = start.expand(nb).clone()
    else:
        hub = torch.full((nb,), sync_state, dtype=torch.int32,
                         device=cls_seq.device)
        ov = dfa_chain(table, accept, cls_seq[b - w:], hub, "finals")[0]
        entries = torch.cat([start, ov[:-1]])
    converged, it = False, 0
    while not converged and it < max_iters:
        finals = dfa_chain(table, accept, cls_seq, entries, "finals")[0]
        new = torch.cat([start, finals[:-1]])
        converged = bool(torch.equal(new, entries))
        entries, it = new, it + 1
    return entries, converged, it


def dfa_scan_take(table: torch.Tensor, classes: torch.Tensor,
                  num_blocks: int = 4096, start=0, max_iters: int = 16,
                  sync_overlap: int = 64, sync_state: int = 0) -> TakeScanResult:
    """Scan (L,) class ids through the (C, M+1) int32 table; returns the
    state before every byte."""
    accept = torch.zeros(table.shape[1], dtype=torch.bool, device=table.device)
    cls_seq = _blocks(classes, num_blocks)
    start = _start(start, table.device)
    entries, converged, it = _settle(table, accept, cls_seq, start,
                                     sync_overlap, sync_state, max_iters)
    finals, states, _ = dfa_chain(table, accept, cls_seq, entries, "full")
    return TakeScanResult(final_state=finals[-1], states=states.T.reshape(-1),
                          converged=converged, iterations=it)


def dfa_scan_take_counts(table: torch.Tensor, classes: torch.Tensor,
                         visits_acc: torch.Tensor, accept: torch.Tensor,
                         num_blocks: int = 1024, start=0, max_iters: int = 16,
                         sync_overlap: int = 64,
                         sync_state: int = 0) -> TakeCountsResult:
    """Chunk scan with visit counting on the device.

    The count pass is K2 with ``accept``, which the caller makes "accepting
    subset states, plus the unknown state M": ``visits_acc[s]`` then gains
    the chunk's visits of every such state, and 0 for every other. Those
    are exactly the entries that ``LazyDfa.accept_counts`` (accepting
    subsets) and ``unknown_hit`` (state M) read; the JAX engine counts every
    state. The visits are added only when the chunk is clean (converged and
    off the frontier); otherwise ``visits_acc`` comes back unchanged and the
    caller re-runs the chunk. ``visits_acc`` is not modified in place."""
    m1 = table.shape[1]
    if accept.shape != (m1,) or not bool(accept[m1 - 1]):
        raise ValueError("accept must be an (M+1,) mask that includes the "
                         "unknown state M")
    cls_seq = _blocks(classes, num_blocks)
    start = _start(start, table.device)
    entries, converged, it = _settle(table, accept, cls_seq, start,
                                     sync_overlap, sync_state, max_iters)
    finals, visits = dfa_chain_counts(table, accept, cls_seq, entries)
    final = finals[-1]
    # frontier escape shows as a visited unknown (the state before some
    # byte) or as the LAST transition landing on it
    unknown_hit = (visits[m1 - 1] > 0) | (final == m1 - 1)
    ok = ~unknown_hit & converged
    new_acc = torch.where(ok, visits_acc + visits, visits_acc)
    return TakeCountsResult(final_state=final, visits_acc=new_acc,
                            converged=converged, unknown_hit=unknown_hit,
                            iterations=it)
