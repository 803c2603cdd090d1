"""Fast DFA scan: block-parallel chain lanes with speculative seams.

The counterpart of ``regex_fpga_tpu/ops/dfa_fast.py``. A stream is cut into
``num_blocks`` contiguous blocks, one chain lane per block, and every chain
pass runs on a Hopper kernel (``hopper_dfa``): the table is read directly,
where the TPU engines looked it up with a one-hot matrix product.

Block seams: each lane first replays the last ``overlap`` bytes of the
previous block from the start state. Real automata synchronize within that
window, so the guessed entries are right, and one induction check
(``finals[l-1] == entries[l]``, lane 0 anchored) proves it: one output pass
then suffices. Otherwise a Jacobi fixpoint iterates the entries (a host loop
on a device flag) and the output pass runs again from the fixpoint; the
result is exact whenever ``converged`` is True. Automata that never
synchronize (parity counters) are reported as not converged, and callers
fall back to ``dfa_engine``.

The counts mode waits on the host once when the guess verifies: the
speculation, the counting pass and its verdict are queued, and one copy
brings back the verdict with the counts (``_scan_counts``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.profiling import trace
from .hopper_dfa import dfa_chain, dfa_chain_counts, table_in_range
from .tables import DfaTables

__all__ = [
    "FastScanResult",
    "MultiScanResult",
    "chain_pass_counts",
    "chain_pass_finals",
    "chain_pass_full",
    "chain_pass_mask",
    "dfa_scan_fast",
    "dfa_scan_fast_multi",
    "mask_positions",
    "table_domain_ok",
]


def mask_positions(mask: torch.Tensor, cap: int):
    """Device-side compaction of a (L,) bool mask into match positions: a
    cumsum gives each set bit its output slot and one scatter writes the
    byte offsets densely into a (cap,) int32 array, so the host downloads a
    count and a prefix of positions instead of the whole mask.

    Returns (positions (cap,) int32, slots beyond ``count`` undefined, and
    count, a 0-d tensor). When count > cap the overflow positions are
    dropped and callers read the mask instead."""
    n = mask.shape[0]
    idx = torch.cumsum(mask, 0, dtype=torch.int32) - 1  # slot of each set bit
    count = idx[-1] + 1 if n else torch.zeros((), dtype=torch.int32,
                                              device=mask.device)
    # unset bits and overflow all land in the spare slot ``cap``
    tgt = torch.where(mask & (idx < cap), idx, cap).long()
    pos = torch.zeros(cap + 1, dtype=torch.int32, device=mask.device)
    pos.scatter_(0, tgt, torch.arange(n, dtype=torch.int32, device=mask.device))
    return pos[:cap], count


class FastScanResult(NamedTuple):
    final_state: torch.Tensor            # () int32
    match_mask: torch.Tensor | None      # (L,) bool: accept fired before byte i
    states: torch.Tensor | None          # (L,) int32: state before byte i
    converged: bool
    iterations: int
    counts: torch.Tensor | None = None   # (S,) per-state counts (counts mode)
    #: False means the pass produced out-of-range state ids (a corrupt
    #: table): the results must be discarded, not trusted.
    domain_ok: torch.Tensor | bool = True


class MultiScanResult(NamedTuple):
    final_states: torch.Tensor           # (N,) int32: state after each stream
    counts: torch.Tensor | None          # (N, S) int32 per-stream accept counts
    match_mask: torch.Tensor | None      # (N, L) bool (full mode)
    states: torch.Tensor | None          # (N, L) int32 (full mode)
    converged: bool
    iterations: int
    domain_ok: torch.Tensor | bool = True


def table_domain_ok(tables: DfaTables) -> torch.Tensor:
    """Every transition target is a valid state id. Returns a () bool.

    The JAX guard also checks that the table survives its one-hot matmul
    dtype losslessly; the kernels here read int32 directly, so the range is
    the whole condition."""
    t = tables.table
    return ((t >= 0) & (t < tables.num_states)).all()


def _finals_domain_ok(x: torch.Tensor, s: int) -> torch.Tensor:
    return ((x >= 0) & (x < s)).all()


def chain_pass_finals(tables: DfaTables, cls_seq, entries):
    """Run NB chains over (B, NB) class columns; return final states (NB,)."""
    return dfa_chain(tables.table, tables.accept, cls_seq, entries, "finals")[0]


def chain_pass_full(tables: DfaTables, cls_seq, entries):
    """Output pass: finals (NB,), and the state before each byte and its
    accept bit, both (B, NB)."""
    return dfa_chain(tables.table, tables.accept, cls_seq, entries, "full")


def chain_pass_mask(tables: DfaTables, cls_seq, entries):
    """Mask-only output pass: finals (NB,) and accept bits (B, NB), with no
    states array stored."""
    finals, _, acc = dfa_chain(tables.table, tables.accept, cls_seq, entries,
                               "mask")
    return finals, acc


def chain_pass_counts(tables: DfaTables, cls_seq, entries):
    """Counting pass: finals (NB,) and counts[s] = visits[s] * accept[s]."""
    return dfa_chain_counts(tables.table, tables.accept, cls_seq, entries)


def _chain_pass_counts_multi(tables: DfaTables, cls_seq, entries, n: int):
    """Counting pass with per-stream counts (N, S); lanes are stream-major."""
    return dfa_chain_counts(tables.table, tables.accept, cls_seq, entries,
                            num_streams=n)


def _overlap_seq(blocks: torch.Tensor, ov: int) -> torch.Tensor:
    """(ov, NB) columns: lane l replays the last ``ov`` classes of block
    l-1. Lane 0's rows are junk; its entry is pinned by the caller."""
    b = blocks.shape[1]
    return torch.cat([blocks[:1, b - ov:], blocks[:-1, b - ov:]], dim=0).T


def _run_pass(pass_fn, pass_finals, entries0, shift, max_iters: int):
    """Speculation first: run the output pass from the guessed entries; if
    the guesses verify, its results stand. Otherwise iterate the Jacobi
    fixpoint and run the output pass once more from its entries. Returns
    (pass outputs, converged, iterations), counted as the JAX engine does:
    1 on the speculation path. Each pass, with its convergence read, is an
    ``rf.engine.pass`` span."""
    with trace("rf.engine.pass"):
        out0 = pass_fn(entries0)
        entries = shift(out0[0])
        guessed = bool((entries == entries0).all())
    if guessed:
        return out0, True, 1
    entries, done, it = _jacobi(pass_finals, entries, shift, max_iters)
    with trace("rf.engine.pass"):
        return pass_fn(entries), done, it


def _jacobi(pass_finals, entries, shift, max_iters: int):
    """The Jacobi rounds after a rejected guess, from the entries that the
    first pass shifted in: each round (an ``rf.engine.pass`` span) runs the
    finals pass and reads whether the entries moved. Returns (entries,
    converged, iterations), the first pass counted as iteration 1."""
    done, it = False, 1
    while not done and it < max_iters:
        with trace("rf.engine.pass"):
            new_entries = shift(pass_finals(entries))
            done = bool((new_entries == entries).all())
        entries = new_entries
        it += 1
    return entries, done, it


def _counts_pass(tables: DfaTables, cls_seq, entries):
    """K2 from ``entries`` and its verdict, queued (an ``rf.engine.pass``
    span), then the one read (``rf.device.readback``). Returns (the lanes
    whose final state is not the next lane's entry, the final state,
    whether every final state is in range, the final states on the device,
    the (S,) int32 counts on the host)."""
    with trace("rf.engine.pass"):
        finals, counts = chain_pass_counts(tables, cls_seq, entries)
        lo, hi = torch.aminmax(finals)
        verdict = torch.stack([(finals[:-1] != entries[1:]).sum(dtype=torch.int32),
                               finals[-1], lo, hi])
        out = torch.cat([verdict, counts])
    with trace("rf.device.readback"):  # the host's one wait
        out = out.cpu()
    moved, final, lo, hi = out[:4].tolist()
    return moved, final, 0 <= lo and hi < tables.num_states, finals, out[4:]


def _scan_counts(tables: DfaTables, blocks: torch.Tensor, start: int,
                 max_iters: int, ov: int) -> FastScanResult:
    """``dfa_scan_fast``'s counts mode over (NB, B) class blocks. Nothing
    before the verdict needs a host value: the start state is filled on the
    device, the table's range is read once per table tensor
    (``table_in_range``), and ``_counts_pass`` reads the verdict and the
    counts together, so a pinned upload queued before the call may still be
    in flight until then. A guess that verifies keeps those counts;
    otherwise the Jacobi rounds (``_jacobi``, which ``_run_pass`` shares)
    and the output pass run again. The final state and the counts come back
    on the host."""
    cls_seq = blocks.T
    table_ok = table_in_range(tables.table)
    entries = torch.full((blocks.shape[0],), start, dtype=torch.int32,
                         device=blocks.device)
    start_t = entries[:1]

    def shift(finals):
        return torch.cat([start_t, finals[:-1]])

    if ov > 0:
        spec = chain_pass_finals(tables, _overlap_seq(blocks, ov), entries)
        entries = torch.cat([start_t, spec[1:]])
    moved, final, finals_ok, finals, counts = _counts_pass(tables, cls_seq,
                                                           entries)
    converged, it = moved == 0, 1
    if not converged:
        entries, converged, it = _jacobi(
            lambda e: chain_pass_finals(tables, cls_seq, e), shift(finals),
            shift, max_iters)
        _, final, finals_ok, _, counts = _counts_pass(tables, cls_seq, entries)
    return FastScanResult(
        final_state=torch.tensor(final, dtype=torch.int32), match_mask=None,
        states=None, converged=converged, iterations=it, counts=counts,
        domain_ok=table_ok and finals_ok,
    )


def dfa_scan_fast(
    tables: DfaTables,
    classes: torch.Tensor,
    num_blocks: int = 65536,
    start: int = 0,
    max_iters: int = 16,
    emit: str = "full",
    overlap: int = 64,
) -> FastScanResult:
    """Scan a class stream (L,) whose length divides into ``num_blocks``.

    ``emit``: "full" returns the state and accept bit before every byte,
    "mask" only the accept bits, "counts" only the per-state accept-visit
    counts (with the final state on the host, ``_scan_counts``).
    ``classes`` may be uint8, int16 or int32 and lies on the device that
    runs the scan."""
    if emit not in ("full", "mask", "counts"):
        raise ValueError(f"emit must be full, mask or counts, got {emit!r}")
    l = classes.shape[0]
    if l % num_blocks:
        raise ValueError("stream length must be divisible by num_blocks")
    b = l // num_blocks
    dev = classes.device
    blocks = classes.reshape(num_blocks, b)
    if emit == "counts":
        return _scan_counts(tables, blocks, start, max_iters, min(overlap, b))
    cls_seq = blocks.T  # (B, NB) columns over block-major storage
    s_dim = tables.num_states
    start_t = torch.tensor([start], dtype=torch.int32, device=dev)

    def shift(finals):
        return torch.cat([start_t, finals[:-1]])

    entries0 = torch.full((num_blocks,), start, dtype=torch.int32, device=dev)
    ov = min(overlap, b)
    if ov > 0:
        spec = chain_pass_finals(tables, _overlap_seq(blocks, ov), entries0)
        entries0 = torch.cat([start_t, spec[1:]])

    pass_finals = lambda e: chain_pass_finals(tables, cls_seq, e)
    table_ok = table_domain_ok(tables)

    if emit == "mask":
        (finals, acc), converged, iters = _run_pass(
            lambda e: chain_pass_mask(tables, cls_seq, e),
            pass_finals, entries0, shift, max_iters,
        )
        return FastScanResult(
            final_state=finals[-1], match_mask=acc.T.reshape(-1), states=None,
            converged=converged, iterations=iters,
            domain_ok=table_ok & _finals_domain_ok(finals, s_dim),
        )
    (finals, states, acc), converged, iters = _run_pass(
        lambda e: chain_pass_full(tables, cls_seq, e),
        pass_finals, entries0, shift, max_iters,
    )
    # (B, NB) block-major storage: .T.reshape(-1) is stream order, no copy
    return FastScanResult(
        final_state=finals[-1],
        match_mask=acc.T.reshape(-1),
        states=states.T.reshape(-1),
        converged=converged,
        iterations=iters,
        domain_ok=(table_ok & _finals_domain_ok(finals, s_dim)
                   & _finals_domain_ok(states, s_dim)),
    )


def dfa_scan_fast_multi(
    tables: DfaTables,
    classes: torch.Tensor,
    num_blocks: int = 256,
    starts: torch.Tensor | int = 0,
    max_iters: int = 16,
    emit: str = "counts",
    overlap: int = 64,
) -> MultiScanResult:
    """Batch scan of N equal-length independent streams, ``classes`` (N, L),
    in one chain pass: each stream splits into ``num_blocks`` blocks and the
    N * num_blocks lanes run stream-major. A lane that begins a stream has
    its entry pinned to that stream's start (``starts``, scalar or (N,)) in
    the speculation and in every Jacobi shift, so streams stay independent.

    emit="counts": per-stream per-state histograms; emit="full": per-stream
    (N, L) states and match masks."""
    if emit not in ("full", "counts"):
        raise ValueError(f"emit must be full or counts, got {emit!r}")
    n, l = classes.shape
    if l % num_blocks:
        raise ValueError("stream length must be divisible by num_blocks")
    b = l // num_blocks
    nb_tot = n * num_blocks
    dev = classes.device
    blocks = classes.reshape(nb_tot, b)
    cls_seq = blocks.T  # (B, NB_tot), lanes stream-major
    starts_v = torch.as_tensor(starts, dtype=torch.int32, device=dev)
    starts_v = starts_v.reshape(-1).expand(n)
    lane_start = starts_v.repeat_interleave(num_blocks)  # (NB_tot,)
    first = (torch.arange(nb_tot, device=dev) % num_blocks) == 0

    def shift(finals):
        prev = torch.cat([lane_start[:1], finals[:-1]])
        return torch.where(first, lane_start, prev)

    entries0 = lane_start
    ov = min(overlap, b)
    if ov > 0:
        spec = chain_pass_finals(tables, _overlap_seq(blocks, ov), entries0)
        entries0 = torch.where(first, lane_start, spec)

    pass_finals = lambda e: chain_pass_finals(tables, cls_seq, e)
    s_dim = tables.num_states
    table_ok = table_domain_ok(tables)

    if emit == "counts":
        (finals, counts), converged, iters = _run_pass(
            lambda e: _chain_pass_counts_multi(tables, cls_seq, e, n),
            pass_finals, entries0, shift, max_iters,
        )
        return MultiScanResult(
            final_states=finals.reshape(n, num_blocks)[:, -1],
            counts=counts, match_mask=None, states=None,
            converged=converged, iterations=iters,
            domain_ok=table_ok & _finals_domain_ok(finals, s_dim),
        )
    (finals, states, acc), converged, iters = _run_pass(
        lambda e: chain_pass_full(tables, cls_seq, e),
        pass_finals, entries0, shift, max_iters,
    )
    return MultiScanResult(
        final_states=finals.reshape(n, num_blocks)[:, -1],
        counts=None,
        match_mask=acc.T.reshape(n, l),
        states=states.T.reshape(n, l),
        converged=converged,
        iterations=iters,
        domain_ok=(table_ok & _finals_domain_ok(finals, s_dim)
                   & _finals_domain_ok(states, s_dim)),
    )
