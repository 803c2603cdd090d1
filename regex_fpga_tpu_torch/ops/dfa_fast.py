"""Fast DFA scan: block-parallel chain lanes with speculative seams.

The counterpart of ``regex_fpga_tpu/ops/dfa_fast.py``. A stream is cut into
``num_blocks`` contiguous blocks, one chain lane per block, and every chain
pass runs on a Hopper kernel (``hopper_dfa``): the table is read directly,
where the TPU engines looked it up with a one-hot matrix product.

Block seams take one protocol in every mode here and in the k-gram engine
(``ops/kgram.py``), in three helpers:

- ``_speculate``: each lane replays the last ``overlap`` steps of its own
  block from its stream's start, in place (a strided view, no copy); its
  final state is the next lane's guessed entry. Real automata synchronize
  within that window.
- ``_round``: a pass from the entries and its verdict are queued, and one
  ``.cpu()`` reads the verdict: the lanes whose final state is not the next
  lane's entry, each stream's final state, the range of the states, and the
  mode's small answer (counts, K3's total). With no such lane the entries
  are proved by induction (``finals[l-1] == entries[l]``, each stream's
  first lane pinned to its start) and the pass's outputs stand.
- ``_jacobi``: otherwise the entries iterate to a fixpoint, a round each;
  the k=1 engines run their finals passes there and the output pass once
  more from the fixpoint. The result is exact whenever ``converged`` is
  True. Automata that never synchronize (parity counters) are reported as
  not converged, and callers fall back to ``dfa_engine``.

Nothing before the read needs a host value: the start states are filled on
the device and the table's range is read once per table tensor
(``table_in_range``), so a pinned upload queued before the call may still
be in flight until then. Masks and states stay on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
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
    final_state: torch.Tensor            # () int32, on the host
    match_mask: torch.Tensor | None      # (L,) bool: accept fired before byte i
    states: torch.Tensor | None          # (L,) int32: state before byte i
    converged: bool
    iterations: int
    counts: torch.Tensor | None = None   # (S,) int32 per-state counts (counts mode), on the host
    #: False means the pass produced out-of-range state ids (a corrupt
    #: table): the results must be discarded, not trusted.
    domain_ok: bool = True


class MultiScanResult(NamedTuple):
    final_states: torch.Tensor           # (N,) int32: state after each stream, on the host
    counts: torch.Tensor | None          # (N, S) int32 per-stream accept counts, on the host
    match_mask: torch.Tensor | None      # (N, L) bool (full mode)
    states: torch.Tensor | None          # (N, L) int32 (full mode)
    converged: bool
    iterations: int
    domain_ok: bool = True


def table_domain_ok(tables: DfaTables) -> torch.Tensor:
    """Every transition target is a valid state id. Returns a () bool.

    The twin of the JAX package's public guard, which also checks that the
    table survives its one-hot matmul dtype losslessly; the kernels here
    read int32 directly, so the range is the whole condition. No engine
    calls it: they read the range once per table tensor
    (``hopper_dfa.table_in_range``)."""
    t = tables.table
    return ((t >= 0) & (t < tables.num_states)).all()


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


class _Lanes(NamedTuple):
    """The chain lanes of a scan, stream-major: ``start`` (NB,) int32 on
    the device, the start state of each lane's stream, and ``per_stream``
    lanes a stream."""

    start: torch.Tensor
    per_stream: int

    def shift(self, finals: torch.Tensor) -> torch.Tensor:
        """Each lane's entry: the final state of the lane before it, each
        stream's first lane pinned to its start."""
        entries = torch.cat([self.start[:1], finals[:-1]])
        if self.per_stream < entries.shape[0]:
            entries[::self.per_stream] = self.start[::self.per_stream]
        return entries


class _Verdict(NamedTuple):
    """One round's read, on the host (numpy views of the one copy: no
    tensor op stands between the read and the caller)."""

    moved: int                  # lanes whose final state misses the next lane's entry
    final_states: np.ndarray    # (N,) int32: the state after each stream
    lo: int                     # the least and the greatest id of the states
    hi: int                     # whose range the pass checks (0, -1: none)
    answer: np.ndarray          # int32: what the pass returns to the host


def _speculate(finals_pass, blocks: torch.Tensor, lanes: _Lanes,
               overlap: int) -> torch.Tensor:
    """Entry guesses for the lanes of (NB, B, ...) ``blocks``: each lane
    replays the last ``overlap`` steps of its own block from its stream's
    start, in place (a strided view, no copy), and its final state is the
    next lane's guess. ``finals_pass(columns, entries)`` returns the final
    states of a (B', NB, ...) view."""
    b = blocks.shape[1]
    ov = min(overlap, b)
    if ov <= 0:
        return lanes.start
    return lanes.shift(finals_pass(blocks[:, b - ov:].transpose(0, 1),
                                   lanes.start))


def _round(pass_fn, entries: torch.Tensor, lanes: _Lanes,
           answer: bool = False):
    """One chain pass from ``entries`` and its verdict, queued in one
    ``rf.engine.pass`` span, then read with one ``.cpu()``: under
    ``rf.device.readback`` where the read carries the chunk's answer
    (``answer``), else as a control read. ``pass_fn(entries)`` returns (the
    pass's outputs, final states first; the state tensors whose range the
    verdict takes; the int32 tensors that ride in the read). Returns (the
    outputs, on the device, and the ``_Verdict``)."""
    with trace("rf.engine.pass"):
        out, ranged, small = pass_fn(entries)
        finals, ps = out[0], lanes.per_stream
        nb = finals.shape[0]
        miss = finals[:-1] != entries[1:]
        if ps < nb:  # a stream's last lane has no next entry
            miss[ps - 1 :: ps] = False
        ranged = [t for t in ranged if t.numel()]
        packed = torch.cat([
            miss.sum(0, keepdim=True, dtype=torch.int32), finals[ps - 1 :: ps],
            *(x.reshape(1) for t in ranged for x in torch.aminmax(t)),
            *(t.reshape(-1) for t in small)])
    if answer:
        with trace("rf.device.readback"):  # the host's one wait
            host = packed.cpu().numpy()
    else:
        host = packed.cpu().numpy()
    n = nb // ps
    k = 1 + n + 2 * len(ranged)
    head = host[:k].tolist()
    lo, hi = (min(head[1 + n :: 2]), max(head[2 + n :: 2])) if ranged else (0, -1)
    return out, _Verdict(head[0], host[1 : 1 + n], lo, hi, host[k:])


def _jacobi(round_fn, out, verdict: _Verdict, lanes: _Lanes, max_iters: int):
    """The Jacobi rounds after a rejected guess: each runs ``round_fn``
    from the entries that the last pass's final states (``out[0]``) shift
    in, until its verdict holds or ``max_iters`` passes have run, the first
    included. Returns (the last round's outputs, its verdict, the passes
    run)."""
    it = 1
    while verdict.moved and it < max_iters:
        out, verdict = round_fn(lanes.shift(out[0]))
        it += 1
    return out, verdict, it


def _scan(tables: DfaTables, classes: torch.Tensor, lanes: _Lanes, emit: str,
          max_iters: int, overlap: int, class_of=None, fold=None):
    """The k=1 engines over (L,) or (N, L) ``classes``, a block a lane
    (``lanes.per_stream`` blocks a stream): the speculation, the
    output pass in ``emit`` mode as the first round, and after a miss the
    Jacobi rounds on finals passes and the output pass again from their
    entries (``iterations``: 1 on the speculation path, else the rounds +
    1, as the JAX engine counts). With ``class_of`` every pass reads
    ``classes`` as raw bytes and maps them itself; ``fold`` (counts mode)
    maps each output pass's counts on the device to what rides in the
    verdict's read in their place. Returns (the output pass's outputs, its
    verdict, converged, iterations, domain_ok)."""
    if classes.shape[-1] % lanes.per_stream:
        raise ValueError("stream length must be divisible by num_blocks")
    blocks = classes.reshape(lanes.start.shape[0], -1)
    cls_seq = blocks.T  # (B, NB) columns over block-major storage
    table, accept = tables.table, tables.accept

    def finals_pass(cols, entries):
        return dfa_chain(table, accept, cols, entries, "finals",
                         class_of=class_of)[0]

    def output(entries):
        if emit == "counts":
            out = dfa_chain_counts(table, accept, cls_seq, entries,
                                   blocks.shape[0] // lanes.per_stream,
                                   class_of=class_of)
            return out, out[:1], out[1:] if fold is None else (fold(out[1]),)
        out = dfa_chain(table, accept, cls_seq, entries, emit,
                        class_of=class_of)
        if emit == "mask":
            out = (out[0], out[2])
        return out, out[:-1], ()

    def finals_only(entries):
        return (finals_pass(cls_seq, entries),), (), ()

    answer = emit == "counts"
    entries = _speculate(finals_pass, blocks, lanes, overlap)
    out, verdict = _round(output, entries, lanes, answer)
    converged, it = verdict.moved == 0, 1
    if not converged:
        out, verdict, it = _jacobi(lambda e: _round(finals_only, e, lanes),
                                   out, verdict, lanes, max_iters)
        converged = verdict.moved == 0
        out, verdict = _round(output, lanes.shift(out[0]), lanes, answer)
    ok = (table_in_range(tables.table) and 0 <= verdict.lo
          and verdict.hi < tables.num_states)
    return out, verdict, converged, it, ok


def dfa_scan_fast(
    tables: DfaTables,
    classes: torch.Tensor,
    num_blocks: int = 65536,
    start: int = 0,
    max_iters: int = 16,
    emit: str = "full",
    overlap: int = 64,
    *,
    class_of: torch.Tensor | None = None,
    fold=None,
) -> FastScanResult:
    """Scan a class stream (L,) whose length divides into ``num_blocks``.

    ``emit``: "full" returns the state and accept bit before every byte,
    "mask" only the accept bits, "counts" only the per-state accept-visit
    counts (read with the verdict). ``classes`` may be uint8, int16 or int32
    and lies on the device that runs the scan; the final state, the counts
    and ``domain_ok`` come back on the host. With ``class_of`` ((256,)
    uint8, the tables' byte-to-class map) ``classes`` holds the raw bytes
    (uint8) and every pass maps them itself, with the results of the scan
    over ``class_of[classes]``. ``fold`` (counts mode) is a function of
    the (S,) int32 counts on the device: its int32 result comes back as
    ``counts`` instead, in the same read as the verdict."""
    if emit not in ("full", "mask", "counts"):
        raise ValueError(f"emit must be full, mask or counts, got {emit!r}")
    lanes = _Lanes(torch.full((num_blocks,), start, dtype=torch.int32,
                              device=classes.device), num_blocks)
    out, verdict, converged, it, ok = _scan(tables, classes, lanes, emit,
                                            max_iters, overlap, class_of, fold)
    # (B, NB) block-major storage: .T.reshape(-1) is stream order, no copy
    return FastScanResult(
        final_state=torch.from_numpy(verdict.final_states.reshape(())),
        match_mask=out[-1].T.reshape(-1) if emit != "counts" else None,
        states=out[1].T.reshape(-1) if emit == "full" else None,
        converged=converged, iterations=it,
        counts=torch.from_numpy(verdict.answer) if emit == "counts" else None,
        domain_ok=ok,
    )


def dfa_scan_fast_multi(
    tables: DfaTables,
    classes: torch.Tensor,
    num_blocks: int = 256,
    starts: torch.Tensor | int = 0,
    max_iters: int = 16,
    emit: str = "counts",
    overlap: int = 64,
    *,
    class_of: torch.Tensor | None = None,
) -> MultiScanResult:
    """Batch scan of N equal-length independent streams, ``classes`` (N, L),
    in one chain pass: each stream splits into ``num_blocks`` blocks and the
    N * num_blocks lanes run stream-major. A lane that begins a stream has
    its entry pinned to that stream's start (``starts``, scalar or (N,)) in
    the speculation and in every Jacobi shift, so streams stay independent.

    emit="counts": per-stream per-state histograms; emit="full": per-stream
    (N, L) states and match masks. The final states and the counts come
    back on the host. ``class_of`` as in ``dfa_scan_fast``."""
    if emit not in ("full", "counts"):
        raise ValueError(f"emit must be full or counts, got {emit!r}")
    n, l = classes.shape
    starts_v = torch.as_tensor(starts, dtype=torch.int32, device=classes.device)
    lanes = _Lanes(starts_v.reshape(-1).expand(n).repeat_interleave(num_blocks),
                   num_blocks)
    out, verdict, converged, it, ok = _scan(tables, classes, lanes, emit,
                                            max_iters, overlap, class_of)
    return MultiScanResult(
        final_states=torch.from_numpy(verdict.final_states),
        counts=(torch.from_numpy(verdict.answer.reshape(n, -1))
                if emit == "counts" else None),
        match_mask=out[2].T.reshape(n, l) if emit == "full" else None,
        states=out[1].T.reshape(n, l) if emit == "full" else None,
        converged=converged, iterations=it, domain_ok=ok,
    )
