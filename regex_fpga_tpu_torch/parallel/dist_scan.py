"""Distributed scans over the (data, seq) mesh of ranks.

The counterpart of ``regex_fpga_tpu/parallel/dist_scan.py``. Tables are
replicated on every rank; byte streams are sharded: the batch over the
``data`` axis, each stream's blocks over the ``seq`` axis. Each rank is
called with the same arguments as the JAX function (the whole batch), takes
its own shard by its coordinates in the mesh, and returns the same global
result: where JAX's ``out_specs`` shard a result over ``data``, the rank
gathers it.

Cross-rank seams are resolved with the same Jacobi fixpoint as the block
seams inside a rank: the entry of a rank's first block arrives from the
previous rank along ``seq`` (``ring_shift``), and the convergence flag and
the match totals are summed with ``all_reduce``, in the order and over the
axes of the JAX scans. The passes are the Hopper kernels: K1 (finals) and K2
(counting) for ``dfa_scan_fast_dist``, K3 for ``dfa_scan_kgram_dist``, K4 for
``nfa_scan_dist``. No other communication exists.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.dfa_fast import chain_pass_finals
from ..ops.hopper_dfa import dfa_chain_counts
from ..ops.hopper_kgram import PackedTa, kgram_bytes_supported, map_classes
from ..ops.kgram import kgram_pass_full, pack_ta
from ..ops.nfa_engine import DEFAULT_ACTIVE_BOUND, nfa_scan_batch
from ..ops.tables import DfaTables, NfaCsr, host_to_device
from .mesh import DATA_AXIS, SEQ_AXIS, Mesh, all_gather, all_reduce, ring_shift

__all__ = ["nfa_scan_dist", "dfa_scan_fast_dist", "dfa_scan_kgram_dist"]


def _tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return host_to_device(np.asarray(x), device)


def _starts(start, batch: int, device) -> torch.Tensor:
    s = _tensor(start, device).to(torch.int32).reshape(-1)
    return s.expand(batch).contiguous()


def _data_rows(mesh: Mesh, batch: int) -> slice:
    n_data = mesh.shape[DATA_AXIS]
    if batch % n_data:
        raise ValueError(f"batch {batch} does not divide over {n_data} "
                         f"data ranks")
    b_loc = batch // n_data
    d = mesh.coords[DATA_AXIS]
    return slice(d * b_loc, (d + 1) * b_loc)


def _seq_cols(mesh: Mesh, length: int, blocks_per_shard: int) -> slice:
    n_seq = mesh.shape[SEQ_AXIS]
    if length % (n_seq * blocks_per_shard):
        raise ValueError(f"stream length {length} does not divide into "
                         f"{n_seq} x {blocks_per_shard} blocks")
    l_loc = length // n_seq
    j = mesh.coords[SEQ_AXIS]
    return slice(j * l_loc, (j + 1) * l_loc)


def _gather_data(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The (B, ...) result from each data rank's (b_loc, ...) rows."""
    out = all_gather(mesh, DATA_AXIS, x.contiguous())
    return out.reshape(-1, *x.shape[1:])


def _converged(mesh: Mesh, done: bool, device) -> bool:
    """Every rank's flag, summed over data and then over seq."""
    n = torch.tensor([0 if done else 1], dtype=torch.int32, device=device)
    all_reduce(mesh, DATA_AXIS, n)
    all_reduce(mesh, SEQ_AXIS, n)
    return int(n) == 0


def _seam_entries(mesh: Mesh, finals: torch.Tensor, starts: torch.Tensor):
    """(b_loc, nb) block finals -> the next entries: lane l of a stream
    takes block l-1's final, lane 0 the previous seq rank's last final (or
    the stream's start on seq rank 0)."""
    seam_in = ring_shift(mesh, SEQ_AXIS, finals[:, -1].contiguous())
    first = starts if mesh.coords[SEQ_AXIS] == 0 else seam_in
    return torch.cat([first[:, None], finals[:, :-1]], dim=1).reshape(-1)


def _seam_tails(mesh: Mesh, blocks: torch.Tensor, ov: int) -> torch.Tensor:
    """(b_loc, nb, b_len, ...) blocks -> (ov, b_loc * nb, ...) columns:
    lane l replays the last ``ov`` steps of block l-1, lane 0 those of the
    previous seq rank's last block."""
    b_loc, nb, b_len = blocks.shape[:3]
    tails = blocks[:, :, b_len - ov:]
    seam_tail = ring_shift(mesh, SEQ_AXIS, tails[:, -1].contiguous())
    ov_blocks = torch.cat([seam_tail[:, None], tails[:, :-1]], dim=1)
    return ov_blocks.reshape(b_loc * nb, ov, *blocks.shape[3:]).transpose(0, 1)


def _pin_first(mesh: Mesh, spec: torch.Tensor, starts: torch.Tensor, nb: int):
    """Speculated entries with each stream's lane 0 pinned to its start on
    seq rank 0."""
    if mesh.coords[SEQ_AXIS] != 0:
        return spec
    spec = spec.reshape(-1, nb).clone()
    spec[:, 0] = starts
    return spec.reshape(-1)


def nfa_scan_dist(mesh: Mesh, tables: NfaCsr, streams,
                  active_bound: int = DEFAULT_ACTIVE_BOUND):
    """Batched NFA scan, streams (B, L) sharded over the data axis, K4 on
    each rank's streams. Returns the per-stream counts (B, S) and the
    per-state totals (S,), summed over data.

    Raises ``RuntimeError`` when any stream overflows the active bound, as
    the port's ``NfaMatcher`` does (the JAX scan drops the flag)."""
    streams = _tensor(streams, tables.device)
    rows = _data_rows(mesh, streams.shape[0])
    res = nfa_scan_batch(tables, streams[rows], active_bound)
    totals = all_reduce(mesh, DATA_AXIS, res.counts.sum(0, dtype=torch.int32))
    counts = _gather_data(mesh, res.counts)
    overflowed = _gather_data(mesh, res.overflowed)
    if bool(overflowed.any()):
        raise RuntimeError("active-set bound exceeded; raise active_bound")
    return counts, totals


def _fast_local(mesh: Mesh, tables: DfaTables, cls: torch.Tensor,
                starts: torch.Tensor, nb: int, max_iters: int, overlap: int):
    """One rank's part of ``dfa_scan_fast_dist``: ``cls`` (b_loc, l_loc)
    class ids, ``starts`` (b_loc,). Returns (finals (b_loc,), counts
    (b_loc,) int32, converged)."""
    b_loc, l_loc = cls.shape
    b_len = l_loc // nb
    blocks = cls.reshape(b_loc, nb, b_len)
    cls_seq = blocks.reshape(b_loc * nb, b_len).T  # (B, NB), stream-major
    entries = starts.repeat_interleave(nb)
    ov = min(overlap, b_len)
    if ov > 0:
        spec = chain_pass_finals(tables, _seam_tails(mesh, blocks, ov), entries)
        entries = _pin_first(mesh, spec, starts, nb)
    done, it = False, 0
    while not done and it < max_iters:
        finals = chain_pass_finals(tables, cls_seq, entries)
        new = _seam_entries(mesh, finals.reshape(b_loc, nb), starts)
        done = _converged(mesh, bool((new == entries).all()), cls.device)
        entries, it = new, it + 1
    # the output pass counts on K2, per stream, without the (B, NB) states
    finals, hist = dfa_chain_counts(tables.table, tables.accept, cls_seq,
                                    entries, num_streams=b_loc)
    counts = all_reduce(mesh, SEQ_AXIS, hist.sum(1).to(torch.int32))
    alls = all_gather(mesh, SEQ_AXIS, finals.reshape(b_loc, nb)[:, -1].contiguous())
    return alls[-1], counts, done


def dfa_scan_fast_dist(
    mesh: Mesh,
    tables: DfaTables,
    classes,
    blocks_per_shard: int = 8192,
    start=0,
    max_iters: int = 16,
    overlap: int = 64,
):
    """Distributed fast DFA scan of ``classes`` (BATCH, L) byte-class ids
    (uint8, int16 or int32); BATCH divides over the data axis, L into
    seq_size * ``blocks_per_shard`` blocks. Each rank runs
    ``blocks_per_shard`` chains over its span, seeded by the speculation
    (the previous block's last ``overlap`` bytes replayed from the start
    state; the previous rank's tail arrives by ``ring_shift``), then the
    Jacobi fixpoint verifies the entries, and one counting pass runs.

    ``start``: scalar or (BATCH,) per-stream entry states (the carry of a
    chunked scan). Returns (final_states (BATCH,), match_counts (BATCH,)
    int32, converged): the counts and finals equal JAX's, and are exact,
    whenever ``converged`` is True."""
    dev = tables.device
    classes = _tensor(classes, dev)
    batch, length = classes.shape
    rows = _data_rows(mesh, batch)
    cols = _seq_cols(mesh, length, blocks_per_shard)
    starts = _starts(start, batch, dev)[rows]
    finals, counts, done = _fast_local(mesh, tables, classes[rows, cols],
                                       starts, blocks_per_shard, max_iters,
                                       overlap)
    return _gather_data(mesh, finals), _gather_data(mesh, counts), done


def _kgram_local(mesh: Mesh, ta: PackedTa, src: torch.Tensor,
                 starts: torch.Tensor, nb: int, max_iters: int, overlap: int,
                 maps):
    """One rank's part of ``dfa_scan_kgram_dist``: ``src`` (b_loc, lk)
    k-gram class ids, or with ``maps`` (b_loc, lk, k) raw bytes."""
    b_loc, lk = src.shape[:2]
    b_len = lk // nb
    blocks = src.reshape(b_loc, nb, b_len, *src.shape[2:])
    cls_seq = blocks.reshape(b_loc * nb, b_len, *src.shape[2:]).transpose(0, 1)
    entries = starts.repeat_interleave(nb)
    ov = min(overlap, b_len)
    if ov > 0:
        spec, _ = kgram_pass_full(ta, _seam_tails(mesh, blocks, ov), entries,
                                  maps)
        entries = _pin_first(mesh, spec, starts, nb)
    # every pass carries totals, so the converging pass is the output pass
    finals = totals = torch.zeros(b_loc * nb, dtype=torch.int32,
                                  device=src.device)
    done, it = False, 0
    while not done and it < max_iters:
        finals, totals = kgram_pass_full(ta, cls_seq, entries, maps)
        new = _seam_entries(mesh, finals.reshape(b_loc, nb), starts)
        done = _converged(mesh, bool((new == entries).all()), src.device)
        entries, it = new, it + 1
    stream_totals = all_reduce(
        mesh, SEQ_AXIS, totals.reshape(b_loc, nb).sum(1).to(torch.int32))
    alls = all_gather(mesh, SEQ_AXIS, finals.reshape(b_loc, nb)[:, -1].contiguous())
    return alls[-1], stream_totals, done


def dfa_scan_kgram_dist(
    mesh: Mesh,
    table,
    acc_table,
    classes_k,
    blocks_per_shard: int = 8192,
    start=0,
    max_iters: int = 16,
    overlap: int = 16,
    acc_bound: int | None = None,
    maps=None,
):
    """Distributed k-gram scan: the structure of ``dfa_scan_fast_dist`` on
    K3, with ``overlap`` counted in k-gram steps. ``table`` and
    ``acc_table`` are T_k and A_k, (C_k, S) arrays or tensors, or ``table``
    is a ``PackedTa`` (``pack_ta``) and ``acc_table`` None. ``classes_k``
    (BATCH, Lk) k-gram class ids, int16 or int32 as in JAX; with ``maps``
    (``kgram_maps``) it is the raw text (BATCH, Lk * k) uint8, which K3
    maps itself where the maps fit in shared memory. ``acc_bound`` is
    accepted for the JAX signature: K3 counts exactly in int32.

    Returns (final_states (BATCH,), totals (BATCH,) int32, converged)."""
    del acc_bound
    if isinstance(table, PackedTa):
        ta = table
    else:
        dev = table.device if isinstance(table, torch.Tensor) else "cpu"
        ta = pack_ta(_tensor(table, dev), _tensor(acc_table, dev))
    dev = ta.device
    src = _tensor(classes_k, dev)
    if maps is not None:
        if not kgram_bytes_supported(ta, maps):
            src, maps = map_classes(maps, src), None
        else:
            src = src.reshape(src.shape[0], -1, maps.k)
    batch, lk = src.shape[:2]
    rows = _data_rows(mesh, batch)
    cols = _seq_cols(mesh, lk, blocks_per_shard)
    starts = _starts(start, batch, dev)[rows]
    finals, totals, done = _kgram_local(mesh, ta, src[rows, cols], starts,
                                        blocks_per_shard, max_iters, overlap,
                                        maps)
    return _gather_data(mesh, finals), _gather_data(mesh, totals), done
