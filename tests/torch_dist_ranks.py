"""Rank programs for the multi-rank tests of regex_fpga_tpu_torch.parallel.

``spawn_ranks`` runs ``run_cases`` in every rank of a gloo process group on
the CPU. It imports torch and the port only (no JAX, so that the ranks start
quickly), builds the port's tables from the numpy arrays of each case, runs
the case's scan on the mesh, and returns numpy results; the test files hold
them to the JAX package on its virtual CPU mesh of the same shape. A case
that raises returns ("raised", type name, message) so that every rank's
answer can be compared.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _aut(arrays):
    from regex_fpga_tpu_torch.models import CsrAutomaton

    offsets, chars, targets = arrays
    return CsrAutomaton(offsets=offsets, trans_char=chars, trans_target=targets)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def fast(n_data, n_seq, table, accept, streams, bps, start=0, max_iters=16,
         overlap=64):
    """``dfa_scan_fast_dist`` over the byte streams mapped to class ids."""
    from regex_fpga_tpu_torch import parallel as P
    from regex_fpga_tpu_torch.ops.tables import build_dfa_tables

    dt = build_dfa_tables(table, accept)
    classes = dt.class_of[torch.as_tensor(streams).long()]
    finals, counts, conv = P.dfa_scan_fast_dist(
        P.make_mesh(n_data, n_seq), dt, classes, blocks_per_shard=bps,
        start=start, max_iters=max_iters, overlap=overlap)
    return _np(finals), _np(counts), conv


def kgram(n_data, n_seq, table, accept, streams, levels, bps, start=0,
          max_iters=16, overlap=16):
    """``dfa_scan_kgram_dist`` over int16 k-gram class ids and over the raw
    bytes with the packed maps."""
    from regex_fpga_tpu_torch import parallel as P
    from regex_fpga_tpu_torch.ops.kgram import (build_kgram, kgram_maps,
                                                map_kgram_classes)
    from regex_fpga_tpu_torch.ops.tables import build_dfa_tables

    kg = build_kgram(build_dfa_tables(table, accept), levels=levels,
                     max_classes=200_000)
    mesh = P.make_mesh(n_data, n_seq)
    ck = torch.stack([map_kgram_classes(kg, s) for s in streams]).to(torch.int16)
    out = []
    for src, maps in ((ck, None), (torch.as_tensor(streams), kgram_maps(kg))):
        finals, totals, conv = P.dfa_scan_kgram_dist(
            mesh, kg.table, kg.acc_table, src, blocks_per_shard=bps,
            start=start, max_iters=max_iters, overlap=overlap,
            acc_bound=kg.k, maps=maps)
        out.append((_np(finals), _np(totals), conv))
    return out


def nfa(n_data, n_seq, aut, streams, bound=128):
    from regex_fpga_tpu_torch import parallel as P
    from regex_fpga_tpu_torch.ops.tables import build_nfa_csr

    try:
        counts, totals = P.nfa_scan_dist(P.make_mesh(n_data, n_seq),
                                         build_nfa_csr(_aut(aut)), streams,
                                         bound)
    except RuntimeError as e:
        return ("raised", type(e).__name__, str(e))
    return _np(counts), _np(totals)


def tp(n_data, n_model, aut, streams, split=None, start_bitmap=None,
       counts_init=None):
    """``nfa_scan_tp``, from the given start carries; with ``split``, as two
    chunks, the second resumed from the first's carries."""
    from regex_fpga_tpu_torch import parallel as P
    from regex_fpga_tpu_torch.ops.tables import build_nfa_tables

    mesh = P.make_tp_mesh(n_model=n_model, n_data=n_data)
    tables = build_nfa_tables(_aut(aut))
    if split is None:
        counts, finals = P.nfa_scan_tp(mesh, tables, streams, start_bitmap,
                                       counts_init)
    else:
        c1, b1 = P.nfa_scan_tp(mesh, tables, streams[:, :split])
        counts, finals = P.nfa_scan_tp(mesh, tables, streams[:, split:],
                                       start_bitmap=b1, counts_init=c1)
    return _np(counts), _np(finals)


def multi(n_data, n_seq, auts, stream, bound=128):
    from regex_fpga_tpu_torch import parallel as P
    from regex_fpga_tpu_torch.ops.tables import build_nfa_tables

    stacked = P.stack_nfa_tables([build_nfa_tables(_aut(a)) for a in auts])
    try:
        return _np(P.multi_ruleset_scan(P.make_mesh(n_data, n_seq), stacked,
                                        stream, bound))
    except RuntimeError as e:
        return ("raised", type(e).__name__, str(e))


def ingest(n_data, n_seq, table, accept, streams, chunk_len, bps, start,
           levels=0, stop_after=None, store=None):
    """``dist_resilient_scan`` over ``iter_batch_chunks``; with
    ``stop_after`` n, the chunks end after n of them (a run that dies at a
    chunk boundary); ``store`` is a checkpoint path shared by the ranks
    (rank 0 writes it, every rank resumes from it)."""
    from regex_fpga_tpu_torch import parallel as P
    from regex_fpga_tpu_torch.ops.kgram import build_kgram
    from regex_fpga_tpu_torch.ops.tables import build_dfa_tables
    from regex_fpga_tpu_torch.parallel.ingest import (
        CheckpointStore, dist_resilient_scan, iter_batch_chunks)

    dt = build_dfa_tables(table, accept)
    kg = build_kgram(dt, levels=levels) if levels else None
    chunks = iter_batch_chunks(streams, chunk_len)
    if stop_after is not None:
        chunks = (c for i, c in enumerate(chunks) if i < stop_after)
    if store is not None:
        store = CheckpointStore(store)
    try:
        carry = dist_resilient_scan(P.make_mesh(n_data, n_seq), dt, chunks,
                                    kgram=kg, blocks_per_shard=bps,
                                    start=start, store=store, max_retries=0,
                                    retry_delay=0.0)
    except RuntimeError as e:
        return ("raised", type(e).__name__, str(e))
    return {k: np.asarray(v) for k, v in carry.items()}


def audit(n_data, n_seq, table, accept, classes, classes_k, kg_table,
          kg_acc, bps, overlap):
    """The collectives that one fast and one k-gram scan issue, as
    (op, axis, in_bytes, out_bytes) lists."""
    from regex_fpga_tpu_torch import parallel as P
    from regex_fpga_tpu_torch.ops.tables import build_dfa_tables
    from regex_fpga_tpu_torch.parallel import mesh as M

    mesh = P.make_mesh(n_data, n_seq)
    dt = build_dfa_tables(table, accept)
    out = []
    for run in (lambda: P.dfa_scan_fast_dist(mesh, dt, torch.as_tensor(classes),
                                             blocks_per_shard=bps,
                                             overlap=overlap),
                lambda: P.dfa_scan_kgram_dist(mesh, kg_table, kg_acc,
                                              torch.as_tensor(classes_k),
                                              blocks_per_shard=bps,
                                              overlap=overlap)):
        with M.record_collectives() as log:
            conv = run()[2]
        out.append(([tuple(c) for c in log], conv))
    return out


def run_cases(cases):
    """Every (function name, kwargs) case in order, on this rank."""
    torch.manual_seed(0)
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    return [globals()[name](**kwargs) for name, kwargs in cases]
