"""Tensor-parallel NFA scan: the automaton's states sharded over ranks.

The counterpart of ``regex_fpga_tpu/parallel/tp_scan.py``. The active set is
a full bitmap of the S states (no bound to overflow, O(S) work a byte), and
rank m of the ``model`` axis owns the states [m * S_loc, (m + 1) * S_loc):
their slice of the bitmap, of the accept mask and of the counters.

One byte: every active state counts if it accepts; its successors are
flagged in a full-width (S_pad,) uint8 vector; a sum over the ``model``
axis merges the ranks' flags (JAX sums int32 counts; either sum > 0 is the
same bitmap), and each rank keeps its slice > 0 (the sentinel slot S
cleared) as the next bitmap. A model axis has at most 255 ranks, so the
uint8 sum cannot wrap.

Two routes:

- one rank on the model axis: the whole byte loop is one launch of K5
  (``hopper_nfa.nfa_tp_scan``, ``csrc/nfa_tp_scan.cu``);
- more than one: each byte needs the cross-rank sum, so each rank launches
  K5's step (``hopper_nfa.nfa_tp_scan_sharded``, ``nfa_tp_step``) once a
  byte on its own device, with one ``all_reduce`` over ``model`` between
  two launches. The per-byte collective forces this route; it is no
  fallback.

CPU tensors take the plain step (``nfa_tp_scan_plain``) on either route.

The scan reads the per-class CSR that K4 reads (``NfaCsr``); a dense
``NfaTables`` is converted to it.
"""

from __future__ import annotations

import torch

from ..ops.hopper_nfa import nfa_tp_scan, nfa_tp_scan_sharded
from ..ops.tables import NfaCsr, NfaTables, nfa_csr_from_tables
from .dist_scan import _data_rows, _gather_data, _tensor
from .mesh import MODEL_AXIS, Mesh, all_gather, all_reduce

__all__ = ["MAX_MODEL_RANKS", "nfa_scan_tp", "pad_tables_tp", "tp_route"]

#: The most ranks a model axis may have: each rank flags a successor with a
#: uint8 1, and the sum over the ranks must stay below 256.
MAX_MODEL_RANKS = 255


def _s_pad(num_states: int, n_model: int) -> int:
    return -(-(num_states + 1) // n_model) * n_model


def pad_tables_tp(tables: NfaTables, n_model: int):
    """Pad the (C, S+1, K) successor table so the state axis splits evenly
    over ``n_model`` ranks. Padding rows behave like the sentinel row (all
    successors = sentinel, non-accepting) and are never activated.
    Returns (delta, accept, S_pad)."""
    delta, accept = tables.delta, tables.accept
    c, s1, k = delta.shape
    s_pad = _s_pad(tables.num_states, n_model)
    if s_pad != s1:
        pad = torch.full((c, s_pad - s1, k), tables.num_states,
                         dtype=delta.dtype, device=delta.device)
        delta = torch.cat([delta, pad], dim=1)
        accept = torch.cat([accept, torch.zeros(s_pad - s1, dtype=torch.bool,
                                                device=accept.device)])
    return delta, accept, s_pad


def tp_route(mesh: Mesh) -> str:
    """Which route ``nfa_scan_tp`` takes on this mesh."""
    n_model = mesh.shape[MODEL_AXIS]
    if n_model == 1:
        return "K5 (nfa_tp_scan): the whole byte loop in one launch"
    return (f"K5's step (nfa_tp_step) on each of {n_model} model ranks, one "
            f"launch and one all_reduce over model a byte: the per-byte "
            f"cross-rank sum forces it")


def nfa_scan_tp(mesh: Mesh, tables: NfaCsr | NfaTables, streams,
                start_bitmap=None, counts_init=None):
    """Bit-exact NFA scan with states sharded over the mesh's ``model`` axis.

    ``streams``: (B, L) uint8, B divisible by the ``data`` axis size.
    ``start_bitmap`` / ``counts_init``: optional (B, S_pad) resume carries
    from a previous chunk's final bitmap and counts ((B, S) counts are
    padded). Returns ``(counts, final_bitmap)``: per-stream per-state match
    counts (B, S) int32 and the final active bitmaps (B, S_pad) bool (slot
    S is the sentinel, cleared)."""
    n_model = mesh.shape[MODEL_AXIS]
    if n_model > MAX_MODEL_RANKS:
        raise ValueError(f"a model axis of {n_model} ranks: at most "
                         f"{MAX_MODEL_RANKS}, so that the uint8 successor "
                         f"flags summed over the ranks cannot wrap")
    csr = tables if isinstance(tables, NfaCsr) else nfa_csr_from_tables(tables)
    dev = csr.device
    s = csr.num_states
    s_pad = _s_pad(s, n_model)
    s_loc = s_pad // n_model
    streams = _tensor(streams, dev).to(torch.uint8)
    batch = streams.shape[0]
    if start_bitmap is None:
        start_bitmap = torch.zeros((batch, s_pad), dtype=torch.bool, device=dev)
        start_bitmap[:, 0] = True
    start_bitmap = _tensor(start_bitmap, dev).bool()
    counts_init = (torch.zeros((batch, s_pad), dtype=torch.int32, device=dev)
                   if counts_init is None
                   else _tensor(counts_init, dev).to(torch.int32))
    if counts_init.shape[1] != s_pad:  # resume from a sliced (B, S) result
        counts_init = torch.nn.functional.pad(
            counts_init, (0, s_pad - counts_init.shape[1]))
    rows = _data_rows(mesh, batch)
    lo = mesh.coords[MODEL_AXIS] * s_loc
    cols = slice(lo, lo + s_loc)
    bm, cnt = start_bitmap[rows, cols], counts_init[rows, cols]
    if n_model == 1:
        counts, finals = nfa_tp_scan(csr, streams[rows], bm, cnt)
    else:
        counts, finals = nfa_tp_scan_sharded(
            csr, streams[rows], bm, cnt, lo, s_pad,
            all_reduce=lambda x: all_reduce(mesh, MODEL_AXIS, x))

    def gather(x):  # (b_loc, S_loc) slices -> (B, S_pad)
        parts = all_gather(mesh, MODEL_AXIS, x.contiguous())
        return _gather_data(mesh, parts.permute(1, 0, 2).reshape(x.shape[0], -1))

    return gather(counts)[:, :s], gather(finals)
