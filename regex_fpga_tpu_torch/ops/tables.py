"""DFA and NFA tables as torch tensors.

The counterpart of ``regex_fpga_tpu/ops/tables.py``: the byte axis of an
automaton is compressed to equivalence classes on the host with numpy, and
the result is held as int32/bool tensors on a device of the caller's
choosing. All state math is int32, because the contract with the JAX package
is bit-exactness.

NFAs have two layouts. ``NfaTables`` is the JAX package's dense
(C, S+1, K) successor table, K the largest out-degree; the native
``nfa_match_positions`` walk reads it. ``NfaCsr`` is what the active-set
kernel (K4, ``hopper_nfa``) reads: per class, a CSR of each state's
successors. The dense table pads every cell to the hub's out-degree
(83 x 35,260 x 1,266 int32, about 14.8 GB, for the Snort-corpus content
NFA); the CSR holds each (class, state, successor) once.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from ..models import CsrAutomaton, byte_classes, dfa_step_table

__all__ = [
    "DfaTables",
    "NfaCsr",
    "NfaTables",
    "build_dfa_tables",
    "build_dfa_tables_from_csr",
    "build_nfa_csr",
    "build_nfa_tables",
    "host_to_device",
    "resolve_device",
    "stall_extend",
    "tables_from_numpy",
]


def resolve_device(device) -> torch.device:
    """``None`` means the first CUDA card. A CUDA device raises when no
    card is visible: the CPU runs only when the caller asks for it."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is visible; pass device='cpu' "
                           "to run the plain PyTorch versions")
    return device


def host_to_device(arr, device, dtype=None) -> torch.Tensor:
    """A host array (numpy, or a bytes-like object as uint8) as a tensor on
    ``device``. Read-only buffers (``bytes`` input) are shared, not copied:
    the scans only read them."""
    if isinstance(arr, (bytes, bytearray, memoryview)):
        arr = np.frombuffer(arr, np.uint8)
    arr = np.ascontiguousarray(arr, dtype=dtype)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*not writable.*")
        return torch.from_numpy(arr).to(device)


@dataclasses.dataclass(frozen=True)
class DfaTables:
    """Dense DFA next-state table: ``table[c, s]`` on byte-class ``c``.

    Includes a dead state (index ``num_states - 1`` by convention of the
    callers) that is absorbing; accepting states transition to dead.
    """

    table: torch.Tensor      # (C, S) int32
    class_of: torch.Tensor   # (256,) int32
    accept: torch.Tensor     # (S,) bool
    num_states: int

    @property
    def num_classes(self) -> int:
        return self.table.shape[0]

    @property
    def device(self) -> torch.device:
        return self.table.device

    def to(self, device) -> "DfaTables":
        return dataclasses.replace(
            self,
            table=self.table.to(device),
            class_of=self.class_of.to(device),
            accept=self.accept.to(device),
        )


def tables_from_numpy(table, class_of, accept, num_states: int,
                      device=None) -> DfaTables:
    """Tables from numpy arrays, e.g. the fields of the JAX package's
    ``DfaTables`` (``np.asarray(jax_tables.table)`` ...)."""
    return DfaTables(  # torch.tensor copies: the tables own their data
        table=torch.tensor(np.asarray(table, dtype=np.int32), device=device),
        class_of=torch.tensor(np.asarray(class_of, dtype=np.int32),
                              device=device),
        accept=torch.tensor(np.asarray(accept, dtype=bool), device=device),
        num_states=int(num_states),
    )


def build_dfa_tables(table_256: np.ndarray, accept: np.ndarray,
                     device=None) -> DfaTables:
    """Build from a dense (256, S) table (e.g. ``oracle.dfa_step_table`` or a
    compiled regex DFA), compressing the byte axis to equivalence classes.

    Rejects out-of-range transition targets at build time: fail loudly on
    the host rather than mis-scan on the device."""
    table_256 = np.asarray(table_256)
    s = table_256.shape[1]
    if table_256.size and (table_256.min() < 0 or table_256.max() >= s):
        raise ValueError(
            f"transition targets must be in [0, {s}); got "
            f"[{table_256.min()}, {table_256.max()}]"
        )
    _, class_of = np.unique(table_256, axis=0, return_inverse=True)
    # np.unique sorts rows; rebuild the table in class order
    reps = np.zeros(class_of.max() + 1, dtype=np.int64)
    reps[class_of] = np.arange(256)
    return tables_from_numpy(table_256[reps], class_of, accept, s, device)


def build_dfa_tables_from_csr(aut: CsrAutomaton, device=None) -> DfaTables:
    """DFA tables straight from a deterministic CsrAutomaton (adds the dead
    state and routes accepting states to it, matching reference timing)."""
    table = dfa_step_table(aut)          # (256, S+1) with dead = S
    accept = np.concatenate([aut.accept_mask, [False]])
    return build_dfa_tables(table, accept, device)


def stall_extend(tables: DfaTables) -> DfaTables:
    """Append a STALL byte class (id = ``tables.num_classes``) whose table
    row is the identity: a lane stepping on it stays in place.

    Ragged batches pad each stream at the front to a common length with
    this class; no real byte maps to it, so ``class_of`` is unchanged."""
    ident = torch.arange(tables.num_states, dtype=torch.int32,
                         device=tables.device)[None, :]
    return dataclasses.replace(
        tables, table=torch.cat([tables.table, ident], dim=0)
    )


@dataclasses.dataclass(frozen=True)
class NfaTables:
    """Dense NFA successor tables.

    ``delta[c, s, k]`` is the k-th successor of state ``s`` on byte-class
    ``c``, or the sentinel ``num_states`` when absent. Row ``num_states``
    (the sentinel row) is all-sentinel, so sentinel slots in an active list
    are no-ops.
    """

    delta: torch.Tensor      # (C, S+1, K) int32
    class_of: torch.Tensor   # (256,) int32
    accept: torch.Tensor     # (S+1,) bool; accept[S] = False
    num_states: int
    max_fanout: int

    @property
    def num_classes(self) -> int:
        return self.delta.shape[0]


@dataclasses.dataclass(frozen=True)
class NfaCsr:
    """Per-class successor lists of an NFA, the layout K4 reads.

    The successors of state ``s`` on class ``c`` are
    ``targets[offsets[c, s] : offsets[c, s + 1]]``, ascending and distinct.
    ``offsets`` has S+2 columns, so the sentinel ``S`` has an (empty) list
    too. They are the sets of the dense table's cells.
    """

    offsets: torch.Tensor    # (C, S+2) int32, absolute into targets
    targets: torch.Tensor    # (E,) int32
    class_of: torch.Tensor   # (256,) int32
    accept: torch.Tensor     # (S+1,) bool; accept[S] = False
    num_states: int

    @property
    def num_classes(self) -> int:
        return self.offsets.shape[0]

    @property
    def device(self) -> torch.device:
        return self.offsets.device

    def to(self, device) -> "NfaCsr":
        return dataclasses.replace(
            self, offsets=self.offsets.to(device),
            targets=self.targets.to(device),
            class_of=self.class_of.to(device), accept=self.accept.to(device),
        )


def _class_edges(aut: CsrAutomaton):
    """(byte class per byte, number of classes, edges as (class, source,
    target) arrays): one edge per transition on its class's representative
    byte (the lowest byte of the class), as the JAX package's
    ``build_nfa_tables`` takes them."""
    cls, num_classes = byte_classes(aut)
    src = np.repeat(np.arange(aut.num_states, dtype=np.int64), aut.out_degree)
    ch = aut.trans_char.astype(np.int64)
    rep_of_class = np.full(num_classes, -1, dtype=np.int64)
    for b in range(255, -1, -1):
        rep_of_class[cls[b]] = b
    keep = ch == rep_of_class[cls[ch]]
    return (cls, num_classes, cls[ch[keep]].astype(np.int64), src[keep],
            aut.trans_target[keep].astype(np.int64))


def build_nfa_tables(aut: CsrAutomaton, device=None) -> NfaTables:
    """The dense (C, S+1, K) table, equal to the JAX package's field by
    field (successors in the CSR's edge order within a cell)."""
    cls, num_classes, ecls, src, tgt = _class_edges(aut)
    s = aut.num_states
    k = max(aut.max_fanout(), 1)
    delta = np.full((num_classes, s + 1, k), s, dtype=np.int32)
    cell = ecls * s + src
    order = np.argsort(cell, kind="stable")
    cell_s = cell[order]
    slot = np.arange(len(cell_s)) - np.searchsorted(cell_s, cell_s, side="left")
    delta[ecls[order], src[order], slot] = tgt[order]
    accept = np.concatenate([aut.accept_mask, [False]])
    return NfaTables(
        delta=torch.tensor(delta, device=device),
        class_of=torch.tensor(cls.astype(np.int32), device=device),
        accept=torch.tensor(accept, device=device),
        num_states=s,
        max_fanout=k,
    )


def build_nfa_csr(aut: CsrAutomaton, device=None) -> NfaCsr:
    """K4's layout: per class, each state's distinct successors, ascending."""
    cls, num_classes, ecls, src, tgt = _class_edges(aut)
    s = aut.num_states
    keys = np.unique((ecls * (s + 1) + src) * s + tgt)  # sorted (c, src, tgt)
    rows, targets = keys // s, keys % s
    bounds = np.searchsorted(rows, np.arange(num_classes * (s + 1) + 1))
    if bounds[-1] >= 1 << 31:
        raise ValueError("more than 2^31 (class, state, successor) edges")
    offsets = np.empty((num_classes, s + 2), dtype=np.int32)
    offsets[:, :-1] = bounds[:-1].reshape(num_classes, s + 1)
    offsets[:, -1] = bounds[1:].reshape(num_classes, s + 1)[:, -1]
    accept = np.concatenate([aut.accept_mask, [False]])
    return NfaCsr(
        offsets=torch.tensor(offsets, device=device),
        targets=torch.tensor(targets.astype(np.int32), device=device),
        class_of=torch.tensor(cls.astype(np.int32), device=device),
        accept=torch.tensor(accept, device=device),
        num_states=s,
    )
