"""Dense DFA tables as torch tensors.

The counterpart of ``regex_fpga_tpu/ops/tables.py``'s DFA half: the byte
axis of a (256, S) next-state table is compressed to equivalence classes on
the host with numpy, and the result is held as int32/bool tensors on a
device of the caller's choosing. All state math is int32, because the
contract with the JAX package is bit-exactness.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models import CsrAutomaton, dfa_step_table

__all__ = [
    "DfaTables",
    "build_dfa_tables",
    "build_dfa_tables_from_csr",
    "stall_extend",
    "tables_from_numpy",
]


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
