"""Ruleset-parallel scanning: several rulesets over the ranks of a mesh.

The counterpart of ``regex_fpga_tpu/parallel/multi_ruleset.py``. Rulesets
are padded to a common table shape and stacked; rank r of the mesh (data
major, as JAX's ``P((DATA_AXIS, SEQ_AXIS))``) takes R / n of them and scans
the stream against each on K4, and an ``all_gather`` returns every
ruleset's counts to every rank.

The JAX scan ignores the active-set overflow flag here; the port raises on
it, as its ``NfaMatcher`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.nfa_engine import DEFAULT_ACTIVE_BOUND, nfa_scan
from ..ops.tables import NfaTables, nfa_csr_from_tables
from .dist_scan import _tensor
from .mesh import Mesh, all_gather

__all__ = ["stack_nfa_tables", "multi_ruleset_scan"]


def stack_nfa_tables(tables: list[NfaTables]) -> NfaTables:
    """Pad rulesets to a common (C, S+1, K) shape and stack them on a
    leading ruleset axis. Sentinels are remapped to the padded S so that
    inactive slots stay self-absorbing."""
    c_max = max(t.delta.shape[0] for t in tables)
    s_max = max(t.num_states for t in tables)
    k_max = max(t.delta.shape[2] for t in tables)
    deltas, classes, accepts = [], [], []
    for t in tables:
        d = t.delta.cpu().numpy()
        s = t.num_states
        d = np.where(d == s, s_max, d)  # the old sentinel -> the new one
        pad = np.full((c_max, s_max + 1, k_max), s_max, dtype=np.int32)
        pad[: d.shape[0], : d.shape[1] - 1, : d.shape[2]] = d[:, :-1, :]
        deltas.append(pad)
        classes.append(t.class_of.cpu().numpy())
        a = np.zeros(s_max + 1, dtype=bool)
        a[:s] = t.accept.cpu().numpy()[:s]
        accepts.append(a)
    dev = tables[0].delta.device
    return NfaTables(
        delta=torch.tensor(np.stack(deltas), device=dev),
        class_of=torch.tensor(np.stack(classes), device=dev),
        accept=torch.tensor(np.stack(accepts), device=dev),
        num_states=s_max,
        max_fanout=k_max,
    )


def multi_ruleset_scan(mesh: Mesh, stacked: NfaTables, stream,
                       active_bound: int = DEFAULT_ACTIVE_BOUND):
    """Scan one stream against R stacked rulesets, the ruleset axis sharded
    over every rank of the mesh. Returns per-ruleset counts (R, S_max)
    int32. Raises ``RuntimeError`` when a ruleset overflows the bound."""
    r = stacked.delta.shape[0]
    n = mesh.size
    if r % n:
        raise ValueError(f"{r} rulesets must divide over {n} ranks")
    r_loc = r // n
    inner, outer = mesh.axis_names[1], mesh.axis_names[0]
    rank = mesh.coords[outer] * mesh.shape[inner] + mesh.coords[inner]
    dev = stacked.delta.device
    stream = _tensor(stream, dev).to(torch.uint8)
    counts, over = [], []
    for i in range(rank * r_loc, (rank + 1) * r_loc):
        one = NfaTables(delta=stacked.delta[i], class_of=stacked.class_of[i],
                        accept=stacked.accept[i],
                        num_states=stacked.num_states,
                        max_fanout=stacked.max_fanout)
        res = nfa_scan(nfa_csr_from_tables(one), stream, active_bound)
        counts.append(res.counts)
        over.append(res.overflowed.reshape(1))

    def gather(x):  # this rank's (r_loc, ...) -> (R, ...), data major
        x = all_gather(mesh, inner, x.contiguous())
        x = all_gather(mesh, outer, x.reshape(-1, *x.shape[2:]))
        return x.reshape(r, *x.shape[2:])

    out = gather(torch.stack(counts))
    if bool(gather(torch.cat(over)).any()):
        raise RuntimeError("active-set bound exceeded; raise active_bound")
    return out
