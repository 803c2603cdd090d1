"""K4: the bounded active-set NFA scan on Hopper, with its plain version.

``nfa_active_scan`` runs N independent streams through an NFA, each from
its own list of A active states (sentinel ``S`` as padding), and per byte:
counts the accepting states of the list before the byte, gathers their
successors on the byte's class, and keeps the A smallest distinct ones,
ascending, flagging overflow when an (A+1)-th exists. It is the loop of
``regex_fpga_tpu/ops/nfa_engine.py::nfa_scan_jax`` (``_nfa_step`` in a
``lax.scan``, vmapped over streams), bit for bit. The kernel is
``csrc/nfa_active.cu``; it reads the per-class CSR of ``NfaCsr``.

Streams are slices of one flat uint8 tensor: stream n is
``data[starts[n] : starts[n] + lengths[n]]``, so ragged flows need no
padding. ``starts`` and ``lengths`` are host sequences (checked on the host,
then uploaded).

A wrapper launches the kernel for CUDA tensors and takes the plain version
only for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from .tables import NfaCsr

__all__ = ["LAUNCHES", "nfa_active_scan", "nfa_active_scan_plain"]

#: Kernel launches since the last reset.
LAUNCHES = {"nfa_active_scan": 0}


def _check_args(csr: NfaCsr, data, starts, lengths, active, counts):
    """Validate a scan's inputs; returns (starts, lengths) as int64 numpy."""
    dev = data.device
    for name, t in (("offsets", csr.offsets), ("targets", csr.targets),
                    ("class_of", csr.class_of), ("accept", csr.accept),
                    ("active", active), ("counts", counts)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, data on {dev}")
    if data.dim() != 1 or data.dtype != torch.uint8:
        raise TypeError("data must be a 1-D uint8 tensor")
    s = csr.num_states
    if csr.offsets.dtype != torch.int32 or csr.offsets.dim() != 2 \
            or csr.offsets.shape[1] != s + 2:
        raise TypeError(f"offsets must be a (C, {s + 2}) int32 tensor")
    if csr.targets.dtype != torch.int32 or csr.class_of.shape != (256,) \
            or csr.class_of.dtype != torch.int32:
        raise TypeError("targets and class_of must be int32 ((256,) class_of)")
    if csr.accept.shape != (s + 1,) or csr.accept.dtype != torch.bool:
        raise TypeError(f"accept must be a ({s + 1},) bool tensor")
    starts = np.asarray(starts, dtype=np.int64).reshape(-1)
    lengths = np.asarray(lengths, dtype=np.int64).reshape(-1)
    n = len(starts)
    if len(lengths) != n or active.dim() != 2 or active.shape[0] != n:
        raise ValueError("starts, lengths and active rows must agree")
    if active.dtype != torch.int32:
        raise TypeError("active must be an (N, A) int32 tensor")
    if counts.shape != (n, s + 1) or counts.dtype != torch.int32:
        raise TypeError(f"counts must be an ({n}, {s + 1}) int32 tensor")
    if active.shape[1] < 1:
        raise ValueError("the active bound must be at least 1")
    if (lengths < 0).any() or (starts < 0).any() \
            or (starts + lengths > data.shape[0]).any():
        raise ValueError("a stream lies outside data")
    if active.numel() and bool(((active < 0) | (active > s)).any()):
        raise ValueError(f"active states must lie in [0, {s}]")
    if s >= 1 << 30 or n >= 1 << 31:
        raise ValueError("states and streams must stay below 2^30 and 2^31")
    return starts, lengths


def nfa_active_scan(csr: NfaCsr, data, starts, lengths, active, counts):
    """K4. Returns (counts (N, S+1) int32, final_active (N, A) int32,
    overflowed (N,) bool); ``counts`` and ``active`` are the starting values
    and are not modified."""
    starts, lengths = _check_args(csr, data, starts, lengths, active, counts)
    if data.device.type == "cpu":
        return nfa_active_scan_plain(csr, data, starts, lengths, active, counts)
    if data.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {data.device}")
    s = csr.num_states
    n, a = active.shape
    dev = data.device
    active = active.contiguous().clone()
    counts = counts.contiguous().clone()
    overflow = torch.empty(n, dtype=torch.uint8, device=dev)
    starts_d = torch.as_tensor(starts, device=dev)
    lengths_d = torch.as_tensor(lengths, device=dev)
    offsets, targets = csr.offsets.contiguous(), csr.targets.contiguous()
    class_of, accept = csr.class_of.contiguous(), csr.accept.contiguous()
    LAUNCHES["nfa_active_scan"] += 1
    with torch.cuda.device(dev):
        rc = _build.library().nfa_active_scan(
            data.data_ptr(), starts_d.data_ptr(), lengths_d.data_ptr(), n,
            class_of.data_ptr(), offsets.data_ptr(), targets.data_ptr(),
            accept.data_ptr(), s, a, active.data_ptr(), counts.data_ptr(),
            overflow.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(rc, "nfa_active_scan")
    return counts, active, overflow.bool()


def nfa_active_scan_plain(csr: NfaCsr, data, starts, lengths, active, counts):
    """Plain-torch K4: one loop iteration per byte, all streams at once.
    Successors are gathered into an (N, A, K) block, K the largest list,
    sorted per stream and deduplicated by rank, as ``jnp.unique`` with a
    fixed size does."""
    dev = data.device
    s = csr.num_states
    n, a = active.shape
    starts = torch.as_tensor(np.asarray(starts, np.int64), device=dev)
    lengths = torch.as_tensor(np.asarray(lengths, np.int64), device=dev)
    act = active.long()
    cnt = counts.clone()
    over = torch.zeros(n, dtype=torch.bool, device=dev)
    offs = csr.offsets.reshape(-1).long()
    cols = s + 2
    k = max(int((csr.offsets[:, 1:] - csr.offsets[:, :-1]).max()), 1) \
        if csr.offsets.numel() else 1
    slots = torch.arange(k, device=dev)
    # a sentinel at index E stands for every empty slot
    tg = torch.cat([csr.targets.long(),
                    torch.full((1,), s, dtype=torch.long, device=dev)])
    e_idx = tg.shape[0] - 1
    last = max(data.shape[0] - 1, 0)
    acc = csr.accept
    cls_of = csr.class_of.long()
    for t in range(int(lengths.max()) if n else 0):
        live = t < lengths
        byte = torch.take(data, (starts + t).clamp(max=last)).long()
        c = torch.take(cls_of, byte)
        hit = torch.take(acc, act) & live[:, None]
        cnt.scatter_add_(1, act, hit.to(cnt.dtype))
        row = c[:, None] * cols + act
        lo, hi = torch.take(offs, row), torch.take(offs, row + 1)
        idx = lo[..., None] + slots
        cand = torch.take(tg, torch.where(idx < hi[..., None], idx, e_idx))
        srt = cand.reshape(n, -1).sort(dim=1).values
        new = torch.ones_like(srt, dtype=torch.bool)
        new[:, 1:] = srt[:, 1:] != srt[:, :-1]
        real = new & (srt < s)
        rank = real.cumsum(1) - 1
        # ranks 0..A keep their state; everything else lands in slot A+1
        nxt = torch.full((n, a + 2), s, dtype=torch.long, device=dev)
        nxt.scatter_(1, torch.where(real & (rank <= a), rank, a + 1), srt)
        over |= live & (nxt[:, a] != s)
        act = torch.where(live[:, None], nxt[:, :a], act)
    return cnt, act.to(torch.int32), over
