"""K1 and K2: the k=1 DFA chain pass on Hopper, with their plain versions.

``dfa_chain`` (K1) runs NB independent chains, ``state <- T[class, state]``
per step, and returns the final states and, by mode, the state before each
step and its accept bit. ``dfa_chain_counts`` (K2) runs the same chains and
returns the final states and the accept-visit histogram, per state or per
stream and state. The kernels are ``csrc/dfa_chain.cu``; they replace the TPU
kernels ``regex_fpga_tpu/ops/pallas_dfa.py::_kernel`` and ``::_counts_kernel``.

Layout: ``cls_seq`` is (B, NB), one column per lane, as in the JAX engines.
Its storage may be either order: a ``blocks.T`` view of a block-major (NB, B)
stream is read in place, and the full/mask outputs are then stored
block-major too, so ``states.T.reshape(-1)`` is the stream order without a
copy. A view with neither stride 1 is made contiguous first.

A wrapper launches its kernel for CUDA tensors and takes the plain version
only for CPU tensors. Out-of-range states and classes step to state 0 and
never accept, in both versions, as the JAX engines' one-hot lookup does.
"""

from __future__ import annotations

import torch

from .. import _build

__all__ = [
    "LAUNCHES",
    "dfa_chain",
    "dfa_chain_counts",
    "dfa_chain_plain",
    "dfa_chain_counts_plain",
    "dfa_chain_route",
]

#: Kernel launches since the last reset, one count per kernel.
LAUNCHES = {"dfa_chain": 0, "dfa_chain_counts": 0}

MODES = ("finals", "full", "mask")
_CLASS_DTYPES = {torch.uint8: 1, torch.int16: 2, torch.int32: 4}


def _check_args(table, accept, cls_seq, entries) -> tuple[int, int]:
    """Validate a chain pass's inputs; returns (B, NB)."""
    dev = cls_seq.device
    for name, t in (("table", table), ("accept", accept), ("entries", entries)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, cls_seq on {dev}")
    if cls_seq.dim() != 2:
        raise ValueError(f"cls_seq must be 2-D (B, NB), got {tuple(cls_seq.shape)}")
    if cls_seq.dtype not in _CLASS_DTYPES:
        raise TypeError(f"class ids must be uint8, int16 or int32, got {cls_seq.dtype}")
    if table.dim() != 2 or table.dtype != torch.int32:
        raise TypeError("table must be a (C, S) int32 tensor")
    c, s = table.shape
    if accept.shape != (s,) or accept.dtype != torch.bool:
        raise TypeError(f"accept must be a ({s},) bool tensor")
    b, nb = cls_seq.shape
    if entries.shape != (nb,) or entries.dtype != torch.int32:
        raise TypeError(f"entries must be a ({nb},) int32 tensor")
    if c * s >= 1 << 31 or b >= 1 << 31 or nb >= 1 << 31:
        raise ValueError("table, steps and lanes must each stay below 2^31")
    return b, nb


def _device_args(table, accept, cls_seq, entries):
    """Contiguous tables, and class ids with one stride 1 (the kernel
    stages rows along the contiguous axis)."""
    if 1 not in cls_seq.stride():
        cls_seq = cls_seq.contiguous()
    return table.contiguous(), accept.contiguous(), cls_seq, entries.contiguous()


def _like(cls_seq: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An uninitialised (B, NB) tensor stored in the same order as cls_seq."""
    b, nb = cls_seq.shape
    if cls_seq.stride(0) < cls_seq.stride(1):  # block-major storage
        return torch.empty((nb, b), dtype=dtype, device=cls_seq.device).T
    return torch.empty((b, nb), dtype=dtype, device=cls_seq.device)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {t.device}")


def dfa_chain(table, accept, cls_seq, entries, mode: str = "finals"):
    """K1. Returns (finals (NB,) int32, states (B, NB) int32 or None,
    acc (B, NB) bool or None): ``mode`` "finals" returns finals only,
    "full" all three, "mask" finals and acc."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    b, nb = _check_args(table, accept, cls_seq, entries)
    if cls_seq.device.type == "cpu":
        return dfa_chain_plain(table, accept, cls_seq, entries, mode)
    _require_cuda(cls_seq)
    table, accept, cls_seq, entries = _device_args(table, accept, cls_seq,
                                                   entries)
    c, s = table.shape
    finals = torch.empty(nb, dtype=torch.int32, device=cls_seq.device)
    states = _like(cls_seq, torch.int32) if mode == "full" else None
    acc = _like(cls_seq, torch.bool) if mode != "finals" else None
    out = states if states is not None else acc
    out_ls, out_ss = (out.stride(1), out.stride(0)) if out is not None else (0, 0)
    LAUNCHES["dfa_chain"] += 1
    with torch.cuda.device(cls_seq.device):
        rc = _build.library().dfa_chain(
            cls_seq.data_ptr(), _CLASS_DTYPES[cls_seq.dtype],
            cls_seq.stride(1), cls_seq.stride(0),
            table.data_ptr(), accept.data_ptr(), c, s,
            entries.data_ptr(), nb, b, finals.data_ptr(),
            states.data_ptr() if states is not None else None,
            acc.data_ptr() if acc is not None else None,
            out_ls, out_ss, _stream(cls_seq.device),
        )
    _build.check(rc, "dfa_chain")
    return finals, states, acc


def dfa_chain_counts(table, accept, cls_seq, entries,
                     num_streams: int | None = None):
    """K2. Returns (finals (NB,) int32, counts int32): counts[s] is the
    number of steps taken from state s when s accepts (visits * accept).
    With ``num_streams`` N, lanes are grouped stream-major (NB/N lanes per
    stream) and counts is (N, S); without it counts is (S,)."""
    b, nb = _check_args(table, accept, cls_seq, entries)
    n = 1 if num_streams is None else num_streams
    if n < 1 or nb % n:
        raise ValueError(f"{nb} lanes do not split into {n} streams")
    if cls_seq.device.type == "cpu":
        return dfa_chain_counts_plain(table, accept, cls_seq, entries, num_streams)
    _require_cuda(cls_seq)
    table, accept, cls_seq, entries = _device_args(table, accept, cls_seq,
                                                   entries)
    c, s = table.shape
    finals = torch.empty(nb, dtype=torch.int32, device=cls_seq.device)
    counts = torch.zeros((n, s), dtype=torch.int32, device=cls_seq.device)
    LAUNCHES["dfa_chain_counts"] += 1
    with torch.cuda.device(cls_seq.device):
        rc = _build.library().dfa_chain_counts(
            cls_seq.data_ptr(), _CLASS_DTYPES[cls_seq.dtype],
            cls_seq.stride(1), cls_seq.stride(0),
            table.data_ptr(), accept.data_ptr(), c, s,
            entries.data_ptr(), nb, b, finals.data_ptr(),
            counts.data_ptr(), max(nb // n, 1), _stream(cls_seq.device),
        )
    _build.check(rc, "dfa_chain_counts")
    return finals, (counts if num_streams is not None else counts[0])


def dfa_chain_route(mode: str, num_classes: int, num_states: int,
                    num_lanes: int = 1, num_streams: int = 1,
                    class_dtype: torch.dtype = torch.uint8) -> dict:
    """Where the kernel keeps its data for these shapes on the current card:
    {"table": "shared int32" | "shared uint16" | "global", "table_smem":
    bool, "hist_smem": bool, "lanes_per_cta": int}."""
    code = {"finals": 0, "full": 1, "mask": 2, "counts": 3}[mode]
    lib = _build.library()
    r = lib.dfa_chain_route(code, _CLASS_DTYPES[class_dtype], num_classes,
                            num_states, num_lanes,
                            max(num_lanes // num_streams, 1))
    table = ("global", "shared int32", "shared uint16")[r & 3]
    return {"table": table, "table_smem": table != "global",
            "hist_smem": bool(r & 4),
            "lanes_per_cta": lib.dfa_chain_lanes_per_cta()}


# --------------------------------------------------------------- plain versions


def _step(flat, c_dim: int, s_dim: int, state, cls):
    """One step of every lane: T[cls, state], or 0 out of range."""
    ok = (state >= 0) & (state < s_dim) & (cls >= 0) & (cls < c_dim)
    idx = torch.where(ok, cls * s_dim + state, 0)
    return torch.where(ok, torch.take(flat, idx), 0)


def _accepts(accept, s_dim: int, state):
    ok = (state >= 0) & (state < s_dim)
    return ok & torch.take(accept, torch.where(ok, state, 0).long())


def dfa_chain_plain(table, accept, cls_seq, entries, mode: str = "finals"):
    """Plain-torch K1: one loop iteration and a gather per step."""
    b, nb = cls_seq.shape
    c_dim, s_dim = table.shape
    flat = table.reshape(-1)
    state = entries.to(torch.int32)
    dev = cls_seq.device
    states = (torch.empty((b, nb), dtype=torch.int32, device=dev)
              if mode == "full" else None)
    acc = (torch.empty((b, nb), dtype=torch.bool, device=dev)
           if mode != "finals" else None)
    for t in range(b):
        if states is not None:
            states[t] = state
        if acc is not None:
            acc[t] = _accepts(accept, s_dim, state)
        state = _step(flat, c_dim, s_dim, state, cls_seq[t].long()).to(torch.int32)
    return state, states, acc


def dfa_chain_counts_plain(table, accept, cls_seq, entries,
                           num_streams: int | None = None):
    """Plain-torch K2: per-step accept visits added into an (N*S,) count."""
    b, nb = cls_seq.shape
    c_dim, s_dim = table.shape
    n = 1 if num_streams is None else num_streams
    flat = table.reshape(-1)
    dev = cls_seq.device
    base = (torch.arange(nb, device=dev) // max(nb // n, 1)) * s_dim
    visits = torch.zeros(n * s_dim, dtype=torch.int64, device=dev)
    state = entries.to(torch.int32)
    for t in range(b):
        hit = _accepts(accept, s_dim, state)
        visits.index_add_(0, base + torch.where(hit, state, 0), hit.long())
        state = _step(flat, c_dim, s_dim, state, cls_seq[t].long()).to(torch.int32)
    counts = visits.to(torch.int32).reshape(n, s_dim)
    return state, (counts if num_streams is not None else counts[0])
