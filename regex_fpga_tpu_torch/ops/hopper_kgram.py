"""K3: the k-gram chain pass on Hopper, with its plain version.

``kgram_chain`` runs NB independent chains over k-gram class ids:
``(state, total) <- (T_k[c, state], total + A_k[c, state])`` per step, and
returns each lane's final state and accept total. It reads T_k and A_k
interleaved, as one (C, S, 2) int32 table that ``pack_ta`` builds once per
automaton. The kernel is
``csrc/kgram_chain.cu``; it replaces the TPU kernel
``regex_fpga_tpu/ops/pallas_kgram.py::_kernel`` without that kernel's packed
128-lane table or its limit of 64 states.

Layout, dispatch and out-of-range rules are those of ``hopper_dfa``:
``cls_seq`` is (B, NB) in either storage order, CUDA tensors launch the
kernel, CPU tensors take the plain version.
"""

from __future__ import annotations

import torch

from .. import _build
from .hopper_dfa import _CLASS_DTYPES, _require_cuda, _step, _stream

__all__ = ["LAUNCHES", "kgram_chain", "kgram_chain_plain", "kgram_chain_route",
           "pack_ta"]

#: Kernel launches since the last reset.
LAUNCHES = {"kgram_chain": 0}


def pack_ta(table: torch.Tensor, acc_table: torch.Tensor) -> torch.Tensor:
    """T_k and A_k, both (C, S) int32, interleaved into the (C, S, 2) int32
    table that the K3 wrappers take."""
    if acc_table.shape != table.shape or table.dim() != 2:
        raise TypeError("table and acc_table must be (C, S) tensors of one shape")
    return torch.stack([table.to(torch.int32), acc_table.to(torch.int32)],
                       dim=-1).contiguous()


def _check_args(ta, cls_seq, entries) -> tuple[int, int]:
    dev = cls_seq.device
    for name, t in (("ta", ta), ("entries", entries)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, cls_seq on {dev}")
    if cls_seq.dim() != 2:
        raise ValueError(f"cls_seq must be 2-D (B, NB), got {tuple(cls_seq.shape)}")
    if cls_seq.dtype not in _CLASS_DTYPES:
        raise TypeError(f"class ids must be uint8, int16 or int32, got {cls_seq.dtype}")
    if ta.dim() != 3 or ta.shape[2] != 2 or ta.dtype != torch.int32:
        raise TypeError("ta must be a (C, S, 2) int32 tensor (pack_ta)")
    b, nb = cls_seq.shape
    if entries.shape != (nb,) or entries.dtype != torch.int32:
        raise TypeError(f"entries must be a ({nb},) int32 tensor")
    c, s, _ = ta.shape
    if c * s >= 1 << 31 or b >= 1 << 31 or nb >= 1 << 31:
        raise ValueError("table, steps and lanes must each stay below 2^31")
    return b, nb


def kgram_chain(ta, cls_seq, entries):
    """K3 over the packed table ``ta`` (``pack_ta``). Returns (finals (NB,)
    int32, totals (NB,) int32)."""
    b, nb = _check_args(ta, cls_seq, entries)
    if cls_seq.device.type == "cpu":
        return kgram_chain_plain(ta, cls_seq, entries)
    _require_cuda(cls_seq)
    c, s, _ = ta.shape
    ta, entries = ta.contiguous(), entries.contiguous()
    finals = torch.empty(nb, dtype=torch.int32, device=cls_seq.device)
    totals = torch.empty(nb, dtype=torch.int32, device=cls_seq.device)
    LAUNCHES["kgram_chain"] += 1
    with torch.cuda.device(cls_seq.device):
        rc = _build.library().kgram_chain(
            cls_seq.data_ptr(), _CLASS_DTYPES[cls_seq.dtype],
            cls_seq.stride(1), cls_seq.stride(0),
            ta.data_ptr(), c, s, entries.data_ptr(), nb, b,
            finals.data_ptr(), totals.data_ptr(), _stream(cls_seq.device),
        )
    _build.check(rc, "kgram_chain")
    return finals, totals


def kgram_chain_route(num_classes: int, num_states: int) -> dict:
    """Where the kernel keeps its table for these shapes on the current card."""
    return {"table_smem": bool(_build.library().kgram_chain_route(
        num_classes, num_states))}


def kgram_chain_plain(ta, cls_seq, entries):
    """Plain-torch K3: one loop iteration and two gathers per step."""
    b, _ = cls_seq.shape
    c_dim, s_dim, _ = ta.shape
    flat_t, flat_a = ta[..., 0].reshape(-1), ta[..., 1].reshape(-1)
    state = entries.to(torch.int32)
    total = torch.zeros_like(state)
    for t in range(b):
        cls = cls_seq[t].long()
        total += _step(flat_a, c_dim, s_dim, state, cls).to(torch.int32)
        state = _step(flat_t, c_dim, s_dim, state, cls).to(torch.int32)
    return state, total
