"""k-gram precomposition: scan k bytes per engine step (counting mode).

The counterpart of ``regex_fpga_tpu/ops/kgram.py``. Transition functions
compose associatively, so k consecutive byte classes fuse into one k-gram
class whose table row is the composed function; the engine then takes k
bytes per step. Per-position match bits are not observable at k-gram
granularity, so an accept-count table rides alongside:

    A_1[c, s]        = accept(s)                      (count before the byte)
    A_2k[(c1,c2), s] = A_k[c1, s] + A_k[c2, T_k[c1, s]]

giving exact total match counts. The table construction is the JAX package's
numpy code; the chain pass runs on the K3 Hopper kernel (``hopper_kgram``):
the scans take the tables packed once per automaton (``pack_ta``) and, with
the packed byte and pair maps (``kgram_maps``), the raw text itself: the
kernel then derives each step's class, and no class-id tensor is built.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .hopper_kgram import (
    KgramMaps,
    PackedTa,
    kgram_bytes_supported,
    kgram_chain,
    kgram_chain_bytes,
    map_classes,
    map_levels,
    pack_maps,
    pack_ta,
)
from .tables import DfaTables

__all__ = [
    "KGRAM_MAX_STATES",
    "KgramScanResult",
    "KgramTables",
    "build_kgram",
    "dfa_scan_kgram",
    "kgram_maps",
    "kgram_pass_full",
    "map_kgram_classes",
    "pack_ta",
]

#: Largest automaton that ``DfaMatcher.count`` sends to the k-gram engine.
#: The value is the JAX package's crossover, kept so that both packages
#: choose the same engine; the H100's own crossover is not measured yet.
KGRAM_MAX_STATES = 32


@dataclasses.dataclass(frozen=True)
class KgramTables:
    """Composed tables for k = 2^levels bytes per step (numpy arrays)."""

    table: np.ndarray            # (C_k, S) int32 composed transitions
    acc_table: np.ndarray        # (C_k, S) int32 accept counts per step
    class_of: np.ndarray         # (256,) base byte -> level-0 class
    pair_maps: list[np.ndarray]  # level i: (C_i*C_i,) -> C_{i+1}
    level_classes: list[int]     # C_i per level (len = levels + 1)
    num_states: int
    k: int


def _intern_rows(both: np.ndarray, max_classes: int):
    """Dedupe rows of a 2-D int32 array by first-occurrence interning.
    Returns (uniq_rows, remap) or None when distinct rows exceed
    ``max_classes``. First-occurrence order keeps class ids stable."""
    both = np.ascontiguousarray(both, dtype=np.int32)
    seen: dict[bytes, int] = {}
    remap = np.empty(both.shape[0], dtype=np.int32)
    keep: list[int] = []
    for i, row in enumerate(both):
        key = row.tobytes()
        j = seen.get(key)
        if j is None:
            j = len(seen)
            if j >= max_classes:  # blowup: bail before hashing the rest
                return None
            seen[key] = j
            keep.append(i)
        remap[i] = j
    return both[keep], remap


def build_kgram(
    tables: DfaTables, levels: int = 2, max_classes: int = 2048
) -> KgramTables | None:
    """Build 2^levels-gram tables, or None if the class count explodes."""
    t = tables.table.cpu().numpy().astype(np.int32)     # (C, S)
    a = np.broadcast_to(
        tables.accept.cpu().numpy().astype(np.int32), t.shape
    ).copy()                                            # A_1[c, s] = accept[s]
    pair_maps: list[np.ndarray] = []
    level_classes = [t.shape[0]]
    for _ in range(levels):
        c, s = t.shape
        # transient-allocation gate: ~4 * C^2 * S int32 materialize per
        # level before interning can reject
        if c * c > (1 << 22) or c * c * s > (1 << 26):
            return None
        t2 = t[:, t]                       # [c2, c1, s] = t[c2, t[c1, s]]
        t2 = t2.transpose(1, 0, 2)         # [c1, c2, s]
        a2 = a[:, None, :] + a[:, t].transpose(1, 0, 2)
        # a2[c1, c2, s] = a[c1, s] + a[c2, t[c1, s]]
        t2 = t2.reshape(c * c, s)
        a2 = a2.reshape(c * c, s)
        interned = _intern_rows(np.concatenate([t2, a2], axis=1), max_classes)
        if interned is None:
            return None
        uniq, remap = interned
        pair_maps.append(remap)
        t, a = (np.ascontiguousarray(uniq[:, :s]),
                np.ascontiguousarray(uniq[:, s:]))
        level_classes.append(t.shape[0])
    return KgramTables(
        table=t,
        acc_table=a,
        class_of=tables.class_of.cpu().numpy(),
        pair_maps=pair_maps,
        level_classes=level_classes,
        num_states=tables.num_states,
        k=1 << levels,
    )


def map_kgram_classes(kg: KgramTables, data) -> torch.Tensor:
    """Map raw bytes (L,) to k-gram class ids (L/k,) int32, on the device
    that holds ``data`` (a uint8 tensor, or a numpy array, mapped on the
    CPU). Each level pairs neighbouring ids through its remap table."""
    if not isinstance(data, torch.Tensor):
        data = torch.tensor(np.asarray(data, dtype=np.uint8))
    if data.shape[0] % kg.k:
        raise ValueError(f"length {data.shape[0]} is not a multiple of k={kg.k}")
    def lut(a):
        return torch.as_tensor(a, dtype=torch.int32, device=data.device)

    return map_levels(lut(kg.class_of), [lut(m) for m in kg.pair_maps],
                      kg.level_classes, data)


def kgram_maps(kg: KgramTables) -> KgramMaps | None:
    """``class_of`` and the pair maps of ``kg`` packed for the raw-text
    passes, or None when k is not 2, 4 or 8 (the class-id passes remain)."""
    if not 1 <= len(kg.pair_maps) <= 3:
        return None
    return pack_maps(kg.class_of, kg.pair_maps, kg.level_classes)


class KgramScanResult(NamedTuple):
    final_state: torch.Tensor  # () int32
    total: torch.Tensor        # () int64 total matches
    converged: bool
    iterations: int            # full passes executed


def kgram_pass_full(ta: PackedTa, cls_seq, entries, maps: KgramMaps | None = None):
    """One full chain pass over NB lanes with the packed tables ``ta``: final
    states and per-lane accept totals, both (NB,). ``cls_seq`` is (B, NB)
    class-id columns or, with ``maps``, (B, NB, k) raw text."""
    if maps is not None:
        return kgram_chain_bytes(ta, maps, cls_seq, entries)
    return kgram_chain(ta, cls_seq, entries)


def _speculative_entries(ta, blocks: torch.Tensor, start: int,
                         overlap: int, maps) -> torch.Tensor:
    """Entry guesses for all block lanes: each lane replays the previous
    block's last ``overlap`` steps from the start state (lane 0 pinned to
    the true start)."""
    num_blocks, b = blocks.shape[:2]
    ov = min(overlap, b)
    entries0 = torch.full((num_blocks,), start, dtype=torch.int32,
                          device=blocks.device)
    if ov <= 0:
        return entries0
    # lane l replays the tail of block l-1; lane 0's rows are junk
    tails = torch.cat([blocks[:1, b - ov:], blocks[:-1, b - ov:]], dim=0)
    spec, _ = kgram_pass_full(ta, tails.transpose(0, 1), entries0, maps)
    spec[0] = start
    return spec


def dfa_scan_kgram(
    ta: PackedTa,              # T_k and A_k (pack_ta)
    classes_k: torch.Tensor,   # (L/k,) k-gram class ids, or (L,) raw bytes
    num_blocks: int = 65536,
    start: int = 0,
    max_iters: int = 16,
    overlap: int = 16,
    maps: KgramMaps | None = None,
) -> KgramScanResult:
    """Speculative chain scan over k-gram steps; returns the final state and
    the exact total match count.

    With ``maps`` (``kgram_maps``), ``classes_k`` is the raw uint8 text, k
    bytes a step, and the kernel maps it to classes itself; when the maps
    and the table do not fit in the card's shared memory together, the text
    is mapped to class ids first (``map_classes``).

    Each lane first replays the tail of the previous block (speculation);
    full passes then repeat until the entry vector is a fixpoint, so the
    totals of the converging pass were computed from the true entries.
    ``iterations`` counts those full passes, the first included."""
    if maps is not None:
        if classes_k.shape[0] % maps.k:
            raise ValueError(f"length {classes_k.shape[0]} is not a multiple "
                             f"of k={maps.k}")
        if kgram_bytes_supported(ta, maps):
            classes_k = classes_k.reshape(-1, maps.k)
        else:
            classes_k, maps = map_classes(maps, classes_k), None
    l = classes_k.shape[0]
    if l % num_blocks:
        raise ValueError("stream length must be divisible by num_blocks")
    b = l // num_blocks
    dev = classes_k.device
    blocks = classes_k.reshape(num_blocks, b, *classes_k.shape[1:])
    cls_seq = blocks.transpose(0, 1)  # (B, NB) columns over block-major storage
    start_t = torch.tensor([start], dtype=torch.int32, device=dev)

    entries = _speculative_entries(ta, blocks, start, overlap, maps)
    finals = totals = torch.zeros(num_blocks, dtype=torch.int32, device=dev)
    converged, it = False, 0
    while not converged and it < max_iters:
        finals, totals = kgram_pass_full(ta, cls_seq, entries, maps)
        new_entries = torch.cat([start_t, finals[:-1]])
        converged = bool((new_entries == entries).all())
        entries = new_entries
        it += 1
    return KgramScanResult(
        final_state=finals[-1],
        total=totals.sum(),
        converged=converged,
        iterations=it,
    )
