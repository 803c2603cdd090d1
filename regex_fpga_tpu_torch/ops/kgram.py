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

from .dfa_fast import _jacobi, _Lanes, _round, _speculate
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
    "KGRAM_SWEEP",
    "KgramScanResult",
    "KgramTables",
    "build_kgram",
    "choose_kgram_level",
    "choose_scan_level",
    "dfa_scan_kgram",
    "kgram_maps",
    "kgram_pass_full",
    "kgram_step_cost",
    "map_kgram_classes",
    "pack_ta",
]

#: Largest automaton that ``DfaMatcher.count`` sends to the k-gram engine
#: (K3 over raw text, k = 4) instead of the k=1 counting pass (K2): the
#: H100's crossover in ``KGRAM_SWEEP`` (levels 0 and 2): K3 wins at S = 23
#: and 32 and loses at 67 and 107, as in every sweep run on the card so far
#: (PERF.md section 6). The JAX package's TPU crossover is the same number.
KGRAM_MAX_STATES = 32

#: The gate sweep of chip_smoke.py (phase 7, ``phase_gate``): the device
#: time of the counting pass over one 64 MiB chunk of text at 65,536 lanes,
#: by level (0: K2, one byte a step; lv >= 1: K3 at k = 2^lv bytes a step),
#: as rows (S, C_l, the kernel's table route, ms). K3 runs over raw text
#: where the kernel takes the table with its maps; elsewhere the row is the
#: level's map of the bytes to class ids (``map_classes``) and K3 over them.
#: K2 takes the byte classes that every device scan maps (0.300 ms, not in
#: its rows). NVIDIA H100 80GB HBM3 at a 700 W power limit (PERF.md
#: section 6 names the run). The sweep has no level 3 at S = 836 and 4,008
#: and no level 2 at 4,008: their composed classes exceed ``build_kgram``'s
#: limits.
KGRAM_SWEEP = {
    0: ((23, 10, "shared uint32", 0.0742), (32, 17, "shared uint32", 0.0770),
        (67, 28, "shared uint32", 0.0728), (107, 31, "shared uint32", 0.0719),
        (836, 36, "shared uint16", 0.1617), (4008, 36, "global", 0.1588)),
    1: ((23, 49, "shared uint16", 0.0745), (32, 43, "shared uint16", 0.0745),
        (67, 80, "shared uint16", 0.0777), (107, 94, "shared uint16", 0.0750),
        (836, 175, "global", 0.9736), (4008, 217, "global", 0.9735)),
    2: ((23, 221, "shared uint16", 0.0674), (32, 115, "shared uint16", 0.0675),
        (67, 199, "shared uint16", 0.0785), (107, 217, "shared uint16", 0.0809),
        (836, 753, "global", 1.1291)),
    3: ((23, 629, "shared uint16", 0.1400), (32, 475, "shared uint16", 0.1420),
        (67, 726, "shared uint16", 1.1824), (107, 782, "shared uint16", 1.1884)),
}


def kgram_step_cost(s: int, c_l: int, lv: int) -> float:
    """Device seconds per byte of the counting pass at level ``lv`` (0: K2;
    ``lv >= 1``: K3 at k = 2^lv bytes a step) for an automaton of ``s``
    states whose level has ``c_l`` classes: the sweep's times at that level,
    interpolated linearly in the table's cells (``c_l * s``) and held at
    the ends. The cells stand for the table's width and with it its route:
    the sweep's largest tables are read from global memory, or mapped to
    class ids first, at their own measured cost. A level the sweep did not
    reach costs infinity."""
    rows = sorted((c * n, ms) for n, c, _, ms in KGRAM_SWEEP.get(lv, ()))
    if not rows:
        return float("inf")
    cells, ms = zip(*rows)
    return float(np.interp(c_l * s, cells, ms)) * 1e-3 / (64 << 20)


def choose_kgram_level(s: int, level_classes: list[int]) -> int:
    """The cheapest level >= 1 under ``kgram_step_cost``, for callers that
    have already chosen the k-gram engine; ``choose_scan_level`` makes the
    engine choice itself."""
    costs = [kgram_step_cost(s, c_l, lv) for lv, c_l in enumerate(level_classes)]
    return int(np.argmin(costs[1:])) + 1


def choose_scan_level(s: int, level_classes: list[int] | None = None) -> int:
    """The engine of a counting scan: 0 for the k=1 counting pass, ``lv >=
    1`` for the k-gram engine at that level. Above ``KGRAM_MAX_STATES`` (the
    measured crossover) the answer is 0 whatever ``level_classes`` say; at
    or below it the cheapest level under ``kgram_step_cost`` wins, level 0
    included."""
    if s > KGRAM_MAX_STATES or not level_classes:
        return 0
    costs = [kgram_step_cost(s, c_l, lv) for lv, c_l in enumerate(level_classes)]
    return int(np.argmin(costs))


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
    final_state: torch.Tensor  # () int32, on the host (read with the total)
    total: torch.Tensor        # () int64 total matches, on the host
    converged: bool
    iterations: int            # full passes executed


def kgram_pass_full(ta: PackedTa, cls_seq, entries, maps: KgramMaps | None = None):
    """One full chain pass over NB lanes with the packed tables ``ta``: final
    states and per-lane accept totals, both (NB,). ``cls_seq`` is (B, NB)
    class-id columns or, with ``maps``, (B, NB, k) raw text."""
    if maps is not None:
        return kgram_chain_bytes(ta, maps, cls_seq, entries)
    return kgram_chain(ta, cls_seq, entries)


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

    The seams take ``ops/dfa_fast.py``'s protocol (``_speculate``,
    ``_round``, ``_jacobi``), with the full pass as the finals pass: full
    passes repeat until the entry vector is a fixpoint, so the totals of the
    converging pass were computed from the true entries. ``iterations``
    counts those full passes, the first included. The host waits once a
    pass, on the read that brings back the verdict, the total and the final
    state together (a pinned upload before the call may still be in flight
    until then)."""
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
    blocks = classes_k.reshape(num_blocks, l // num_blocks, *classes_k.shape[1:])
    cls_seq = blocks.transpose(0, 1)  # (B, NB) columns over block-major storage
    lanes = _Lanes(torch.full((num_blocks,), start, dtype=torch.int32,
                              device=blocks.device), num_blocks)

    def full(entries):
        finals, totals = kgram_pass_full(ta, cls_seq, entries, maps)
        # the int64 total rides in the int32 read as its two words
        return (finals, totals), (), (totals.sum().reshape(1).view(torch.int32),)

    def full_round(entries):
        return _round(full, entries, lanes, answer=True)

    entries = _speculate(lambda cols, e: kgram_pass_full(ta, cols, e, maps)[0],
                         blocks, lanes, overlap)
    _, verdict, it = _jacobi(full_round, *full_round(entries), lanes, max_iters)
    return KgramScanResult(
        final_state=torch.from_numpy(verdict.final_states.reshape(())),
        total=torch.from_numpy(verdict.answer.view(np.int64).reshape(())),
        converged=verdict.moved == 0,
        iterations=it,
    )
