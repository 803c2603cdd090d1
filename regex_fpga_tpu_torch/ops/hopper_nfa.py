"""K4 and K5: the NFA scans on Hopper, with their plain versions.

``nfa_active_scan`` runs N independent streams through an NFA, each from
its own list of A active states (sentinel ``S`` as padding), and per byte:
counts the accepting states of the list before the byte, gathers their
successors on the byte's class, and keeps the A smallest distinct ones,
ascending, flagging overflow when an (A+1)-th exists. It is the loop of
``regex_fpga_tpu/ops/nfa_engine.py::nfa_scan_jax`` (``_nfa_step`` in a
``lax.scan``, vmapped over streams), bit for bit. The kernel is
``csrc/nfa_active.cu``; it reads the per-class CSR of ``NfaCsr``, narrowed
to 16 bits in shared memory when it fits there (``nfa_active_route``).

Streams are slices of one flat uint8 tensor: stream n is
``data[starts[n] : starts[n] + lengths[n]]``, so ragged flows need no
padding. ``starts`` and ``lengths`` are host sequences (checked on the host,
then uploaded).

``nfa_tp_scan`` (K5) runs B streams of one length through an NFA with no
bound on the active set: each stream carries a bitmap of active states, and
per byte the accepting states of the bitmap count and the union of their
successors becomes the next bitmap. It is the loop of
``regex_fpga_tpu/parallel/tp_scan.py::nfa_scan_tp`` with the model axis of
size one, bit for bit; its kernel is ``csrc/nfa_tp_scan.cu`` and reads the
same CSR (``nfa_tp_route``). ``nfa_tp_scan_sharded`` is the same scan over
a rank's slice of the states, with a cross-rank sum of uint8 successor
flags between two bytes: the route that ``parallel.tp_scan`` takes on more
than one rank, one launch of ``nfa_tp_step`` (same file) a byte.
``nfa_tp_scan_plain`` is the JAX step in torch ops, for either.

A wrapper launches the kernel for CUDA tensors and takes the plain version
only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import weakref

import numpy as np
import torch

from .. import _build
from .tables import NfaCsr

__all__ = ["LAUNCHES", "nfa_active_route", "nfa_active_scan",
           "nfa_active_scan_plain", "nfa_tp_route", "nfa_tp_scan",
           "nfa_tp_scan_plain", "nfa_tp_scan_sharded"]

#: Kernel launches since the last reset.
LAUNCHES = {"nfa_active_scan": 0, "nfa_tp_scan": 0, "nfa_tp_step": 0}


def _check_csr(csr: NfaCsr, dev, **tensors) -> None:
    """The CSR's fields, and ``tensors``, lie on ``dev`` with K4's and K5's
    types and shapes."""
    for name, t in (("offsets", csr.offsets), ("targets", csr.targets),
                    ("class_of", csr.class_of), ("accept", csr.accept),
                    *tensors.items()):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the input on {dev}")
    s = csr.num_states
    if csr.offsets.dtype != torch.int32 or csr.offsets.dim() != 2 \
            or csr.offsets.shape[1] != s + 2:
        raise TypeError(f"offsets must be a (C, {s + 2}) int32 tensor")
    if csr.targets.dtype != torch.int32 or csr.class_of.shape != (256,) \
            or csr.class_of.dtype != torch.int32:
        raise TypeError("targets and class_of must be int32 ((256,) class_of)")
    if csr.accept.shape != (s + 1,) or csr.accept.dtype != torch.bool:
        raise TypeError(f"accept must be a ({s + 1},) bool tensor")


def _check_args(csr: NfaCsr, data, starts, lengths, active, counts):
    """Validate a scan's inputs; returns (starts, lengths) as int64 numpy."""
    _check_csr(csr, data.device, active=active, counts=counts)
    if data.dim() != 1 or data.dtype != torch.uint8:
        raise TypeError("data must be a 1-D uint8 tensor")
    s = csr.num_states
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
            accept.data_ptr(), csr.num_classes, s, targets.shape[0], a,
            active.data_ptr(), counts.data_ptr(), overflow.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(rc, "nfa_active_scan")
    return counts, active, overflow.bool()


def nfa_active_route(csr: NfaCsr, num_streams: int, active_bound: int) -> dict:
    """Where the kernel keeps its data for this NFA on the current card:
    {"csr_smem": bool (narrowed to 16 bits), "counts_smem": bool,
    "streams_per_cta": int}. Raises when one stream does not fit."""
    r = _build.library().nfa_active_route(
        csr.num_classes, csr.num_states, csr.targets.shape[0], active_bound,
        num_streams)
    if r < 0:
        raise ValueError(f"{csr.num_states} states and a bound of "
                         f"{active_bound} exceed the card's shared memory")
    return {"csr_smem": bool(r & 1), "counts_smem": bool(r & 2),
            "streams_per_cta": r >> 8}


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


# ----------------------------------------------------------------------- K5


def _check_tp_args(csr: NfaCsr, streams, bitmap, counts) -> None:
    _check_csr(csr, streams.device, bitmap=bitmap, counts=counts)
    if streams.dim() != 2 or streams.dtype != torch.uint8:
        raise TypeError("streams must be a (B, L) uint8 tensor")
    b = streams.shape[0]
    if bitmap.dim() != 2 or bitmap.shape[0] != b or bitmap.dtype != torch.bool:
        raise TypeError(f"bitmap must be a ({b}, N) bool tensor")
    if counts.shape != bitmap.shape or counts.dtype != torch.int32:
        raise TypeError(f"counts must be a {tuple(bitmap.shape)} int32 tensor")


def nfa_tp_scan(csr: NfaCsr, streams, bitmap, counts):
    """K5. ``streams`` (B, L) uint8; ``bitmap`` (B, N) bool, the active
    states before the first byte (N >= S + 1, states >= S inert);
    ``counts`` (B, N) int32, the starting counts. Returns (counts (B, N)
    int32, bitmap (B, N) bool) after the last byte; the inputs are not
    modified."""
    _check_tp_args(csr, streams, bitmap, counts)
    s = csr.num_states
    if bitmap.shape[1] < s + 1:
        raise ValueError(f"the bitmap must cover the {s + 1} states and "
                         f"the sentinel")
    if streams.device.type == "cpu":
        return nfa_tp_scan_plain(csr, streams, bitmap, counts)
    if streams.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {streams.device}")
    n_acc, start_off, start_rows, two_step, slots, d, max_row = _k5_aux(csr)
    two_off, two_rows = two_step if two_step is not None else (None, None)
    b, length = streams.shape
    n = bitmap.shape[1]
    dev = streams.device
    words = _pack_bits(bitmap)
    out = counts.contiguous().clone()
    streams = streams.contiguous()
    offsets, targets = csr.offsets.contiguous(), csr.targets.contiguous()
    class_of, accept = csr.class_of.contiguous(), csr.accept.contiguous()
    LAUNCHES["nfa_tp_scan"] += 1
    with torch.cuda.device(dev):
        rc = _build.library().nfa_tp_scan(
            streams.data_ptr(), length, b, class_of.data_ptr(),
            offsets.data_ptr(), targets.data_ptr(), accept.data_ptr(),
            csr.num_classes, s, targets.shape[0], n_acc, start_off.data_ptr(),
            start_rows.data_ptr(), start_rows.shape[0],
            two_off.data_ptr() if two_off is not None else None,
            two_rows.data_ptr() if two_rows is not None else None,
            slots.data_ptr(), d, max_row, words.data_ptr(), out.data_ptr(), n,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(rc, "nfa_tp_scan")
    return out, _unpack_bits(words, n)


def _check_targets(csr: NfaCsr) -> None:
    s = csr.num_states
    tg = csr.targets
    if tg.numel() and bool(((tg < 0) | (tg >= s)).any()):
        raise ValueError(f"CSR targets must lie in [0, {s})")


_K5_AUX: dict = {}  # id(csr) -> what K5 reads beside the CSR, while csr lives
_SLOT_LIMIT = 8  # edge slots a state at most (csrc/nfa_tp_scan.cu: WIDE)
_TWO_STEP_LIMIT = 1 << 20  # states two bytes deep, summed over class pairs


def _k5_aux(csr: NfaCsr):
    """What K5 reads beside the CSR, built once per CSR on its device (the
    CSR's tensors are taken as fixed): (the accepting states below S; the
    start state's successors on each class as (word, mask) pairs, one pair
    a word, the start state itself left out: (C+1,) int32 offsets, whose
    top bit says that the start state loops to itself on the class, and
    whose next bit that one of the successors accepts, and (P, 2) int32
    rows; ``_two_step``'s table or None; ``_edge_slots``'s slots and D; the
    longest row of any state but the start state). Raises when a target
    lies outside [0, S)."""
    key = id(csr)
    if key in _K5_AUX:
        return _K5_AUX[key]
    _check_targets(csr)
    s, c, dev = csr.num_states, csr.num_classes, csr.device
    words = -(-s // 32) if s else 1
    off = csr.offsets.long()
    lens = off[:, 1] - off[:, 0]  # row 0; with S = 0 the sentinel's, empty
    cls = torch.repeat_interleave(torch.arange(c, device=dev), lens)
    first = torch.repeat_interleave(off[:, 0] - (lens.cumsum(0) - lens), lens)
    tgt = torch.index_select(csr.targets, 0,
                             first + torch.arange(cls.numel(), device=dev)).long()
    pair = torch.unique(cls * max(s, 1) + tgt)  # a target once a class
    cls, tgt = pair // max(s, 1), pair % max(s, 1)
    loops = torch.zeros(c, dtype=torch.int64, device=dev)
    loops[cls[tgt == 0]] = 1 << 31
    cls, tgt = cls[tgt != 0], tgt[tgt != 0]
    # a class with several accepting successors is flagged once: an indexed
    # += writes each index once
    loops[cls[csr.accept[tgt]]] += 1 << 30
    two_step = _two_step(csr, cls, tgt, words)
    start_off, rows = _pairs(cls, tgt, words, c)
    max_row = int((off[:, 2:s + 1] - off[:, 1:s]).max()) if s > 1 else 0
    slots, d = _edge_slots(csr)
    start_off[:c] += loops
    aux = (int(csr.accept[:s].sum()),
           _as_int32_bits(start_off).to(torch.int32).contiguous(), rows,
           two_step, slots, d, max_row)
    _K5_AUX[key] = aux
    weakref.finalize(csr, _K5_AUX.pop, key, None)
    return aux


def _pairs(group, tgt, words: int, n_groups: int):
    """The targets of each group as (word, mask) pairs, one pair a word:
    ((n_groups + 1,) int64 offsets, (P, 2) int32 rows); ``group`` and
    ``tgt`` hold distinct (group, target) pairs."""
    key, inv = torch.unique(group * words + (tgt >> 5), return_inverse=True)
    masks = torch.zeros(key.numel(), dtype=torch.int64, device=tgt.device) \
        .index_add_(0, inv, torch.bitwise_left_shift(torch.ones_like(tgt), tgt & 31))
    rows = torch.stack([key % words, _as_int32_bits(masks)], 1).to(torch.int32)
    off = torch.zeros(n_groups + 1, dtype=torch.int64, device=tgt.device)
    off[1:] = torch.bincount(key // words, minlength=n_groups).cumsum(0)
    return off, rows.contiguous()


def _two_step(csr: NfaCsr, p_cls, p_state, words: int):
    """The start state's successors (``p_cls``, ``p_state``: class and
    state, the start state left out) stepped once more: for each pair of
    classes (c1, c2), the successors on c2 of the start state's successors
    on c1, as (word, mask) pairs: ((C * C + 1,) int32 offsets, (Q, 2) int32
    rows). None when a state other than the start state has an edge into a
    start successor (then they must be listed as real states) or the table
    would exceed its limit."""
    s, c, dev = csr.num_states, csr.num_classes, csr.device
    e_cls, e_src, e_tgt = _edges(csr, 1, s)
    e_src = e_src + 1
    start_succ = torch.zeros(max(s, 1), dtype=torch.bool, device=dev)
    start_succ[p_state] = True
    if p_state.numel() == 0 or bool(start_succ[e_tgt].any()):
        return None
    order = torch.argsort(e_src, stable=True)
    e_cls, e_src, e_tgt = e_cls[order], e_src[order], e_tgt[order]
    deg = torch.bincount(e_src, minlength=s)
    first = deg.cumsum(0) - deg
    n = deg[p_state]
    total = int(n.sum())
    if total > _TWO_STEP_LIMIT:
        return None
    c1 = torch.repeat_interleave(p_cls, n)
    k = torch.repeat_interleave(first[p_state] - (n.cumsum(0) - n), n) \
        + torch.arange(total, device=dev)
    pair = torch.unique((c1 * c + e_cls[k]) * s + e_tgt[k])
    off, rows = _pairs(pair // s, pair % s, words, c * c)
    return off.to(torch.int32).contiguous(), rows


def _as_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values below 2^32 as the int32 of the same 32 bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x)


def _edge_slots(csr: NfaCsr):
    """Each state's edges over all classes in D slots, (S, D) int32 of
    class << 24 | target and -1 for none, the start state's empty; D the
    most edges of any other state. An empty tensor and D = 0 when D is 0 or
    above the slot limit."""
    s, dev = csr.num_states, csr.device
    deg = (csr.offsets[:, 1:s + 1] - csr.offsets[:, :s]).sum(0)
    d = int(deg[1:].max()) if s > 1 else 0
    if not 0 < d <= _SLOT_LIMIT:
        return torch.empty(0, dtype=torch.int32, device=dev), 0
    e_cls, e_src, e_tgt = _edges(csr, 1, s)
    order = torch.argsort(e_src, stable=True)
    e_cls, e_src, e_tgt = e_cls[order], e_src[order] + 1, e_tgt[order]
    first = torch.zeros(s, dtype=torch.long, device=dev)
    first[1:] = deg[:-1].long().cumsum(0)
    first -= deg[0]  # the start state's edges are not among them
    rank = torch.arange(e_src.numel(), device=dev) - first[e_src]
    slots = torch.full((s * d,), -1, dtype=torch.int64, device=dev)
    slots[e_src * d + rank] = (e_cls << 24) | e_tgt
    return _as_int32_bits(slots).to(torch.int32).reshape(s, d), d


def nfa_tp_scan_sharded(csr: NfaCsr, streams, bitmap, counts, lo: int,
                        s_pad: int, all_reduce=None):
    """K5 over one rank's slice of the states. ``bitmap`` (B, n) bool and
    ``counts`` (B, n) int32 hold the states lo..lo+n-1 of ``s_pad``. Per
    byte: the accepting active states count, the successors of the active
    states are flagged in a (B, s_pad) uint8 vector, ``all_reduce`` (when
    given) sums it over the ranks in place, and its slice > 0 is the next
    bitmap. CUDA tensors take one launch of ``nfa_tp_step`` a byte, CPU
    tensors ``nfa_tp_scan_plain``. Returns (counts (B, n) int32, bitmap
    (B, n) bool); the inputs are not modified."""
    _check_tp_args(csr, streams, bitmap, counts)
    s = csr.num_states
    b, length = streams.shape
    n = bitmap.shape[1]
    if lo < 0 or lo + n > s_pad or s_pad < s + 1:
        raise ValueError(f"states {lo}..{lo + n - 1} do not lie in an s_pad "
                         f"of {s_pad} >= {s + 1}")
    if streams.device.type == "cpu":
        return nfa_tp_scan_plain(csr, streams, bitmap, counts, lo, s_pad,
                                 all_reduce)
    if streams.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {streams.device}")
    _check_targets(csr)
    if b > 65535:
        raise ValueError("at most 65,535 streams a launch")
    dev = streams.device
    out = counts.contiguous().clone()
    if length == 0:
        return out, bitmap.clone()
    streams = streams.contiguous()
    offsets, targets = csr.offsets.contiguous(), csr.targets.contiguous()
    class_of, accept = csr.class_of.contiguous(), csr.accept.contiguous()
    # three rotating flag buffers, each 16-byte aligned: launch t reads t % 3,
    # writes (t+1) % 3 and clears (t+2) % 3
    stride = -(-(b * s_pad) // 16) * 16
    flags = torch.zeros((3, stride), dtype=torch.uint8, device=dev)
    views = [flags[k, :b * s_pad].view(b, s_pad) for k in range(3)]
    views[0][:, lo:lo + n] = bitmap
    step = _build.library().nfa_tp_step
    with torch.cuda.device(dev):
        # every argument as a ctypes value, built once: a byte sets t in place
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        t_arg = i64(0)
        args = (ptr(streams.data_ptr()), i64(length), t_arg, i32(b),
                ptr(class_of.data_ptr()), ptr(offsets.data_ptr()),
                ptr(targets.data_ptr()), ptr(accept.data_ptr()), i32(s), i32(lo),
                i32(n), i32(s_pad), ptr(flags.data_ptr()), i64(stride),
                ptr(out.data_ptr()),
                ptr(torch.cuda.current_stream(dev).cuda_stream))
        for t in range(length):
            t_arg.value = t
            rc = step(*args)
            if rc:
                _build.check(rc, "nfa_tp_step")
            if all_reduce is not None:
                all_reduce(views[(t + 1) % 3])
    LAUNCHES["nfa_tp_step"] += length
    # no CSR edge reaches the sentinel S, so the slice needs no clearing
    return out, views[length % 3][:, lo:lo + n] > 0


def nfa_tp_route(csr: NfaCsr, num_streams: int = 1) -> dict:
    """Where K5 keeps its data for this NFA and ``num_streams`` streams on
    the current card: {"edges": "shared CSR" (narrowed to 16 bits, with the
    start pairs), "shared slots" (each state's edges in a few slots) or
    "global CSR"; "counters_smem": bool; "bitmap": "register" (a word a
    lane, S <= 1,024) or "listed" (shared bitmaps with lists of their
    non-zero words); "start": how the start state's successors join the
    next set ("dense words": a word a lane; "pairs": listed as they are
    set; "two-step": never listed, stepped by a table per pair of
    classes); "warps_per_cta": streams a CTA, a warp each}. Raises when
    one stream's bitmaps do not fit in shared memory."""
    n_acc, _, start_rows, two_step, _, d, _ = _k5_aux(csr)
    r = _build.library().nfa_tp_route(csr.num_classes, csr.num_states,
                                      csr.targets.shape[0], n_acc,
                                      start_rows.shape[0], d, num_streams)
    if r < 0:
        raise ValueError(f"the bitmaps of {csr.num_states} states exceed the "
                         f"card's shared memory")
    listed = bool(r & 8)
    return {"edges": ("global CSR", "shared CSR", "shared slots")[r & 3],
            "counters_smem": bool(r & 4),
            "bitmap": "listed" if listed else "register",
            "start": ("dense words" if not listed else
                      "pairs" if two_step is None else "two-step"),
            "warps_per_cta": r >> 8}


def _pack_bits(bitmap: torch.Tensor) -> torch.Tensor:
    """(B, N) bool -> (B, ceil(N / 32)) int32 words, state i at bit i % 32
    of word i // 32."""
    b, n = bitmap.shape
    w = -(-n // 32)
    bits = torch.zeros((b, w * 32), dtype=torch.int64, device=bitmap.device)
    bits[:, :n] = bitmap
    weights = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=bitmap.device),
        torch.arange(32, device=bitmap.device))
    words = (bits.reshape(b, w, 32) * weights).sum(-1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words) \
        .to(torch.int32).contiguous()


def _unpack_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = torch.bitwise_right_shift(words[..., None], shifts) & 1
    return bits.reshape(words.shape[0], -1)[:, :n].bool()


def _edges(csr: NfaCsr, lo: int, hi: int):
    """The CSR's edges from the states lo..hi-1, as (class, source - lo,
    target) int64 tensors."""
    s = csr.num_states
    lens = (csr.offsets[:, 1:] - csr.offsets[:, :-1]).reshape(-1).long()
    rows = torch.repeat_interleave(
        torch.arange(lens.numel(), device=lens.device), lens)
    first = int(csr.offsets[0, 0]) if csr.offsets.numel() else 0
    tgt = csr.targets[first:first + rows.numel()].long()
    cls, src = rows // (s + 1), rows % (s + 1)
    keep = (src >= lo) & (src < min(hi, s))
    return cls[keep], src[keep] - lo, tgt[keep]


def nfa_tp_scan_plain(csr: NfaCsr, streams, bitmap, counts, lo: int = 0,
                      s_pad: int | None = None, all_reduce=None):
    """Plain-torch K5, the JAX step: per byte, counts += bitmap & accept;
    the successors of the active states are scatter-added into an
    (B, s_pad) count, which becomes uint8 flags (> 0); ``all_reduce`` (when
    given) sums the flags over the ranks in place (at most 255 ranks, so
    the sum fits), and their slice > 0, with the sentinel slot S cleared, is
    the next bitmap: JAX's int32 ``psum`` then ``> 0`` gives the same
    bitmap. ``bitmap`` and ``counts`` (B, n) hold the states lo..lo+n-1 of
    ``s_pad`` (default n)."""
    dev = streams.device
    b, length = streams.shape
    n = bitmap.shape[1]
    s = csr.num_states
    s_pad = n if s_pad is None else s_pad
    e_cls, e_src, e_tgt = _edges(csr, lo, lo + n)
    acc = torch.zeros(n, dtype=torch.bool, device=dev)
    real = csr.accept[lo:min(lo + n, s)]
    acc[:real.numel()] = real
    cls = torch.index_select(csr.class_of, 0, streams.reshape(-1).int()) \
        .reshape(b, length)
    bm = bitmap.clone()
    cnt = counts.clone()
    sentinel = s - lo if lo <= s < lo + n else None
    for t in range(length):
        cnt += (bm & acc).to(cnt.dtype)
        w = bm[:, e_src] & (e_cls[None, :] == cls[:, t:t + 1])
        partial = torch.zeros((b, s_pad), dtype=torch.int32, device=dev)
        partial.index_add_(1, e_tgt, w.to(torch.int32))
        flags = (partial > 0).to(torch.uint8)
        if all_reduce is not None:
            all_reduce(flags)
        bm = flags[:, lo:lo + n] > 0
        if sentinel is not None:
            bm[:, sentinel] = False
    return cnt, bm
