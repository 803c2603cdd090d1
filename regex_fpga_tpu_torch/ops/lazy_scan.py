"""Host/device loop for lazy-subset-DFA NFA scanning.

The counterpart of ``regex_fpga_tpu/ops/lazy_scan.py``:

  1. warm the lazy DFA with a short host walk (interning the hot states);
  2. snapshot the known table to the device (cached: re-uploaded only when
     the automaton's version or the padded size changed) and chain-scan
     fixed-size chunks on K1/K2 (``dfa_take``), with the visit counts of the
     accepting subset states accumulated on the device;
  3. when a chunk fell off the known frontier or its seams did not
     converge, warm the hub-restart paths and retry it once, then re-run it
     through the states pass, keep the exact prefix, expand on the host
     along the true path (guaranteed progress) and continue.

Every byte is counted exactly once; the result equals the golden NFA oracle
and the JAX package bit for bit. The host walks run on the portable native
build (``regex_fpga_tpu_torch.native``) when the LazyDfa comes from
``native.lazy_dfa``. Raw bytes are uploaded and mapped to classes on the
device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models import LazyDfa
from .dfa_take import dfa_scan_take, dfa_scan_take_counts
from .tables import host_to_device

__all__ = ["LazyScanState", "lazy_nfa_scan"]


class LazyScanState(NamedTuple):
    counts: np.ndarray   # (num_nfa_states,) int64
    state_id: int        # current subset-state id
    offset: int          # bytes consumed


class _DeviceCache:
    """The table snapshot on one device, keyed by (automaton version, pad)."""

    def __init__(self, ld: LazyDfa, device: torch.device):
        self.device = device
        self.version = -1
        self.pad = 0
        self.table = None    # (C, pad+1) int32
        self.accept = None   # (pad+1,) bool: accepting subsets and unknown
        self.unknown = None
        self.class_lut = torch.as_tensor(ld.class_of.astype(np.uint8),
                                         device=device)

    def ensure(self, ld: LazyDfa) -> None:
        version = ld.version  # counts expansions too, not just interns
        pad = _pad_for(ld)
        if self.version != version or self.pad != pad:
            table, unknown, n_acc = ld.snapshot(pad_to=pad)
            accept = n_acc > 0
            accept[unknown] = True
            self.table = torch.as_tensor(table, device=self.device)
            self.accept = torch.as_tensor(accept, device=self.device)
            self.unknown = unknown
            self.version = version
            self.pad = pad

    def classes(self, raw: np.ndarray) -> torch.Tensor:
        """uint8 class ids of raw bytes, mapped on the device."""
        data = host_to_device(raw, self.device)
        return torch.index_select(self.class_lut, 0, data.int())


def _cache(ld: LazyDfa, device: torch.device) -> _DeviceCache:
    caches = ld.__dict__.setdefault("_torch_device_caches", {})
    if device not in caches:
        caches[device] = _DeviceCache(ld, device)
    return caches[device]


def _pad_for(ld: LazyDfa) -> int:
    pad = 1 << 10
    while pad < ld.num_states:
        pad *= 2
    return pad


def lazy_nfa_scan(
    ld: LazyDfa,
    stream: np.ndarray,
    carry: LazyScanState | None = None,
    warm_bytes: int = 1 << 15,
    host_step: int = 1 << 15,
    num_blocks: int = 1024,
    min_block_bytes: int = 64,
    max_iters: int = 24,
    device_chunk: int = 1 << 22,
    device=None,
) -> LazyScanState:
    """Scan ``stream`` on ``device`` (default: the first CUDA card, else
    the CPU), resuming from ``carry``. Returns the per-NFA-state counts, the
    subset state after the stream and the offset."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    stream = np.ascontiguousarray(stream, dtype=np.uint8)
    if carry is None:
        counts = np.zeros(ld.aut.num_states, dtype=np.int64)
        sid = ld.start
        base = 0
    else:
        counts, sid, base = np.array(carry.counts), carry.state_id, carry.offset
    cache = _cache(ld, torch.device(device))

    p = 0
    n = len(stream)
    if carry is None and n:
        counts, sid, consumed = ld.host_scan(stream, sid, counts, max_bytes=warm_bytes)
        p = consumed

    def counts_pass(classes, start, nb):
        vbuf = torch.zeros(cache.pad + 1, dtype=torch.int32, device=cache.device)
        return dfa_scan_take_counts(
            cache.table, classes, vbuf, cache.accept, num_blocks=nb,
            start=start, max_iters=max_iters, sync_state=ld.start,
        )

    while p < n:
        rest = n - p
        l = min(rest, device_chunk)
        nb = num_blocks
        while nb > 1 and l // nb < min_block_bytes:
            nb //= 2
        l = (l // nb) * nb
        if l < nb or nb <= 1:
            counts, sid, consumed = ld.host_scan(stream[p:], sid, counts)
            p += consumed
            continue

        cache.ensure(ld)

        # ---- optimistic dispatch of full-size chunks ----------------------
        # Chunk k+1's entry is chunk k's final state, chained on the device;
        # flags are read once for the whole batch, and the per-chunk visit
        # counts merge only for the validated prefix (a bad chunk garbles
        # every later entry).
        if l == device_chunk:
            batch = []
            start_dev = sid
            while p + l <= n and len(batch) < 16:
                classes = cache.classes(stream[p : p + l])
                r = counts_pass(classes, start_dev, nb)
                batch.append((p, classes, r))
                start_dev = r.final_state
                p += l
            unknown = torch.stack([c.unknown_hit for _, _, c in batch]).cpu()
            bad = [i for i, (_, _, c) in enumerate(batch)
                   if not c.converged or bool(unknown[i])]
            good_upto = bad[0] if bad else len(batch)
            if good_upto:
                merged = batch[0][2].visits_acc
                for _, _, c in batch[1:good_upto]:
                    merged = merged + c.visits_acc
                counts += ld.accept_counts(merged.cpu().numpy())
                sid = int(batch[good_upto - 1][2].final_state)
            if not bad:
                continue
            # rewind to the first bad chunk
            p, classes, _ = batch[good_upto]
            l = device_chunk
            # warm the hub-restart paths at this chunk's block boundaries so
            # the overlap-sync guesses stay on the interned subgraph, then
            # retry the chunk once before paying for the exact recovery
            b_len = l // nb
            ld.warm_restarts(stream, range(p + b_len - 64, p + l, b_len), depth=64)
            cache.ensure(ld)
            r = counts_pass(classes, sid, nb)
            if r.converged and not bool(r.unknown_hit):
                counts += ld.accept_counts(r.visits_acc.cpu().numpy())
                sid = int(r.final_state)
                p += l
                continue
        else:
            classes = cache.classes(stream[p : p + l])

        # recovery / tail: the exact prefix from the states pass
        r2 = dfa_scan_take(cache.table, classes, num_blocks=nb, start=sid,
                           max_iters=max_iters, sync_state=ld.start)
        if not r2.converged:
            # adversarial workload: the host walk is exact
            counts, sid, consumed = ld.host_scan(stream[p : p + l], sid, counts)
            p += consumed
            continue
        states = r2.states.cpu().numpy()
        unk = states == cache.unknown
        final = int(r2.final_state)
        if not unk.any() and final != cache.unknown:  # defensive: clean
            counts += ld.accept_counts(np.bincount(states, minlength=cache.pad + 1))
            sid = final
            p += l
            continue
        # first unknown; q >= 1 (the entry state is known). A final
        # transition onto unknown shows only in `final`: treat it as unknown
        # at position len(states)
        q = int(unk.argmax()) if unk.any() else len(states)
        keep = max(q - 1, 0)
        if keep:
            counts += ld.accept_counts(
                np.bincount(states[:keep], minlength=cache.pad + 1))
            sid = int(states[keep])  # state before byte `keep`
        p += keep
        # expand along the true path for guaranteed progress
        counts, sid, consumed = ld.host_scan(stream[p:], sid, counts,
                                             max_bytes=host_step)
        p += consumed

    return LazyScanState(counts=counts, state_id=sid, offset=base + n)
