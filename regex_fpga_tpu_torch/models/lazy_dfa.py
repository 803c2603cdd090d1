"""Lazy (on-demand) subset determinization of CSR NFAs.

The shipped rulesets do not determinize globally (>300k subset states,
SURVEY.md SS0), but real workloads touch a tiny corner of the subset space
(measured: 729 states for l-7_filter, 18,655 for snort_16 across the full
conformance traces).  This module builds the subset automaton *lazily* —
the grep/RE2 "lazy DFA" idea, recast for a device/host split:

  - the dense (C, cap) transition table grows INCREMENTALLY as states are
    interned/expanded; snapshots for the device are a single vectorized
    copy with frontier rows mapped to an absorbing UNKNOWN sentinel;
  - host walking uses the native C++ ``lazy_walk`` (one table load per
    byte, ~10^8 B/s) between expansions, on the portable build of
    ``regex_fpga_tpu_torch.native`` (a missing ``g++`` raises; there is no
    Python walk);
  - counts stay per-NFA-state: each subset state knows its accepting
    members, and a visit counts each member once — exactly the reference
    testbench semantics (SURVEY.md SS3.3; accepting members contribute no
    successors by construction).
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..native import library
from .csr import CsrAutomaton, byte_classes

__all__ = ["LazyDfa"]


class LazyDfa:
    def __init__(self, aut: CsrAutomaton, initial_capacity: int = 1 << 12):
        self.aut = aut
        cls, c = byte_classes(aut)
        self.class_of = cls
        self._class_u8 = np.ascontiguousarray(cls, dtype=np.uint8)
        self.num_classes = c
        # per-NFA-state edge keys (class * N + target), sorted+unique, so
        # expansion is pure vectorized numpy
        n = aut.num_states
        ecls = cls[aut.trans_char.astype(np.int64)].astype(np.int64)
        ekey = ecls * n + aut.trans_target.astype(np.int64)
        self._edge_key: list[np.ndarray] = [
            np.unique(ekey[int(aut.offsets[s]) : int(aut.offsets[s + 1])])
            for s in range(n)
        ]
        self._accept_mask = aut.accept_mask

        self._cap = initial_capacity
        # STATE-MAJOR (cap, C): a state's whole class row sits in 1-2 cache
        # lines, so the native walk's hot hub states stay cache-resident
        self._table = np.full((self._cap, c), -1, dtype=np.int32)
        self._expanded = np.zeros(self._cap, dtype=np.uint8)
        #: accepting[sid] = 1 iff the subset contains an accepting NFA
        #: state — the native walks gate their per-visit counts on it
        #: (only accepting visits are ever consumed, accept_counts)
        self._accepting = np.zeros(self._cap, dtype=np.uint8)
        self._ids: dict[tuple, int] = {}
        self._sets: list[tuple] = []
        self._members_acc: list[tuple[int, ...]] = []
        #: bumped on every intern AND every expansion — device-snapshot
        #: caches must key on this (an expansion can change rows without
        #: changing num_states)
        self.version = 0
        self.start = self._intern((0,))
        self._native = library()

    # -- interning / expansion ------------------------------------------

    @property
    def num_states(self) -> int:
        return len(self._sets)

    def _grow(self, need: int) -> None:
        while self._cap < need:
            self._cap *= 2
        t = np.full((self._cap, self.num_classes), -1, dtype=np.int32)
        t[: self._table.shape[0]] = self._table
        self._table = t
        e = np.zeros(self._cap, dtype=np.uint8)
        e[: len(self._expanded)] = self._expanded
        self._expanded = e
        a = np.zeros(self._cap, dtype=np.uint8)
        a[: len(self._accepting)] = self._accepting
        self._accepting = a

    def _intern(self, key: tuple) -> int:
        """key: sorted tuple of NFA state ids."""
        sid = self._ids.get(key)
        if sid is None:
            sid = len(self._sets)
            if sid >= self._cap:
                self._grow(sid + 1)
            self._ids[key] = sid
            self._sets.append(key)
            self._members_acc.append(
                tuple(s for s in key if self._accept_mask[s])
            )
            self._accepting[sid] = 1 if self._members_acc[-1] else 0
            self.version += 1
        return sid

    def is_expanded(self, sid: int) -> bool:
        return bool(self._expanded[sid])

    def expand(self, sid: int) -> None:
        if self._expanded[sid]:
            return
        n = self.aut.num_states
        cur = self._sets[sid]
        if cur:
            keys = np.unique(np.concatenate([self._edge_key[s] for s in cur]))
        else:
            keys = np.empty(0, dtype=np.int64)
        bounds = np.searchsorted(keys, np.arange(self.num_classes + 1) * n)
        targets = (keys % n).astype(np.int64)
        row = np.empty(self.num_classes, dtype=np.int32)
        memo: dict[tuple, int] = {}
        for c_ in range(self.num_classes):
            key = tuple(targets[bounds[c_] : bounds[c_ + 1]].tolist())
            tid = memo.get(key)
            if tid is None:
                tid = memo[key] = self._intern(key)
            row[c_] = tid
        self._table[sid, :] = row
        self._expanded[sid] = 1
        self.version += 1

    def frontier(self) -> list[int]:
        return [i for i in range(self.num_states) if not self._expanded[i]]

    # -- host scanning ---------------------------------------------------

    def host_scan(
        self,
        stream: np.ndarray,
        start_id: int | None = None,
        counts: np.ndarray | None = None,
        max_bytes: int | None = None,
    ) -> tuple[np.ndarray, int, int]:
        """Scan (a prefix of) a byte stream host-side, expanding on demand.

        Returns (per-NFA-state counts, final subset-state id, bytes consumed).
        """
        sid = self.start if start_id is None else start_id
        if counts is None:
            counts = np.zeros(self.aut.num_states, dtype=np.int64)
        data = np.ascontiguousarray(np.asarray(stream, dtype=np.uint8))
        n = len(data) if max_bytes is None else min(len(data), max_bytes)
        visits = np.zeros(self._cap, dtype=np.int64)
        p = 0
        i32 = ctypes.c_int32
        u8p = ctypes.POINTER(ctypes.c_uint8)
        while p < n:
            if not self._expanded[sid]:
                self.expand(sid)
            if len(visits) < self._cap:
                visits = np.concatenate(
                    [visits, np.zeros(self._cap - len(visits), np.int64)]
                )
            sid_io = i32(sid)
            consumed = self._native.lazy_walk(
                self._table.ctypes.data_as(ctypes.POINTER(i32)),
                self.num_classes,
                self._expanded.ctypes.data_as(u8p),
                self._class_u8.ctypes.data_as(u8p),
                self._accepting.ctypes.data_as(u8p),
                data[p:].ctypes.data_as(u8p),
                n - p,
                ctypes.byref(sid_io),
                visits.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            )
            sid = int(sid_io.value)
            p += consumed
        counts += self.accept_counts(visits)
        return counts, sid, n

    def host_scan_batch(
        self,
        streams,
        start_ids=None,
        threads: int = 2,
    ):
        """Scan N independent byte streams concurrently — the reference's
        dual-stream axis (``Design/FPGA.v:54-57``) generalized to arbitrary
        batch, and the RELIABLE parallel axis for IDS rulesets whose
        subset automata carry unbounded history (``.*A.*B`` content chains
        never hub-synchronize, so chunk speculation inside one stream
        falls back; independent flows need no speculation at all).

        Each stream is one walk cursor; the multi-cursor kernel overlaps
        their dependent table loads (measured ~6x one cursor on this host)
        and per-cursor visit rows keep the histograms exact per stream.

        Returns (counts (N, num_nfa_states) int64, finals (N,) int32).
        """
        streams = [
            np.ascontiguousarray(np.asarray(s, dtype=np.uint8))
            for s in streams
        ]
        n_streams = len(streams)
        if n_streams == 0:
            return np.zeros((0, self.aut.num_states), np.int64), np.zeros(
                0, np.int32
            )
        starts = (
            np.full(n_streams, self.start, np.int32)
            if start_ids is None
            else np.asarray(start_ids, np.int32).copy()
        )
        if n_streams == 1:
            counts = np.zeros((n_streams, self.aut.num_states), np.int64)
            finals = np.zeros(n_streams, np.int32)
            for i, s in enumerate(streams):
                _, finals[i], _ = self.host_scan(s, int(starts[i]), counts[i])
            return counts, finals

        import threading as _threading

        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        data = np.concatenate(streams)
        lut_ptr = self._class_u8.ctypes.data_as(u8p)
        data_ptr = data.ctypes.data_as(u8p)
        bounds = np.concatenate(
            [[0], np.cumsum([len(s) for s in streams])]
        ).astype(np.int64)
        pos = bounds[:-1].copy()
        end = bounds[1:].copy()
        sids = starts.astype(np.int32)
        # one visits row per stream; thread groups touch disjoint rows.
        # the native walker caps W at 512 per call (and silently truncates),
        # so group size must stay below that or truncated cursors would
        # never advance and the expansion loop below would spin forever
        visits = np.zeros((n_streams, self._cap), np.int64)
        n_groups = max(max(1, threads), -(-n_streams // 512))
        groups = np.array_split(np.arange(n_streams), n_groups)
        groups = [g for g in groups if len(g)]

        while True:
            def run(g):
                self._native.lazy_walk_multi(
                    self._table.ctypes.data_as(i32p),
                    self.num_classes,
                    self._expanded.ctypes.data_as(u8p),
                    lut_ptr,
                    self._accepting.ctypes.data_as(u8p),
                    data_ptr,
                    pos[g[0]:].ctypes.data_as(i64p),
                    end[g[0]:].ctypes.data_as(i64p),
                    sids[g[0]:].ctypes.data_as(i32p),
                    len(g),
                    visits[g[0]:].ctypes.data_as(i64p),
                    1,
                    visits.shape[1],
                )

            ts = [
                _threading.Thread(target=run, args=(g,)) for g in groups
            ]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            blocked = np.nonzero(pos < end)[0]
            if len(blocked) == 0:
                break
            for c in blocked:
                self.expand(int(sids[c]))
            if visits.shape[1] < self._cap:
                grown = np.zeros((n_streams, self._cap), np.int64)
                grown[:, : visits.shape[1]] = visits
                visits = grown

        counts = np.stack([self.accept_counts(v) for v in visits])
        return counts, sids

    def warm_restarts(self, stream: np.ndarray, positions, depth: int) -> None:
        """Intern the hub-restart paths used by overlap synchronization.

        Speculative block entries are guessed by scanning a short window from
        the hub state (ops/dfa_take.py ``_sync_entries``); those hub-rooted
        paths traverse shallow subset states the true chain never visits —
        intern them so speculation stays on the known subgraph.  Window
        ENDPOINTS coincide with true-chain states (synchronization), so only
        the shallow prefix states are new and they are shared across windows
        of similar content.
        """
        scratch = np.zeros(self.aut.num_states, dtype=np.int64)
        n = len(stream)
        for pos in positions:
            if 0 <= pos < n:
                self.host_scan(
                    stream[pos : pos + depth], self.start, scratch, depth
                )

    # -- device snapshot -------------------------------------------------

    def snapshot(self, pad_to: int | None = None) -> tuple[np.ndarray, int, np.ndarray]:
        """Dense device table.

        Returns (table (C, P+1) int32, unknown_id = P, accepting-member
        counts (P+1,)).  Frontier states' rows are all-unknown; the unknown
        row is absorbing.  ``pad_to`` rounds the state dimension up so
        device shapes stay stable as the automaton grows.
        """
        m = self.num_states
        p = m if pad_to is None else max(m, pad_to)
        unknown = p
        table = np.full((self.num_classes, p + 1), unknown, dtype=np.int32)
        known = self._expanded[:m].astype(bool)
        table[:, :m] = np.where(known[None, :], self._table[:m].T, unknown)
        n_acc = np.zeros(p + 1, dtype=np.int32)
        n_acc[:m] = [len(a) for a in self._members_acc]
        return table, unknown, n_acc

    def _acc_pairs(self) -> tuple[np.ndarray, np.ndarray]:
        """(sid, accepting-member) pairs as flat arrays, cached per version."""
        if getattr(self, "_acc_pairs_version", -1) != self.version:
            sids: list[int] = []
            mems: list[int] = []
            for sid, members in enumerate(self._members_acc):
                sids.extend([sid] * len(members))
                mems.extend(members)
            self._acc_sid = np.asarray(sids, dtype=np.int64)
            self._acc_mem = np.asarray(mems, dtype=np.int64)
            self._acc_pairs_version = self.version
        return self._acc_sid, self._acc_mem

    def accept_counts(self, visit_counts: np.ndarray) -> np.ndarray:
        """Map per-subset-state visit counts -> per-NFA-state match counts."""
        sid_arr, mem_arr = self._acc_pairs()
        keep = sid_arr < len(visit_counts)
        if not keep.all():
            sid_arr, mem_arr = sid_arr[keep], mem_arr[keep]
        if len(sid_arr) == 0:
            return np.zeros(self.aut.num_states, dtype=np.int64)
        # float64 weights are exact below 2^53 — far above any visit count
        w = visit_counts[sid_arr].astype(np.float64)
        out = np.bincount(mem_arr, weights=w, minlength=self.aut.num_states)
        return out.astype(np.int64)
