"""Public API of the torch port: DFA matchers and the NFA conformance engine.

The counterpart of the DFA and NFA halves of ``regex_fpga_tpu/api.py``::

    m = compile_regex(r"\\d+\\.\\d+", device="cuda")  # fast DFA engine
    report = m.scan(data)                               # per-state counts
    total = m.count(data)                               # k-gram engine

    tok = compile_tokenizer(device="cuda")              # GPT-2 pre-split
    offsets = tok.presplit(text)

    nfa = compile_ruleset("rules.coe", strategy="lazy-device", device="cuda")
    report = nfa.scan([flow_a, flow_b])                 # per-NFA-state counts

A matcher holds its tables on ``device`` and scans every chunk there; the
chain passes and the active-set scan run on the Hopper kernels for a CUDA
device and on their plain versions for the CPU. Results equal the JAX
package's bit for bit.

Not in this package yet: the engine router and the host DFA walker
(``scan_backend="auto"`` and ``"host"``; the router chooses between the
device and the host engines), span extraction (``finditer``/``search``/
``findall``, which needs the reverse matcher), and the host matchers that
``compile_regex`` returns for patterns with assertions, lazy quantifiers or
backreferences. Each raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import native
from .models import (
    GPT2_PRESPLIT,
    CompiledDfa,
    CsrAutomaton,
    LazyDfa,
    TokenizerDfa,
    build_tokenizer_dfa,
    compile_pattern,
    contains_backtrack,
    contains_bound,
    contains_lazy,
    load_coe,
    parse_pattern,
)
from .ops.dfa_engine import dfa_scan_blocked, dfa_scan_serial
from .ops.dfa_fast import dfa_scan_fast, dfa_scan_fast_multi, mask_positions
from .ops.kgram import (
    KGRAM_MAX_STATES,
    build_kgram,
    dfa_scan_kgram,
    kgram_maps,
    pack_ta,
)
from .ops.lazy_scan import lazy_nfa_scan
from .ops.nfa_engine import initial_active, nfa_scan_streams
from .ops.tables import (
    DfaTables,
    NfaCsr,
    NfaTables,
    build_dfa_tables,
    build_nfa_csr,
    build_nfa_tables,
    host_to_device,
    resolve_device,
    stall_extend,
)
from .utils.config import EngineConfig, shrink_blocks
from .utils.metrics import RunMetrics, Timer

__all__ = [
    "DEFAULT_CONFIG",
    "DfaMatcher",
    "DfaStreamScanner",
    "EngineConfig",
    "LazyStreamScanner",
    "NfaMatcher",
    "NfaStreamScanner",
    "ScanReport",
    "TokenizerMatcher",
    "compile_regex",
    "compile_ruleset",
    "compile_tokenizer",
]

#: The port's default engine settings: the JAX defaults, with every scan on
#: the device until the engine router is ported.
DEFAULT_CONFIG = EngineConfig(scan_backend="device")


@dataclasses.dataclass
class ScanReport:
    """Result of scanning one or more byte streams."""

    counts: np.ndarray            # (num_streams, S) per-state match counts
    total: int                    # sum of all matches
    match_positions: list | None  # per stream: byte offsets where a match fired
    metrics: RunMetrics

    def histogram(self, stream: int = 0) -> dict[int, int]:
        """Nonzero per-state counts."""
        row = self.counts[stream]
        return {int(i): int(c) for i, c in enumerate(row) if c}


def _as_streams(data) -> list[np.ndarray]:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return [np.frombuffer(data, dtype=np.uint8)]
    if isinstance(data, np.ndarray):
        if data.ndim == 1:
            return [data.astype(np.uint8, copy=False)]
        return [row.astype(np.uint8, copy=False) for row in data]
    return [s if isinstance(s, np.ndarray) else np.frombuffer(s, dtype=np.uint8)
            for s in data]


class _FallbackResult(NamedTuple):
    counts: torch.Tensor      # (S,) int64 per-state match counts
    match_mask: torch.Tensor  # (L,) bool: accept fired before byte i
    final_state: int
    iterations: int = 0


class DfaMatcher:
    """High-throughput DFA matcher: the fast chain engine with an exact
    fallback, on ``device``."""

    #: include a match whose accept state is entered by the very last byte
    #: (the reference timing drops it; a general regex API reports it)
    include_final_match: bool = True
    _stall_tables: DfaTables | None = None  # lazy stall-extended tables

    def __init__(self, dfa: CompiledDfa, config: EngineConfig = DEFAULT_CONFIG,
                 device=None):
        self.dfa = dfa
        self._setup(build_dfa_tables(dfa.table, dfa.accept), dfa.eof_accept,
                    dfa.start, config, device)

    def _setup(self, tables: DfaTables, accept_eof, start: int,
               config: EngineConfig, device) -> None:
        if config.scan_backend != "device":
            raise NotImplementedError(
                f"scan_backend={config.scan_backend!r} needs the engine "
                "router and the host walker, which the torch port does not "
                "have yet (ROADMAP.md, 'Modules to port', the router item); "
                "use 'device'"
            )
        self.config = config
        self.device = resolve_device(device)
        self.tables = tables.to(self.device)
        # byte -> class on the device: class ids always fit one byte
        # (C <= 256), so chunks upload as raw bytes and map there
        self._class_lut = self.tables.class_of.to(torch.uint8)
        # accept mask for the FINAL state: end-anchored patterns ($) carry
        # it separately from the per-position mask
        self._accept_eof = np.asarray(accept_eof)
        self.start = start

    @property
    def num_states(self) -> int:
        return self.tables.num_states

    def stream_scanner(self, resume: dict | None = None) -> "DfaStreamScanner":
        """Incremental scanning on the fast engine; the carry is (state,
        counts, offset)."""
        return DfaStreamScanner(self, resume)

    # ------------------------------------------------------------ plumbing

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A host array as a tensor on the matcher's device."""
        return host_to_device(arr, self.device)

    def _classes(self, raw: np.ndarray) -> torch.Tensor:
        """Byte-class ids (uint8) of raw bytes, mapped on the device."""
        data = self._upload(raw)
        return torch.index_select(
            self._class_lut, 0, data.reshape(-1).int()
        ).reshape(data.shape)

    def _pick_blocks(self, n: int) -> int:
        return shrink_blocks(n, self.config.num_blocks,
                             self.config.min_block_bytes)

    # ---------------------------------------------------------------- scan

    def scan(self, data, collect_positions: bool = False) -> ScanReport:
        streams = _as_streams(data)
        counts = np.zeros((len(streams), self.num_states), dtype=np.int64)
        positions: list = []
        iters = 0
        converged = True
        if (not collect_positions and len(streams) > 1
                and len({len(s_) for s_ in streams}) == 1
                and len(streams[0]) > 0):
            # equal-length batch: all streams as extra chain lanes in one pass
            with Timer() as t:
                c, iters, converged, cur = self._scan_batch_counts(
                    np.stack(streams)
                )
                counts[:] = c
                for i in range(len(streams)):
                    if self.include_final_match and self._accept_eof[cur[i]]:
                        counts[i, cur[i]] += 1
            engine = "dfa-fast-batch"
        elif (not collect_positions and len(streams) > 1
                and any(len(s_) for s_ in streams)):
            # ragged batch: streams pad at the front with the stall class
            with Timer() as t:
                c, iters, converged, cur = self._scan_ragged_counts(streams)
                counts[:] = c
                for i, stream in enumerate(streams):
                    if (self.include_final_match and len(stream)
                            and self._accept_eof[cur[i]]):
                        counts[i, cur[i]] += 1
            engine = "dfa-fast-batch-ragged"
        else:
            with Timer() as t:
                for i, stream in enumerate(streams):
                    pos = None
                    if not collect_positions:
                        # counts-only: the histogram is computed on the
                        # device, no per-position array leaves it
                        c, it, conv = self._scan_stream_counts(stream)
                        counts[i] = c
                    else:
                        c, mask, it, conv = self._scan_stream(stream)
                        counts[i] = c.cpu().numpy()
                        pos = torch.nonzero(mask).reshape(-1).cpu().numpy()
                    iters = max(iters, it)
                    converged &= conv
                    if (self.include_final_match and len(stream)
                            and self._accept_eof[self._last_final]):
                        counts[i, self._last_final] += 1
                        if collect_positions:
                            pos = np.concatenate([pos, [len(stream)]])
                    positions.append(pos)
            engine = "dfa-fast"
        m = RunMetrics(
            engine=engine,
            bytes_scanned=sum(len(s_) for s_ in streams),
            streams=len(streams),
            matches=int(counts.sum()),
            wall_seconds=t.seconds,
            iterations=iters,
            converged=converged,
        )
        return ScanReport(
            counts=counts, total=int(counts.sum()),
            match_positions=positions if collect_positions else None,
            metrics=m,
        )

    def _kgram(self):
        """Cached (k-gram tables, their packed T_k and A_k, their packed
        byte and pair maps), the last two on the device, or None when the
        k=1 counts engine is the choice (more than ``KGRAM_MAX_STATES``
        states, or a composed-class blowup)."""
        if not hasattr(self, "_kgram_cache"):
            kg = None
            if self.tables.num_states <= KGRAM_MAX_STATES:
                kg = build_kgram(self.tables, levels=2)
            self._kgram_cache = None if kg is None else (
                kg,
                pack_ta(torch.as_tensor(kg.table), torch.as_tensor(kg.acc_table))
                .to(self.device),
                kgram_maps(kg).to(self.device),
            )
        return self._kgram_cache

    def count(self, data) -> int:
        """Total match count (``grep -c``); always equals
        ``scan(data).total``.

        Uses the k-gram engine (4 bytes per step, exact totals) when the
        composed class count stays small, with any tail shorter than one
        step finished by the serial scan from the k-gram carry state."""
        streams = _as_streams(data)
        total = 0
        for stream in streams:
            if len(stream) == 0:
                continue
            kgc = self._kgram()
            if kgc is None:
                total += int(self.scan([stream]).counts.sum())
                continue
            kg, ta, maps = kgc
            cb = self.config.chunk_bytes
            cur = self.start
            stream_total = 0
            diverged = False
            for off in range(0, len(stream), cb):
                chunk = stream[off : off + cb]
                steps = len(chunk) // kg.k
                nb = self._pick_blocks(max(steps, 1))
                main_len = (steps // nb) * nb * kg.k
                if main_len:
                    # the raw text goes to the k-gram kernel, which maps
                    # it to classes itself
                    res = dfa_scan_kgram(
                        ta, self._upload(chunk[:main_len]), num_blocks=nb,
                        start=cur, max_iters=self.config.max_iters, maps=maps,
                    )
                    if not res.converged:
                        diverged = True
                        break
                    stream_total += int(res.total)
                    cur = int(res.final_state)
                tail = chunk[main_len:]
                if len(tail):
                    ser = dfa_scan_serial(self.tables, tail, start=cur)
                    stream_total += int(ser.counts.sum())
                    cur = int(ser.final_state)
            if diverged:  # non-synchronizing automaton: exact fallback over
                # the whole stream (partial totals discarded)
                total += int(self.scan([stream]).counts.sum())
                continue
            if self.include_final_match and bool(self._accept_eof[cur]):
                stream_total += 1
            total += stream_total
        return total

    # ------------------------------------------------------ chunked engines

    def _scan_stream(self, stream: np.ndarray):
        """Returns (counts (S,) int64, match_mask (L,) bool, iterations,
        converged), both tensors on the device: the per-state counts and the
        accept bit before each byte. The state after the stream is left in
        ``self._last_final``."""
        counts = torch.zeros(self.num_states, dtype=torch.int64,
                             device=self.device)
        mask = torch.empty(len(stream), dtype=torch.bool, device=self.device)
        iters, converged = 0, True
        cb = self.config.chunk_bytes
        cur = self.start
        for off in range(0, len(stream), cb):
            raw = stream[off : off + cb]
            res = dfa_scan_fast(
                self.tables, self._classes(raw),
                num_blocks=self._pick_blocks(len(raw)), start=cur,
                max_iters=self.config.max_iters,
            )
            if not bool(res.domain_ok):
                raise RuntimeError(
                    "device DFA pass produced out-of-domain state ids: "
                    "corrupt table"
                )
            if not res.converged:
                converged = False
                res = self._exact_fallback(raw, cur)
                counts += res.counts
            else:
                counts += torch.bincount(res.states[res.match_mask].long(),
                                         minlength=self.num_states)
            mask[off : off + len(raw)] = res.match_mask
            cur = int(res.final_state)
            iters = max(iters, res.iterations)
        self._last_final = cur
        return counts, mask, iters, converged

    def _mask_chunk_device(self, raw_chunk: np.ndarray, cur: int):
        """One chunk's (match mask, final state) via the k=1 mask scan, or
        via the exact path when the scan does not converge; the mask stays
        on the device."""
        res = dfa_scan_fast(
            self.tables, self._classes(raw_chunk),
            num_blocks=self._pick_blocks(len(raw_chunk)), start=cur,
            max_iters=self.config.max_iters, emit="mask",
        )
        if not bool(res.domain_ok):
            raise RuntimeError(
                "device DFA pass produced out-of-domain state ids: corrupt table"
            )
        if not res.converged:
            res = self._exact_fallback(raw_chunk, cur)
        return res.match_mask, int(res.final_state)

    def _scan_match_positions(self, stream: np.ndarray) -> np.ndarray:
        """Byte offsets where the accept mask is set, compacted on the
        device (``mask_positions``): each chunk downloads a count and the
        positions instead of the whole mask; chunks denser than cap/chunk
        take ``nonzero`` of the mask instead. Sets ``self._last_final``.
        Returns ascending int64 offsets."""
        out = [np.empty(0, np.int64)]
        cur = self.start
        cb = self.config.chunk_bytes
        for off in range(0, len(stream), cb):
            chunk = stream[off : off + cb]
            mask, cur_next = self._mask_chunk_device(chunk, cur)
            cap = max(1024, len(chunk) // 4)
            pos_dev, count_dev = mask_positions(mask, cap)
            count = int(count_dev)
            if count > cap:  # dense chunk: compact the mask itself
                pos = torch.nonzero(mask).reshape(-1).cpu().numpy()
            else:
                pos = pos_dev[:count].cpu().numpy()
            out.append(pos.astype(np.int64) + off)
            cur = cur_next
        self._last_final = cur
        return np.concatenate(out)

    def _scan_batch_counts(self, arr: np.ndarray):
        """Chunked batch scan of (N, L) equal-length streams via
        ``dfa_scan_fast_multi`` (per-stream histograms on the device).
        Returns (counts (N, S), iterations, converged, final states (N,))."""
        n, l = arr.shape
        classes = self._classes(arr)
        counts = np.zeros((n, self.num_states), dtype=np.int64)
        cur = np.full(n, self.start, dtype=np.int32)
        iters, converged = 0, True
        cb = self.config.chunk_bytes
        for off in range(0, l, cb):
            chunk = classes[:, off : off + cb]
            res = dfa_scan_fast_multi(
                self.tables, chunk, num_blocks=self._pick_blocks(chunk.shape[1]),
                starts=torch.as_tensor(cur, device=self.device),
                max_iters=self.config.max_iters, emit="counts",
            )
            if not res.converged:
                converged = False
                # exact per-stream fallback for this chunk only
                for i in range(n):
                    r = self._exact_fallback(arr[i, off : off + cb], int(cur[i]))
                    counts[i] += r.counts.cpu().numpy()
                    cur[i] = r.final_state
            else:
                counts += res.counts.cpu().numpy()
                cur = res.final_states.cpu().numpy().astype(np.int32)
            iters = max(iters, res.iterations)
        return counts, iters, converged, cur

    def _scan_ragged_counts(self, streams):
        """Variable-length batch in one multi-lane chain: streams pad AT THE
        FRONT to a common length with the STALL class (identity table row,
        ``stall_extend``) and run through ``dfa_scan_fast_multi`` with
        per-lane pinned entries, as the equal-length path does.

        Front padding keeps the seam speculation right: during the pad
        steps a lane sits in its stream's entry state, which is what the
        replay from the start predicts. The overcount is exactly
        ``pad_steps`` visits of the entry state, subtracted afterwards.
        Returns (counts (N, S) int64, iters, converged, finals (N,))."""
        if self._stall_tables is None:
            self._stall_tables = stall_extend(self.tables)
        stall_id = self.tables.num_classes
        # the stall id is C, which needs more than a byte when C = 256
        dtype = torch.uint8 if stall_id < 256 else torch.int32
        n = len(streams)
        lens = np.array([len(s_) for s_ in streams], dtype=np.int64)
        lmax = int(lens.max())
        counts = np.zeros((n, self.num_states), dtype=np.int64)
        cur = np.full(n, self.start, dtype=np.int32)
        iters, converged = 0, True
        accept_np = self.tables.accept.cpu().numpy()
        off = 0
        cb = self.config.chunk_bytes
        while off < lmax:
            w = min(cb, lmax - off)
            nb = shrink_blocks(w, self.config.num_blocks,
                               self.config.min_block_bytes, divisible=False)
            w_pad = -(-w // nb) * nb  # round up to a block multiple
            chunk = torch.full((n, w_pad), stall_id, dtype=dtype,
                               device=self.device)
            real = np.clip(lens - off, 0, w_pad).astype(np.int64)
            entries = cur.copy()  # pre-chunk states (stall correction)
            for i, s_ in enumerate(streams):
                if real[i]:
                    # the stream slice sits at the chunk's end; the leading
                    # stalls carry the entry state
                    chunk[i, w_pad - real[i]:] = self._classes(
                        s_[off : off + real[i]]
                    )
            res = dfa_scan_fast_multi(
                self._stall_tables, chunk, num_blocks=nb,
                starts=torch.as_tensor(cur, device=self.device),
                max_iters=self.config.max_iters, emit="counts",
            )
            if not res.converged:
                converged = False
                for i, s_ in enumerate(streams):
                    if real[i] == 0:
                        continue
                    r = self._exact_fallback(s_[off : off + real[i]], int(cur[i]))
                    counts[i] += r.counts.cpu().numpy()
                    cur[i] = r.final_state
            else:
                c = res.counts.cpu().numpy().astype(np.int64)
                # exact stall correction: the entry state was counted once
                # per leading padded step
                c[np.arange(n), entries] -= (w_pad - real) * accept_np[entries]
                counts += c
                cur = res.final_states.cpu().numpy().astype(np.int32)
            iters = max(iters, res.iterations)
            off += w_pad
        return counts, iters, converged, cur

    def _scan_stream_counts(self, stream: np.ndarray, start=None):
        """Counts-only chunked scan (the histogram stays on the device).
        Returns (counts (S,), iterations, converged) and sets
        ``self._last_final``."""
        start = self.start if start is None else start
        counts = np.zeros(self.num_states, dtype=np.int64)
        iters, converged = 0, True
        cur = start
        cb = self.config.chunk_bytes
        for off in range(0, len(stream), cb):
            raw = stream[off : off + cb]
            res = dfa_scan_fast(
                self.tables, self._classes(raw),
                num_blocks=self._pick_blocks(len(raw)), start=cur,
                max_iters=self.config.max_iters, emit="counts",
            )
            if not res.converged:
                converged = False
                res = self._exact_fallback(raw, cur)
            counts += res.counts.cpu().numpy()
            cur = int(res.final_state)
            iters = max(iters, res.iterations)
        self._last_final = cur
        return counts, iters, converged

    def _exact_fallback(self, chunk_bytes: np.ndarray, start) -> _FallbackResult:
        """Exact path for automata the fast engine does not settle, on the
        matcher's device: the blocked composition scan over the chunk's
        whole 1024-byte blocks, then the serial scan over the tail of fewer
        than 1024 bytes."""
        block = 1024
        main = len(chunk_bytes) - len(chunk_bytes) % block
        counts = torch.zeros(self.num_states, dtype=torch.int64,
                             device=self.device)
        masks = [torch.zeros(0, dtype=torch.bool, device=self.device)]
        cur = int(start)
        if main:
            res = dfa_scan_blocked(self.tables, self._upload(chunk_bytes[:main]),
                                   block_size=block, start=cur)
            counts += res.counts
            masks.append(res.match_mask)
            cur = int(res.final_state)
        if main < len(chunk_bytes):
            res = dfa_scan_serial(self.tables, chunk_bytes[main:], start=cur)
            counts += res.counts
            masks.append(res.match_mask)
            cur = int(res.final_state)
        return _FallbackResult(counts=counts, match_mask=torch.cat(masks),
                               final_state=cur)


class DfaStreamScanner:
    """Incremental scanning on the fast DFA engines with a serializable
    O(S) carry: (current state, per-state counts, byte offset).

    Chunked feeding is exact because match timing is accept-before-byte:
    resuming from the carried state reproduces the one-shot scan at any
    chunk alignment. The end-of-stream accept (``include_final_match``) is
    applied by ``total``/``histogram`` without mutating the carry."""

    def __init__(self, matcher: DfaMatcher, resume: dict | None = None):
        self.m = matcher
        if resume is None:
            self.state = matcher.start
            self.counts = np.zeros(matcher.num_states, dtype=np.int64)
            self.offset = 0
        else:
            self.state = int(resume["state"])
            self.counts = np.array(resume["counts"], dtype=np.int64)
            self.offset = int(resume["offset"])

    def feed(self, data) -> None:
        stream = _as_streams(data)[0]
        if len(stream) == 0:
            return
        c, _, _ = self.m._scan_stream_counts(stream, start=self.state)
        self.counts += c
        self.state = self.m._last_final
        self.offset += len(stream)

    def checkpoint(self) -> dict:
        return {
            "state": self.state,
            "counts": np.array(self.counts),
            "offset": self.offset,
        }

    @property
    def state_counts(self) -> np.ndarray:
        """Per-state counts with the end-of-stream accept applied (as if the
        stream ended here)."""
        out = self.counts.copy()
        if (self.m.include_final_match and self.offset
                and self.m._accept_eof[self.state]):
            out[self.state] += 1
        return out

    @property
    def total(self) -> int:
        return int(self.state_counts.sum())

    def histogram(self) -> dict[int, int]:
        return {int(i): int(c) for i, c in enumerate(self.state_counts) if c}


class TokenizerMatcher(DfaMatcher):
    """Regex pre-split stage for tokenization pipelines."""

    def __init__(self, tok: TokenizerDfa, config: EngineConfig = DEFAULT_CONFIG,
                 device=None):
        self.tok = tok
        self.dfa = None
        tables = build_dfa_tables(tok.table, tok.accept)
        self._setup(tables, tables.accept.numpy(), tok.start, config, device)

    def presplit(self, text: bytes | np.ndarray) -> np.ndarray:
        """Token-start byte offsets for ``text`` (maximal munch; the
        semantics are those of
        ``regex_fpga_tpu.models.tokenizer_dfa.boundaries_from_flags``)."""
        stream = _as_streams(text)[0]
        n = len(stream)
        if n == 0:
            return np.zeros(0, dtype=np.int64)
        # an accept bit at byte i marks a token start at byte i - 1, byte 0
        # always starts one, and an accepting final state marks byte n - 1.
        # The compacted positions are ascending and distinct, so the offsets
        # follow without rebuilding the mask or sorting (boundaries_from_flags
        # does both, in Python lists: seconds at 16 MiB).
        pos = self._scan_match_positions(stream)
        starts = pos[np.searchsorted(pos, 1):] - 1
        head = np.zeros(0 if len(starts) and starts[0] == 0 else 1, np.int64)
        final = bool(self._accept_eof[self._last_final]) and n > 1
        tail = np.full(1 if final else 0, n - 1, np.int64)
        return np.concatenate([head, starts, tail])

    def pieces(self, text: bytes) -> list[bytes]:
        starts = self.presplit(text).tolist()
        return [text[a:b] for a, b in zip(starts, starts[1:] + [len(text)])]


def compile_regex(pattern: str | bytes, anchored: bool = False,
                  max_states: int = 100_000,
                  config: EngineConfig = DEFAULT_CONFIG,
                  device=None) -> DfaMatcher:
    """Compile a pattern to the fast DFA engine. Default is scanning
    (unanchored) mode: a match is reported wherever it ends in the stream.

    Patterns that the JAX package hands to its host matchers (``\\b``/
    ``\\B``, ``(?m)`` anchors, lazy quantifiers, backreferences, lookaround,
    conditionals) raise ``NotImplementedError``: those matchers are not
    ported yet."""
    node = parse_pattern(pattern).node
    if (contains_backtrack(node) or contains_bound(node)
            or contains_lazy(node)):
        raise NotImplementedError(
            "this pattern needs a host regex matcher, which the torch port "
            "does not have yet (ROADMAP.md, 'Modules to port', the matcher "
            "surface)"
        )
    dfa = compile_pattern(pattern, max_states=max_states, anchored=anchored)
    return DfaMatcher(dfa, config, device)


def compile_tokenizer(pattern: str = GPT2_PRESPLIT,
                      config: EngineConfig = DEFAULT_CONFIG,
                      device=None) -> TokenizerMatcher:
    return TokenizerMatcher(build_tokenizer_dfa(pattern), config, device)


# ------------------------------------------------------------------ NFA


NFA_STRATEGIES = ("lazy", "lazy-device", "active-set")


class NfaMatcher:
    """Bit-exact NFA matcher for CSR rulesets (the conformance engine).

    Strategies:
      - ``"lazy"`` (default): lazy subset determinization on the host, with
        the native walker built from source (``native``); several streams
        are walked together by its multi-cursor walk;
      - ``"lazy-device"``: the same automaton, chunks scanned on ``device``
        on K1/K2 with overlap-synchronized seams (``ops/lazy_scan.py``);
      - ``"active-set"``: the bounded active-set engine on ``device`` (K4,
        ``ops/nfa_engine.py``); all streams go through one launch per
        ``chunk_bytes`` of each, and exceeding ``config.active_bound``
        raises.

    The tables are built when first read: the lazy DFA for the lazy
    strategies, the per-class CSR for the active-set engine, and the dense
    (C, S+1, K) table only for ``collect_positions``, whose native walk
    reads it (for a large NFA it is many gigabytes).
    """

    def __init__(self, aut: CsrAutomaton, config: EngineConfig = DEFAULT_CONFIG,
                 strategy: str = "lazy", device=None):
        if strategy not in NFA_STRATEGIES:
            raise ValueError(f"strategy must be one of {NFA_STRATEGIES}, "
                             f"got {strategy!r}")
        self.automaton = aut
        self.config = config
        self.strategy = strategy
        self.device = resolve_device(device)
        self._lazy = None
        self._csr: NfaCsr | None = None
        self._tables: NfaTables | None = None

    @property
    def lazy_dfa(self):
        if self._lazy is None:
            self._lazy = LazyDfa(self.automaton)
        return self._lazy

    @property
    def csr(self) -> NfaCsr:
        """K4's successor lists, on the matcher's device."""
        if self._csr is None:
            self._csr = build_nfa_csr(self.automaton, self.device)
        return self._csr

    @property
    def tables(self) -> NfaTables:
        """The dense successor table, on the host (the native walk reads it)."""
        if self._tables is None:
            self._tables = build_nfa_tables(self.automaton)
        return self._tables

    @property
    def num_states(self) -> int:
        return self.automaton.num_states

    def scan(self, data, collect_positions: bool = False) -> ScanReport:
        streams = _as_streams(data)
        counts = np.zeros((len(streams), self.num_states), dtype=np.int64)
        with Timer() as t:
            if self.strategy == "lazy" and len(streams) > 1:
                # all streams walked concurrently, exact per stream
                counts[:], _ = self.lazy_dfa.host_scan_batch(streams)
            elif self.strategy == "lazy":
                for i, stream in enumerate(streams):
                    counts[i], _, _ = self.lazy_dfa.host_scan(stream)
            elif self.strategy == "lazy-device":
                for i, stream in enumerate(streams):
                    counts[i] = lazy_nfa_scan(self.lazy_dfa, stream,
                                              device=self.device).counts
            elif streams:
                c, _ = self._scan_active(streams)
                counts[:] = c[:, : self.num_states].cpu().numpy()
        positions = ([self._positions(st) for st in streams]
                     if collect_positions else None)
        m = RunMetrics(
            engine=f"nfa-{self.strategy}",
            bytes_scanned=sum(len(s_) for s_ in streams),
            streams=len(streams),
            matches=int(counts.sum()),
            wall_seconds=t.seconds,
        )
        return ScanReport(counts=counts, total=int(counts.sum()),
                          match_positions=positions, metrics=m)

    def _scan_active(self, streams, active=None, counts=None):
        """All streams through K4, ``chunk_bytes`` of each per launch, the
        carry (lists, counts) kept on the device. ``active`` (N, A) and
        ``counts`` (N, S+1) resume from a carry. Returns (counts (N, S+1)
        int32, final lists (N, A) int32); raises when any chunk overflowed
        the active bound."""
        csr, dev = self.csr, self.device
        n, bound = len(streams), self.config.active_bound
        if active is None:
            active = initial_active(csr.num_states, bound, n, dev)
        if counts is None:
            counts = torch.zeros((n, csr.num_states + 1), dtype=torch.int32,
                                 device=dev)
        lens = np.array([len(s_) for s_ in streams], dtype=np.int64)
        cb = self.config.chunk_bytes
        overflowed = torch.zeros(n, dtype=torch.bool, device=dev)
        for off in range(0, max(int(lens.max()), 1), cb):
            parts = [s_[off : off + cb] for s_ in streams]
            sizes = np.array([len(p_) for p_ in parts], dtype=np.int64)
            flat = np.concatenate(parts) if sizes.sum() else np.zeros(0, np.uint8)
            starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
            res = nfa_scan_streams(csr, host_to_device(flat, dev), starts,
                                   sizes, bound, active, counts)
            counts, active = res.counts, res.final_active
            overflowed |= res.overflowed
        if bool(overflowed.any()):
            raise RuntimeError("active-set bound exceeded; raise "
                               "EngineConfig.active_bound")
        return counts, active

    def _positions(self, stream: np.ndarray) -> np.ndarray:
        """Match byte offsets via the native active-set walk."""
        t = self.tables
        return native.nfa_match_positions(
            t.delta.numpy(), t.class_of.numpy(), t.accept.numpy(),
            np.ascontiguousarray(stream, dtype=np.uint8),
            active_cap=self.config.active_bound,
        )

    def stream_scanner(self, resume: dict | None = None):
        """``"lazy"`` carries (counts, subset members, offset); the other
        strategies carry the active-set engine's (list, counts, offset)."""
        if self.strategy == "lazy":
            return LazyStreamScanner(self, resume)
        return NfaStreamScanner(self, resume)


class NfaStreamScanner:
    """Incremental scanning on the active-set engine with an O(S) carry:
    the active list (A,) int32, the counts (S+1,) int32 and the offset. The
    checkpoint has the JAX package's keys and dtypes, so either package
    resumes the other's."""

    def __init__(self, matcher: NfaMatcher, resume: dict | None = None):
        self.m = matcher
        resume = resume or {}
        # a checkpoint taken before the first feed() has no carry arrays
        active, counts = resume.get("active"), resume.get("counts")
        dev = matcher.device
        self.active = (None if active is None else
                       torch.tensor(np.asarray(active, np.int32), device=dev))
        self.counts = (None if counts is None else
                       torch.tensor(np.asarray(counts, np.int32), device=dev))
        self.offset = int(resume.get("offset", 0))

    def feed(self, data) -> None:
        stream = _as_streams(data)[0]
        counts, active = self.m._scan_active(
            [stream],
            None if self.active is None else self.active.reshape(1, -1),
            None if self.counts is None else self.counts.reshape(1, -1),
        )
        self.active, self.counts = active[0], counts[0]
        self.offset += len(stream)

    def checkpoint(self) -> dict:
        return {
            "active": None if self.active is None else self.active.cpu().numpy(),
            "counts": None if self.counts is None else self.counts.cpu().numpy(),
            "offset": self.offset,
        }

    @property
    def state_counts(self) -> np.ndarray:
        if self.counts is None:
            return np.zeros(self.m.num_states, dtype=np.int64)
        return self.counts[: self.m.num_states].cpu().numpy().astype(np.int64)


class LazyStreamScanner:
    """Incremental scanning on the lazy subset DFA; the carry is the
    per-NFA-state counts, the subset's NFA members and the offset. Members,
    not the interning-order subset id, make a checkpoint portable across
    processes and packages."""

    def __init__(self, matcher: NfaMatcher, resume: dict | None = None):
        self.m = matcher
        if resume is None:
            self.counts = np.zeros(matcher.num_states, dtype=np.int64)
            self.state_id = matcher.lazy_dfa.start
            self.offset = 0
        else:
            self.counts = np.array(resume["counts"], dtype=np.int64)
            members = tuple(int(x) for x in np.asarray(resume["state_set"]))
            self.state_id = matcher.lazy_dfa._intern(members)
            self.offset = int(resume["offset"])

    def feed(self, data) -> None:
        stream = _as_streams(data)[0]
        self.counts, self.state_id, n = self.m.lazy_dfa.host_scan(
            stream, self.state_id, self.counts)
        self.offset += n

    def checkpoint(self) -> dict:
        return {
            "counts": np.array(self.counts),
            "state_set": np.array(self.m.lazy_dfa._sets[self.state_id],
                                  dtype=np.int64),
            "offset": self.offset,
        }

    @property
    def state_counts(self) -> np.ndarray:
        return np.array(self.counts)


def compile_ruleset(source: str | CsrAutomaton,
                    config: EngineConfig = DEFAULT_CONFIG,
                    strategy: str = "lazy", device=None) -> NfaMatcher:
    """Load a reference-format ``.coe`` ruleset (or a CsrAutomaton) into the
    bit-exact NFA engine."""
    aut = load_coe(source) if isinstance(source, str) else source
    return NfaMatcher(aut, config, strategy, device)
