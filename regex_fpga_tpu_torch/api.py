"""Public API of the torch port: DFA matchers, span extraction, the matcher
surface, the NFA conformance engine and the IDS front door (Snort and l7).

The counterpart of ``regex_fpga_tpu/api.py``::

    m = compile_regex(r"\\d+\\.\\d+", device="cuda")  # fast DFA engine
    report = m.scan(data)                               # per-state counts
    total = m.count(data)                               # k-gram engine
    spans = m.finditer(data)                            # leftmost-longest
    hit = m.search(data)                                # Match or None

    tok = compile_tokenizer(device="cuda")              # GPT-2 pre-split
    offsets = tok.presplit(text)

    lits = compile_literals([b"GET", b"POST"], device="cuda")
    per_pattern = lits.scan_patterns(data).pattern_counts
    totals = lits.count_patterns(data)                  # (P,), folded on the card

    rules = compile_regex_set(patterns, strategy="lazy-device", device="cuda")
    per_rule = rules.scan([flow_a, flow_b]).rule_counts

    nfa = compile_ruleset("rules.coe", strategy="lazy-device", device="cuda")
    report = nfa.scan([flow_a, flow_b])                 # per-NFA-state counts

    ids = compile_snort("community.rules", device="cuda")
    alerts = ids.scan([payload_a, payload_b]).alerts    # per-payload alerts

    l7 = compile_l7("l7-protocols/", strategy="lazy-device", device="cuda")
    per_protocol = l7.scan([flow_a]).rule_counts        # l7.rule_names

A matcher holds its tables on ``device`` and scans every chunk there; the
chain passes and the active-set scan run on the Hopper kernels for a CUDA
device and on their plain versions for the CPU. Span extraction runs a
reversed-pattern DFA backward over the stream on the device (every match
start) and then the anchored forward walk on the host (native
``anchored_spans``). Patterns with ``\\b``/``\\B``, ``(?m)`` anchors or lazy
quantifiers go to ``HostRegexMatcher`` (a device prefilter, then the Pike VM
of ``models/captures.py``), and patterns with backreferences, lookaround or
conditionals to ``HostBacktrackMatcher`` (``models/backtrack.py``). The
Snort matcher prefilters every payload of a batch on the device and
verifies the candidate rules on the host. Results equal the JAX package's
bit for bit.

Counting scans of a ``DfaMatcher`` (``scan``, ``count`` and what is built
on them) go through the engine router (``ops/router.py``):
``scan_backend="auto"`` prices the device engines and the native host
walker on the H100's measured priors and takes the faster, ``"device"`` and
``"host"`` force one. Both give the same histograms, bit for bit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import warnings
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
    build_aho_corasick,
    build_tokenizer_dfa,
    compile_pattern,
    contains_backtrack,
    contains_bound,
    contains_lazy,
    load_coe,
    parse_pattern,
    regexes_to_csr,
    write_coe,
)
from .models.backtrack import BacktrackProgram
from .models.captures import CaptureProgram
from .models.http import parse_http_request
from .models.l7 import load_l7_dir, load_l7_pattern
from .models.regex import (
    DfaBlowupError,
    RegexError,
    nullable,
    required_literal,
    strip_assertions,
)
from .models.snort import (
    ByteExtract,
    ByteJump,
    ByteTest,
    IsDataAt,
    SnortContent,
    load_snort_rules,
    parse_snort_rules,
    pcre_to_pattern,
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
from .ops.router import choose_scan_backend
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
from .utils.profiling import trace

__all__ = [
    "DEFAULT_CONFIG",
    "DfaMatcher",
    "DfaStreamScanner",
    "EngineConfig",
    "HostBacktrackMatcher",
    "HostRegexMatcher",
    "LazyStreamScanner",
    "LiteralReport",
    "LiteralSetMatcher",
    "Match",
    "NfaMatcher",
    "NfaStreamScanner",
    "PrefilteredRuleSet",
    "RuleSetMatcher",
    "RuleSetReport",
    "ScanReport",
    "SnortAlert",
    "SnortMatcher",
    "SnortReport",
    "TokenizerMatcher",
    "compile_l7",
    "compile_literals",
    "compile_regex",
    "compile_regex_set",
    "compile_regex_set_prefiltered",
    "compile_ruleset",
    "compile_snort",
    "compile_tokenizer",
]

#: The port's default engine settings: the JAX defaults
#: (``scan_backend="auto"``: the engine router chooses).
DEFAULT_CONFIG = EngineConfig()


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


class Match:
    """``re.Match``-style result: a byte-offset span and capture groups.

    The overall span comes from the device engines (POSIX leftmost-longest);
    group sub-spans are recovered on the host by the tagged Pike VM
    (``models/captures.py``) re-walking just the matched bytes, with greedy
    (Perl-style) disambiguation inside the fixed span. Matchers without a
    capture program (rule sets, literals, tokenizers) yield group-0-only
    matches."""

    __slots__ = ("string", "_start", "_end", "_spans", "_names",
                 "_lastindex", "pos", "endpos", "re")

    def __init__(self, string: bytes, start: int, end: int,
                 group_spans: list | None = None,
                 group_names: dict | None = None,
                 lastindex: int | None = None):
        self.string = string
        self._start = start
        self._end = end
        self._spans = group_spans or []  # per group 1..n: (a, b) or None
        self._names = group_names or {}
        self._lastindex = lastindex
        # ``re.Match`` attributes: the search window and the producing
        # pattern. The span entry points restamp ``pos``;
        # ``re_compat.Pattern`` attaches itself as ``re``.
        self.pos = 0
        self.endpos = len(string)
        self.re = None

    def _idx(self, key) -> int:
        if isinstance(key, str):
            if key not in self._names:
                raise IndexError(f"no such group: {key!r}")
            return self._names[key]
        if key == 0 or 1 <= key <= len(self._spans):
            return key
        raise IndexError(f"no such group: {key}")

    def span(self, idx=0) -> tuple[int, int]:
        idx = self._idx(idx)
        if idx == 0:
            return (self._start, self._end)
        sp = self._spans[idx - 1]
        return (-1, -1) if sp is None else sp

    def start(self, idx=0) -> int:
        return self.span(idx)[0]

    def end(self, idx=0) -> int:
        return self.span(idx)[1]

    def group(self, *idxs):
        if not idxs:
            idxs = (0,)
        out = []
        for i in idxs:
            a, b = self.span(i)
            out.append(None if a < 0 else self.string[a:b])
        return out[0] if len(out) == 1 else tuple(out)

    def groups(self, default=None) -> tuple:
        return tuple(
            default if sp is None else self.string[sp[0]:sp[1]]
            for sp in self._spans
        )

    def groupdict(self, default=None) -> dict:
        return {name: self.group(name) if self._spans[i - 1] is not None
                else default
                for name, i in self._names.items()}

    @property
    def lastindex(self) -> int | None:
        """Index of the chronologically last matched group (``re``
        semantics: the last capture mark written on the winning path)."""
        return self._lastindex

    @property
    def lastgroup(self) -> str | None:
        """Name of the last matched group; None if unnamed or none."""
        if self._lastindex is None:
            return None
        for name, i in self._names.items():
            if i == self._lastindex:
                return name
        return None

    @property
    def regs(self) -> tuple:
        """All group spans as ``re``'s ``regs`` tuple ((-1, -1) = no
        match), group 0 first."""
        return ((self._start, self._end),) + tuple(
            (-1, -1) if sp is None else tuple(sp) for sp in self._spans
        )

    def expand(self, template: bytes) -> bytes:
        """Expand a ``re.sub``-style template (``\\1``, ``\\g<name>``, ...)
        against this match."""
        from .re_compat import _expand  # re_compat imports this module

        return _expand(template, self)

    def __getitem__(self, idx) -> bytes:
        return self.group(idx)

    def __repr__(self) -> str:
        return (f"<regex_fpga_tpu_torch.Match span=({self._start}, "
                f"{self._end}) match={self.group()!r}>")


def _stamp_pos(m: Match | None, pos: int) -> Match | None:
    """Record the caller's clamped ``pos`` on a Match (``re.Match.pos``).
    ``endpos`` needs no stamp: ``Match.string`` is already the
    endpos-truncated subject, so its default ``len(string)`` is the clamped
    endpos."""
    if m is not None:
        m.pos = pos
    return m


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
    counts: np.ndarray | None          # (S,) int64 per-state match counts
    match_mask: torch.Tensor | None    # (L,) bool: accept fired before byte i
    states: torch.Tensor | None        # (L,) int32: state before byte i
    final_state: int
    iterations: int = 0


class _Chunk(NamedTuple):
    """One chunk's answer from ``DfaMatcher._scan_chunk``, by ``emit``."""

    match_mask: torch.Tensor | None  # (w,) bool on the device (mask, full)
    states: torch.Tensor | None      # (w,) int32 on the device (full)
    counts: np.ndarray | None        # (S,) int64 (counts)
    final_state: int
    iterations: int
    converged: bool


#: a ragged batch whose rows average at most this many bytes uploads them as
#: one host concatenation; longer rows are copied one by one. Measured in
#: alternating pairs on an NVIDIA H100 80GB HBM3 (700 W; the ragged batch's
#: upload in CHANGES.md): over 16 MiB the concatenation won all 12 pairs at
#: 64 KiB a row and the copies won 11 of 12 at 256 KiB; the crossover lies
#: between
_CONCAT_ROW_BYTES = 1 << 16


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
        # span extraction: compile_regex sets the source; the reversed and
        # anchored automata and the capture program are built at first use
        self._finditer_source: tuple | None = None
        self._reverse_matcher: DfaMatcher | None = None
        self._anchored_np: tuple | None = None
        self._anchored_start = 0
        self._capture_prog = None  # CaptureProgram, or False: no groups

    @property
    def num_states(self) -> int:
        return self.tables.num_states

    def stream_scanner(self, resume: dict | None = None) -> "DfaStreamScanner":
        """Incremental scanning on the fast engine; the carry is (state,
        counts, offset)."""
        return DfaStreamScanner(self, resume)

    # ------------------------------------------------------------ plumbing

    def _upload(self, arr: np.ndarray, non_blocking: bool = False) -> torch.Tensor:
        """A host array as a tensor on the matcher's device (``non_blocking``
        as ``host_to_device`` has it)."""
        with trace("rf.device.upload"):
            return host_to_device(arr, self.device, non_blocking=non_blocking)

    @contextlib.contextmanager
    def _until_read(self):
        """Around a non-blocking upload and the scan whose read waits for
        it: if the scan raises before that read, wait for the stream, since
        the queued copy may still read the caller's buffer."""
        try:
            yield
        except BaseException:
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            raise

    def _lanes(self, n: int) -> int:
        """The chain lanes of a chunk of ``n`` bytes (or k-gram steps): the
        block rule without its divisibility step, so that a length with few
        factors of two still fills the card; ``_chunk_ids`` pads the rest."""
        return shrink_blocks(n, self.config.num_blocks,
                             self.config.min_block_bytes, divisible=False)

    def _stalled_tables(self) -> DfaTables:
        """The tables with the stall class appended (cached)."""
        if self._stall_tables is None:
            self._stall_tables = stall_extend(self.tables)
        return self._stall_tables

    def _padded(self, w: int) -> tuple[int, int]:
        """(lanes, padded width) of a chunk of ``w`` bytes (or k-gram
        steps): ``_lanes(w)``, and ``w`` rounded up to a multiple of it."""
        nb = self._lanes(w)
        return nb, w + -w % nb

    def _chunk_ids(self, data: torch.Tensor, lens=None, width: int = 0):
        """Class ids of one chunk of raw device bytes for the chain engines
        at ``_lanes(w)`` lanes. ``data`` is (w,) or (N, w); for a ragged
        batch it holds the rows' bytes back to back, ``lens`` (N,) the bytes
        of each row and ``width`` the chunk's w. Returns (tables, ids,
        lanes, lead, class_of). Where the lanes divide w and the rows are
        whole, the ids are ``data`` itself, the raw bytes, with the
        matcher's tables and its byte map ``class_of`` for the chain
        kernels to map them; otherwise the bytes are mapped here, each row
        is padded AT THE FRONT with ``lead`` stall ids (one count, or one a
        row with ``lens``) to the width ``_padded(w)`` gives, the tables are
        the stall-extended ones (the stall id is C, int16 when C = 256) and
        ``class_of`` is None.

        Front padding keeps the seam speculation right: every pad step holds
        the chunk's entry state, which is also what each lane's replay
        starts from, so the pad lanes guess their entries exactly. Padding
        at the back would end the chunk in up to ``lanes - 1`` stall steps,
        whole lanes of them where blocks are short, each guessing the entry
        state where the chunk's end state holds: a Jacobi round each, and
        past ``max_iters`` the exact fallback. The caller drops the first
        ``lead`` positions of a mask or states and subtracts ``lead`` visits
        of the entry state from counts; the final state is unchanged."""
        w = data.shape[-1] if lens is None else width
        nb, w_pad = self._padded(w)
        lead = w_pad - (w if lens is None else lens)
        if lens is None and not lead:
            return self.tables, data, nb, 0, self._class_lut
        cls = torch.index_select(self._class_lut, 0,
                                 data.reshape(-1).int()).reshape(data.shape)
        stall = self.tables.num_classes
        rows = data.shape[:-1] if lens is None else (len(lens),)
        ids = torch.full((*rows, w_pad), stall,
                         dtype=torch.uint8 if stall < 256 else torch.int16,
                         device=self.device)
        if lens is None:
            ids[..., lead:] = cls
        else:
            real = (torch.arange(w_pad, device=self.device)
                    >= torch.as_tensor(lead, device=self.device)[:, None])
            ids.masked_scatter_(real, cls.to(ids.dtype))
        return self._stalled_tables(), ids, nb, lead, None

    # --------------------------------------------------------- host backend

    def _host_backend(self, n_streams: int, workload_bytes: int = 0) -> bool:
        """True when the engine router (``ops/router.py``) sends this
        counting scan to the native host walker: forced by
        ``scan_backend="host"`` (which raises without the walker), or chosen
        by the H100's cost model under ``"auto"``; ``workload_bytes`` lets
        the router probe both engines when enough work is at stake."""
        return choose_scan_backend(
            self.tables.num_states, self.tables.num_classes, n_streams,
            self.config.scan_backend, tables=self.tables,
            workload_bytes=workload_bytes,
            chunk_bytes=self.config.chunk_bytes,
            num_blocks=self.config.num_blocks,
            min_block_bytes=self.config.min_block_bytes,
        ) == "host"

    def _host_tables(self):
        """Host copies of the tables, cached: the walker's int16 table is
        memoized on the identity of this array (``native._as_table16``)."""
        if not hasattr(self, "_host_np_cache"):
            self._host_np_cache = (
                self.tables.table.cpu().numpy(),
                self.tables.class_of.cpu().numpy(),
                self.tables.accept.cpu().numpy(),
            )
        return self._host_np_cache

    def _host_scan_counts(self, streams):
        """(per-stream per-state counts, final states) from the native
        walker, equal to the device scan's (accept counted before each byte,
        the last byte's accept dropped; the caller adds the end-of-stream
        match). Fewer than 4 streams cannot fill the walker's interleave, so
        each is cut into speculative segments (``dfa_scan_speculative``)."""
        tab, cls, acc = self._host_tables()
        if len(streams) < 4:
            counts = np.zeros((len(streams), self.num_states), np.int64)
            finals = np.zeros(len(streams), np.int32)
            for i, st in enumerate(streams):
                counts[i], finals[i] = native.dfa_scan_speculative(
                    tab, cls, acc, st, start=self.start)
            return counts, finals
        return native.dfa_scan_multi(tab, cls, acc, streams, starts=self.start)

    def _scan_host(self, streams, collect_positions: bool):
        """``scan`` on the host walker: counts (n, S), positions (with
        ``collect_positions``: the walk's match mask) and final states, the
        end-of-stream match not included."""
        positions: list = []
        if not collect_positions:
            counts, finals = self._host_scan_counts(streams)
            return counts, finals, positions
        counts = np.zeros((len(streams), self.num_states), dtype=np.int64)
        finals = np.zeros(len(streams), dtype=np.int64)
        tab, cls, acc = self._host_tables()
        for i, stream in enumerate(streams):
            counts[i], mask, finals[i] = native.dfa_scan(
                tab, cls, acc, stream, start=self.start)
            positions.append(np.nonzero(mask)[0])
        return counts, finals, positions

    def _final_matches(self, streams, finals) -> list[int]:
        """The streams whose end-of-stream match counts: non-empty, ending
        in a state that accepts at the end (with ``include_final_match``)."""
        if not self.include_final_match:
            return []
        return [i for i, (s_, f) in enumerate(zip(streams, finals))
                if len(s_) and self._accept_eof[f]]

    # ---------------------------------------------------------------- scan

    def scan(self, data, collect_positions: bool = False) -> ScanReport:
        streams = _as_streams(data)
        n_bytes = sum(len(s_) for s_ in streams)
        positions: list = []
        iters, converged = 0, True
        on_host = bool(streams) and self._host_backend(len(streams), n_bytes)
        batch = (not collect_positions and len(streams) > 1
                 and any(len(s_) for s_ in streams))
        with Timer() as t:
            if on_host:
                counts, finals, positions = self._scan_host(streams,
                                                            collect_positions)
                engine = "dfa-host-native"
            elif batch and len({len(s_) for s_ in streams}) == 1:
                # equal-length batch: all streams as extra chain lanes in one pass
                counts, iters, converged, finals = self._scan_batch_counts(
                    np.stack(streams))
                engine = "dfa-fast-batch"
            elif batch:
                # ragged batch: streams pad at the front with the stall class
                counts, iters, converged, finals = self._scan_ragged_counts(
                    streams)
                engine = "dfa-fast-batch-ragged"
            else:
                counts = np.zeros((len(streams), self.num_states), np.int64)
                finals = np.zeros(len(streams), np.int64)
                for i, stream in enumerate(streams):
                    if collect_positions:
                        c, mask, it, conv = self._scan_stream(stream)
                        counts[i] = c.cpu().numpy()
                        positions.append(
                            torch.nonzero(mask).reshape(-1).cpu().numpy())
                    else:
                        # counts-only: the histogram is computed on the
                        # device, no per-position array leaves it
                        counts[i], it, conv = self._scan_stream_counts(stream)
                    finals[i] = self._last_final
                    iters, converged = max(iters, it), converged and conv
                engine = "dfa-fast"
            for i in self._final_matches(streams, finals):
                counts[i, finals[i]] += 1
                if collect_positions:
                    positions[i] = np.concatenate([positions[i],
                                                   [len(streams[i])]])
        m = RunMetrics(
            engine=engine,
            bytes_scanned=n_bytes,
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
        composed class count stays small: on each chunk's longest prefix of
        whole steps that its full lane count divides, then the k=1 counts
        engine over the rest (fewer than lanes x k bytes, padded with the
        stall class) from the k-gram carry state. A K3 part whose rounds
        run out takes the exact fallback, counts only, on the bytes K3 was
        given, from the chunk's entry state: every chunk before it settled,
        so that state is exact. Where the k-gram engine is off (more than
        ``KGRAM_MAX_STATES`` states), the engine router may send the count
        to the host walker."""
        with trace("rf.api.count"):
            streams = _as_streams(data)
            if streams and self._kgram() is None and self._host_backend(
                    len(streams), sum(len(s_) for s_ in streams)):
                counts, finals = self._host_scan_counts(streams)
                return (int(counts.sum())
                        + len(self._final_matches(streams, finals)))
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
                for off in range(0, len(stream), cb):
                    chunk = stream[off : off + cb]
                    steps = len(chunk) // kg.k
                    nb = self._lanes(max(steps, 1))
                    main_len = (steps // nb) * nb * kg.k
                    if main_len:
                        # the raw text goes to K3, which maps it itself; a
                        # pinned chunk's copy is only queued, as in _scan_chunk
                        with trace("rf.engine.kgram"):
                            with self._until_read():
                                on_card = self._upload(chunk[:main_len],
                                                       non_blocking=True)
                                res = dfa_scan_kgram(
                                    ta, on_card, num_blocks=nb, start=cur,
                                    max_iters=self.config.max_iters, maps=maps,
                                )
                            if res.converged:
                                stream_total += int(res.total)
                                cur = int(res.final_state)
                            else:  # non-synchronizing automaton
                                fb = self._exact_fallback(
                                    on_card, cur, collect_matches=False)
                                stream_total += int(fb.counts.sum())
                                cur = fb.final_state
                    if main_len < len(chunk):
                        ch = self._scan_chunk(chunk[main_len:], cur, "counts")
                        stream_total += int(ch.counts.sum())
                        cur = ch.final_state
                if self.include_final_match and bool(self._accept_eof[cur]):
                    stream_total += 1
                total += stream_total
            return total

    # ------------------------------------------------------ chunked engines

    def _check_domain(self, ok: bool) -> None:
        if not ok:
            raise RuntimeError("device DFA pass produced out-of-domain state "
                               "ids: corrupt table")

    def _unpad(self, counts: torch.Tensor, cur, lead) -> np.ndarray:
        """A padded chunk's (N, S) or (S,) int32 counts, on the host, as
        (N, S) int64 without the pad: each row's ``lead`` stall steps (one
        count, or one a row) sat in its entry state ``cur`` (N,)."""
        counts = counts.numpy().astype(np.int64).reshape(len(cur), -1)
        if np.count_nonzero(lead):
            counts[np.arange(len(cur)), cur] -= lead * self._host_tables()[2][cur]
        return counts

    def _scan_chunk(self, raw: np.ndarray, cur: int, emit: str,
                    reverse: bool = False, fold=None) -> _Chunk:
        """One chunk of a stream from state ``cur`` on the k=1 engine in
        ``emit`` mode (``dfa_scan_fast``), or on the exact path where it
        does not converge. A pinned chunk's copy is only queued: the scan's
        one read waits for it. ``reverse`` scans the chunk's bytes back to
        front: it is uploaded as it lies and flipped on the device. Its
        ids and the byte map, where the chain kernels map the raw bytes
        themselves, come from ``_chunk_ids``. The
        mask and states stay on the device; the pad's positions are dropped
        from them, and its visits of the entry state from the counts.
        ``fold`` (counts mode) maps the chunk's counts, on the device and
        without the pad's visits, to what the chunk returns as ``counts``
        (int64, on the host): it rides in the verdict's read."""
        with trace("rf.engine.k1"):
            with self._until_read():
                data = self._upload(raw, non_blocking=True)
                if reverse:
                    data = torch.flip(data, (0,))
                tables, ids, nb, lead, class_of = self._chunk_ids(data)
                res = dfa_scan_fast(
                    tables, ids, num_blocks=nb, start=cur,
                    max_iters=self.config.max_iters, emit=emit,
                    class_of=class_of, fold=None if fold is None else
                    lambda c: fold(self._unpad_device(c, cur, lead)))
            self._check_domain(res.domain_ok)
            if res.converged:
                counts = res.counts
                if counts is not None:
                    counts = (self._unpad(counts, [cur], lead)[0] if fold is None
                              else counts.numpy().astype(np.int64, copy=False))
                return _Chunk(
                    None if res.match_mask is None else res.match_mask[lead:],
                    None if res.states is None else res.states[lead:],
                    counts, int(res.final_state), res.iterations, True)
            fb = self._exact_fallback(data, cur,
                                      collect_matches=emit != "counts")
            counts = fb.counts
            if fold is not None:
                counts = fold(torch.from_numpy(counts).to(self.device)).cpu().numpy()
            return _Chunk(fb.match_mask, fb.states, counts, fb.final_state,
                          fb.iterations, False)

    def _unpad_device(self, counts: torch.Tensor, cur: int, lead: int) -> torch.Tensor:
        """A padded chunk's (..., S) counts on the device without the
        ``lead`` visits of the entry state ``cur`` that its pad made (no
        host read)."""
        if not lead:
            return counts
        counts = counts.clone()
        counts[..., cur] -= self.tables.accept[cur].to(counts.dtype) * lead
        return counts

    def _scan_batch_chunk(self, chunk, rows, cur: np.ndarray):
        """One chunk of a batch on ``dfa_scan_fast_multi`` from the rows'
        entry states ``cur`` (N,) int32, or row by row on the exact path
        where it does not converge: ``chunk`` is ``_chunk_ids``'s answer for
        the rows' device bytes, ``rows`` their bytes on the host. Returns
        (counts (N, S) int64, final states (N,) int32, iterations,
        converged)."""
        tables, ids, nb, lead, class_of = chunk
        res = dfa_scan_fast_multi(
            tables, ids, num_blocks=nb,
            starts=torch.as_tensor(cur, device=self.device),
            max_iters=self.config.max_iters, emit="counts", class_of=class_of,
        )
        self._check_domain(res.domain_ok)
        if res.converged:
            return (self._unpad(res.counts, cur, lead),
                    res.final_states.numpy().astype(np.int32), res.iterations,
                    True)
        counts = np.zeros((len(rows), self.num_states), dtype=np.int64)
        cur = cur.copy()
        for i, row in enumerate(rows):
            if len(row):
                fb = self._exact_fallback(self._upload(row), int(cur[i]),
                                          collect_matches=False)
                counts[i] = fb.counts
                cur[i] = fb.final_state
        return counts, cur, res.iterations, False

    def _chunks(self, stream: np.ndarray, emit: str, start=None):
        """Yields (offset, ``_Chunk``) for each chunk of ``stream`` in turn
        (``_scan_chunk``), each entered in the state the last one ended in;
        at the end the state after the stream is in ``self._last_final``."""
        cur = self.start if start is None else start
        cb = self.config.chunk_bytes
        for off in range(0, len(stream), cb):
            ch = self._scan_chunk(stream[off : off + cb], cur, emit)
            yield off, ch
            cur = ch.final_state
        self._last_final = cur

    def _scan_stream(self, stream: np.ndarray):
        """Returns (counts (S,) int64, match_mask (L,) bool, iterations,
        converged), both tensors on the device: the per-state counts and the
        accept bit before each byte. The state after the stream is left in
        ``self._last_final``."""
        counts = torch.zeros(self.num_states, dtype=torch.int64,
                             device=self.device)
        mask = torch.empty(len(stream), dtype=torch.bool, device=self.device)
        iters, converged = 0, True
        for off, ch in self._chunks(stream, "full"):
            mask[off : off + len(ch.match_mask)] = ch.match_mask
            counts += torch.bincount(ch.states[ch.match_mask].long(),
                                     minlength=self.num_states)
            iters, converged = max(iters, ch.iterations), converged and ch.converged
        return counts, mask, iters, converged

    def _mask_chunk_device(self, raw_chunk: np.ndarray, cur: int,
                           reverse: bool = False):
        """One chunk's (match mask, final state) via the k=1 mask scan, or
        via the exact path when the scan does not converge; the mask stays
        on the device. ``reverse`` scans the chunk's bytes back to front."""
        ch = self._scan_chunk(raw_chunk, cur, "mask", reverse)
        return ch.match_mask, ch.final_state

    def _scan_match_positions(self, stream: np.ndarray,
                              reverse: bool = False) -> np.ndarray:
        """Byte offsets where the accept mask is set, compacted on the
        device (``mask_positions``): each chunk downloads a count and the
        positions instead of the whole mask; chunks denser than cap/chunk
        take ``nonzero`` of the mask instead. ``reverse`` scans
        ``stream[::-1]`` (offsets are into the reversed stream) without a
        reversed copy on the host. Sets ``self._last_final``. Returns
        ascending int64 offsets."""
        out = [np.empty(0, np.int64)]
        cur = self.start
        cb = self.config.chunk_bytes
        l = len(stream)
        for off in range(0, l, cb):
            # reversed stream [off, off + n) = stream[l - off - n : l - off]
            chunk = (stream[max(l - off - cb, 0) : l - off] if reverse
                     else stream[off : off + cb])
            mask, cur_next = self._mask_chunk_device(chunk, cur, reverse)
            cap = max(1024, len(chunk) // 4)
            with trace("rf.engine.positions"):
                pos_dev, count_dev = mask_positions(mask, cap)
                count = int(count_dev)
            with trace("rf.device.readback"):
                if count > cap:  # dense chunk: compact the mask itself
                    pos = torch.nonzero(mask).reshape(-1).cpu().numpy()
                else:
                    pos = pos_dev[:count].cpu().numpy()
            out.append(pos.astype(np.int64) + off)
            cur = cur_next
        self._last_final = cur
        return np.concatenate(out)

    def _scan_match_states(self, stream: np.ndarray):
        """The states path: byte offsets where the accept mask is set and
        the state before each of those bytes, from K1's full mode (or the
        exact path); positions come from the mask on the device and the
        states are gathered there, so 12 bytes a match leave the device
        instead of 5 a byte. Sets ``self._last_final``. Returns (ascending
        int64 offsets, int32 states)."""
        pos_out = [np.empty(0, np.int64)]
        st_out = [np.empty(0, np.int32)]
        for off, ch in self._chunks(stream, "full"):
            pos = torch.nonzero(ch.match_mask).reshape(-1)
            st_out.append(torch.index_select(ch.states, 0, pos)
                          .cpu().numpy().astype(np.int32, copy=False))
            pos_out.append(pos.cpu().numpy() + off)
        return np.concatenate(pos_out), np.concatenate(st_out)

    def _scan_batch_counts(self, arr: np.ndarray):
        """Chunked batch scan of (N, L) equal-length streams via
        ``dfa_scan_fast_multi`` (per-stream histograms on the device), the
        whole array uploaded once and each row's chunk mapped and padded
        as ``_chunk_ids`` decides. Returns (counts (N, S), iterations,
        converged, final states (N,))."""
        n, l = arr.shape
        data = self._upload(arr)
        counts = np.zeros((n, self.num_states), dtype=np.int64)
        cur = np.full(n, self.start, dtype=np.int32)
        iters, converged = 0, True
        cb = self.config.chunk_bytes
        for off in range(0, l, cb):
            c, cur, it, conv = self._scan_batch_chunk(
                self._chunk_ids(data[:, off : off + cb]),
                arr[:, off : off + cb], cur)
            counts += c
            iters, converged = max(iters, it), converged and conv
        return counts, iters, converged, cur

    def _scan_ragged_counts(self, streams):
        """Variable-length batch in one multi-lane chain: each chunk of
        ``_padded(w)``'s width takes every row's next bytes, padded AT THE
        FRONT with the stall class by ``_chunk_ids``, and runs through
        ``dfa_scan_fast_multi`` with per-lane pinned entries, as the
        equal-length path does. The overcount of the pad steps, exactly
        their visits of each row's entry state, is taken off afterwards.
        Returns (counts (N, S) int64, iters, converged, finals (N,))."""
        n = len(streams)
        lens = np.array([len(s_) for s_ in streams], dtype=np.int64)
        lmax = int(lens.max())
        counts = np.zeros((n, self.num_states), dtype=np.int64)
        cur = np.full(n, self.start, dtype=np.int32)
        iters, converged = 0, True
        off = 0
        cb = self.config.chunk_bytes
        while off < lmax:
            w = min(cb, lmax - off)
            w_pad = self._padded(w)[1]
            real = np.clip(lens - off, 0, w_pad)
            # the rows' slices go to one device array in row order: short
            # rows as one host concatenation (a copy per row would cost more
            # than the memcpy), long ones a copy each
            rows = [s_[off : off + r] for s_, r in zip(streams, real)]
            total = int(real.sum())
            if total <= _CONCAT_ROW_BYTES * np.count_nonzero(real):
                raw = self._upload(np.concatenate(rows))
            else:
                raw = torch.empty(total, dtype=torch.uint8,
                                  device=self.device)
                at = 0
                with warnings.catch_warnings():
                    warnings.filterwarnings("ignore",
                                            message=".*not writable.*")
                    for row in rows:
                        raw[at : at + len(row)].copy_(torch.from_numpy(row))
                        at += len(row)
            c, cur, it, conv = self._scan_batch_chunk(
                self._chunk_ids(raw, lens=real, width=w), rows, cur)
            counts += c
            iters, converged = max(iters, it), converged and conv
            off += w_pad
        return counts, iters, converged, cur

    def _scan_stream_counts(self, stream: np.ndarray, start=None):
        """Counts-only chunked scan (the histogram stays on the device).
        Returns (counts (S,), iterations, converged) and sets
        ``self._last_final``."""
        counts = np.zeros(self.num_states, dtype=np.int64)
        iters, converged = 0, True
        for _, ch in self._chunks(stream, "counts", start):
            counts += ch.counts
            iters, converged = max(iters, ch.iterations), converged and ch.converged
        return counts, iters, converged

    def _exact_fallback(self, data: torch.Tensor, start,
                        collect_matches: bool = True) -> _FallbackResult:
        """Exact path for automata the fast engine does not settle, over a
        chunk's bytes ``data``, already on the matcher's device: the blocked
        composition scan over its whole 1024-byte blocks, then the serial
        scan over the tail of fewer than 1024 bytes, read back and walked
        on the host tables. With ``collect_matches`` the answer is the mask
        and the states, on the device; without, it is the counts, on the
        host, which come back with the blocked scan's final state in one
        read, and no mask or states are made."""
        with trace("rf.engine.fallback"):
            block = 1024
            main = len(data) - len(data) % block
            counts = np.zeros(self.num_states, dtype=np.int64)
            masks, states = [], []
            cur = int(start)
            if main:
                res = dfa_scan_blocked(self.tables, data[:main],
                                       block_size=block, start=cur,
                                       collect_matches=collect_matches)
                if collect_matches:
                    masks.append(res.match_mask)
                    states.append(res.states)
                    cur = int(res.final_state)
                else:
                    with trace("rf.device.readback"):
                        host = torch.cat([res.counts.long(),
                                          res.final_state.reshape(1).long()]
                                         ).cpu().numpy()
                    counts += host[:-1]
                    cur = int(host[-1])
            if main < len(data):
                with trace("rf.engine.fallback.serial"):
                    tab, cls, acc = map(torch.from_numpy, self._host_tables())
                    res = dfa_scan_serial(
                        dataclasses.replace(self.tables, table=tab,
                                            class_of=cls, accept=acc),
                        data[main:], start=cur)
                cur = int(res.final_state)
                if collect_matches:
                    masks.append(res.match_mask.to(self.device))
                    states.append(res.states.to(self.device))
                else:
                    counts += res.counts.numpy()
            if not collect_matches:
                return _FallbackResult(counts, None, None, cur)
            # one piece is the answer itself: a cat would copy it
            return _FallbackResult(
                None, masks[0] if len(masks) == 1 else torch.cat(masks),
                states[0] if len(states) == 1 else torch.cat(states), cur)

    # ------------------------------------------------------ span extraction

    def _ensure_anchored(self) -> None:
        """Build the reversed-pattern matcher (on the same device and
        config) and the anchored automaton that span extraction uses, at
        first use: scan-only users never pay for them."""
        if self._finditer_source is not None and self._reverse_matcher is None:
            pattern, max_states, config = self._finditer_source
            rev = compile_pattern(pattern, max_states=max_states,
                                  anchored=False, reverse=True)
            self._reverse_matcher = DfaMatcher(rev, config, self.device)
            fwd = compile_pattern(pattern, max_states=max_states, anchored=True)
            self._anchored_np = (np.ascontiguousarray(fwd.table), fwd.accept,
                                 fwd.dead, fwd.eof_accept)
            self._anchored_start = fwd.start
        if self._reverse_matcher is None or self._anchored_np is None:
            raise NotImplementedError(
                "span extraction requires a pattern-compiled matcher "
                "(compile_regex)"
            )

    def _anchored_longest_end(self, stream: np.ndarray, s0: int) -> int:
        """Longest match end for a match anchored at byte offset ``s0``
        (host walk of the anchored DFA), or -1 if no match starts there."""
        table, accept, dead, accept_eof = self._anchored_np
        st = self._anchored_start
        last_end = s0 if accept[st] else -1
        l = len(stream)
        for i in range(s0, l):
            st = int(table[stream[i], st])
            if st == dead:
                return last_end
            if accept[st]:
                last_end = i + 1
        if accept_eof[st] and not accept[st]:
            last_end = l  # end-anchored: the match closes at EOF only
        return last_end

    def _make_match(self, raw: bytes, a: int, b: int) -> Match:
        """A Match, with capture-group spans when the source pattern has
        groups (the tagged Pike VM re-walks ``raw[a:b]``)."""
        if self._capture_prog is None:
            prog = (None if self._finditer_source is None
                    else CaptureProgram(self._finditer_source[0]))
            self._capture_prog = (prog if prog is not None and prog.num_groups
                                  else False)
        if self._capture_prog is False:
            return Match(raw, a, b)
        prog = self._capture_prog
        spans, lastindex = prog.extract(raw, a, b)
        return Match(raw, a, b, spans, prog.group_names, lastindex)

    @property
    def num_groups(self) -> int:
        self._make_match(b"", 0, 0)  # builds the capture program
        return 0 if self._capture_prog is False else self._capture_prog.num_groups

    def finditer(self, data, limit: int | None = None,
                 pos: int = 0, endpos: int | None = None
                 ) -> list[tuple[int, int]]:
        """Non-overlapping (start, end) spans, POSIX leftmost-longest.

        Two passes: the reversed-pattern DFA scans the stream backward on
        the device and marks every position where some match starts; then
        anchored forward walks on the host (native ``anchored_spans``) take
        the longest match at each leftmost start. Differs from Python ``re``
        for patterns like ``ab|abc``, where backtracking takes the first
        alternative. ``limit`` stops after that many spans (``search``), and
        then the forward walk runs in Python, so that it stops at the first
        span. ``pos``/``endpos`` follow ``re.Pattern.finditer``: these
        patterns carry no context assertion, so scanning the suffix and
        shifting is exact, except that ``^`` never matches at ``pos > 0``.
        """
        if pos or endpos is not None:
            raw, pos, ok = self._clip(bytes(_as_streams(data)[0]), pos,
                                      endpos)
            if not ok or (pos and self._pattern_start_anchored()):
                return []
            return [(a + pos, b + pos)
                    for a, b in self.finditer(raw[pos:], limit)]
        self._ensure_anchored()
        stream = _as_streams(data)[0]
        if len(stream) == 0:
            # a nullable pattern matches the empty string once
            end = self._anchored_longest_end(stream, 0)
            return [(0, 0)] if end == 0 else []
        starts = self._match_starts(stream)
        if limit is None:
            table, accept, dead, accept_eof = self._anchored_np
            out = native.anchored_spans(table, accept, accept_eof,
                                        self._anchored_start, dead, stream,
                                        starts)
            spans = [(int(a), int(b)) for a, b in out]
            return self._append_tail_empty(spans, stream)
        spans: list[tuple[int, int]] = []
        p = 0
        for s0 in starts.tolist():
            if s0 < p:
                continue
            last_end = self._anchored_longest_end(stream, s0)
            if last_end >= 0:
                spans.append((s0, last_end))
                if len(spans) >= limit:
                    return spans
                p = max(last_end, s0 + 1)  # empty match: advance one byte
        return self._append_tail_empty(spans, stream)

    def _match_starts(self, stream: np.ndarray) -> np.ndarray:
        """Ascending candidate match starts from the backward pass (shared
        by ``finditer`` and ``finditer_arrays``)."""
        self._ensure_anchored()
        return _starts_from_reverse(self._reverse_matcher, stream)

    def _append_tail_empty(self, spans, stream):
        """A nullable pattern matches empty at the end of the buffer (``re``
        yields ``(l, l)``); the backward pass has no slot for start == l, so
        it is appended here when the last span leaves room for it."""
        l = len(stream)
        if spans:
            a, b = spans[-1]
            p = max(b, a + 1)
        else:
            p = 0
        if p <= l and self._anchored_longest_end(stream, l) == l:
            spans.append((l, l))
        return spans

    def finditer_arrays(self, data) -> np.ndarray:
        """Spans as an (N, 2) int64 array: the content of ``finditer``
        without building N Python tuples (match-dense streams have
        millions)."""
        self._ensure_anchored()
        stream = _as_streams(data)[0]
        if len(stream) == 0:
            return np.asarray(self.finditer(stream), dtype=np.int64).reshape(-1, 2)
        l = len(stream)
        table, accept, dead, accept_eof = self._anchored_np
        out = native.anchored_spans(table, accept, accept_eof,
                                    self._anchored_start, dead, stream,
                                    self._match_starts(stream))
        if len(out):
            p = max(int(out[-1, 1]), int(out[-1, 0]) + 1)
        else:
            p = 0
        if p <= l and self._anchored_longest_end(stream, l) == l:
            out = np.concatenate([out, [[l, l]]], axis=0)
        return out

    def finditer_matches(self, data, limit: int | None = None) -> list[Match]:
        """Like ``finditer``, with ``Match`` objects (capture groups
        included) instead of bare spans."""
        raw = bytes(_as_streams(data)[0])
        return [self._make_match(raw, a, b)
                for a, b in self.finditer(raw, limit)]

    # -- re-module conveniences (span semantics: leftmost-longest)

    def _pattern_start_anchored(self) -> bool:
        """Leading ``^`` (not multiline): ``re``'s ``search``/``match``
        with ``pos > 0`` never match, since ``pos`` is not slicing."""
        cached = getattr(self, "_start_anchored_cache", None)
        if cached is None:
            cached = bool(self._finditer_source) and parse_pattern(
                self._finditer_source[0]).start_anchored
            self._start_anchored_cache = cached
        return cached

    @staticmethod
    def _clip(raw, pos: int, endpos):
        """``re``'s pos/endpos rules (bytes or arrays): ``pos`` clamps to
        ``[0, len]`` first, ``endpos`` truncates the subject (``$`` and
        lookahead see the end there), and ``pos > endpos`` after clamping
        means no match at all. Returns (subject, clamped pos, ok)."""
        n = len(raw)
        pos = min(max(int(pos), 0), n)
        if endpos is not None:
            e = min(max(int(endpos), 0), n)
            if pos > e:
                return raw[:e], pos, False
            raw = raw[:e]
        return raw, pos, True

    def search(self, data, pos: int = 0, endpos: int | None = None
               ) -> Match | None:
        """First (leftmost-longest) match in the stream, or None.
        ``pos``/``endpos`` follow ``re.Pattern.search``."""
        raw, pos, ok = self._clip(bytes(_as_streams(data)[0]), pos, endpos)
        if not ok:
            return None
        if pos:
            if self._pattern_start_anchored():
                return None
            spans = [(a + pos, b + pos)
                     for a, b in self.finditer(raw[pos:], limit=1)]
        else:
            spans = self.finditer(raw, limit=1)
        if not spans:
            return None
        a, b = spans[0]
        return _stamp_pos(self._make_match(raw, a, b), pos)

    def match(self, data, pos: int = 0, endpos: int | None = None
              ) -> Match | None:
        """Longest match anchored at ``pos``, or None (``re.match``)."""
        self._ensure_anchored()
        stream, pos, ok = self._clip(_as_streams(data)[0], pos, endpos)
        if not ok or (pos and self._pattern_start_anchored()):
            return None
        end = self._anchored_longest_end(stream, pos)
        if end < 0:
            return None
        return _stamp_pos(self._make_match(bytes(stream), pos, end), pos)

    def fullmatch(self, data, pos: int = 0, endpos: int | None = None
                  ) -> Match | None:
        """Match spanning ``[pos, endpos)``, or None (``re.fullmatch``)."""
        self._ensure_anchored()
        stream, pos, ok = self._clip(_as_streams(data)[0], pos, endpos)
        if not ok or (pos and self._pattern_start_anchored()):
            return None
        table, accept, dead, accept_eof = self._anchored_np
        st = self._anchored_start
        for b in stream[pos:].tolist():
            st = int(table[b, st])
            if st == dead:
                return None
        if accept[st] or accept_eof[st]:
            return _stamp_pos(self._make_match(bytes(stream), pos, len(stream)),
                              pos)
        return None

    def split(self, data, maxsplit: int = 0) -> list[bytes]:
        """Split the stream on matches (``re.split`` without groups); empty
        matches split as in Python 3.7+ ``re``."""
        raw = bytes(_as_streams(data)[0])
        out: list[bytes] = []
        p = 0
        for n, (a, b) in enumerate(self.finditer(raw)):
            if maxsplit and n >= maxsplit:
                break
            out.append(raw[p:a])
            p = b
        out.append(raw[p:])
        return out

    def sub(self, repl, data, count: int = 0) -> bytes:
        """Replace matches with ``repl`` (bytes, or callable(Match) ->
        bytes)."""
        return self.subn(repl, data, count)[0]

    def subn(self, repl, data, count: int = 0) -> tuple[bytes, int]:
        raw = bytes(_as_streams(data)[0])
        pieces: list[bytes] = []
        p = 0
        n = 0
        for a, b in self.finditer(raw):
            if count and n >= count:
                break
            pieces.append(raw[p:a])
            pieces.append(
                repl(self._make_match(raw, a, b)) if callable(repl) else repl
            )
            p = b
            n += 1
        pieces.append(raw[p:])
        return b"".join(pieces), n

    def findall(self, data) -> list[bytes]:
        raw = bytes(_as_streams(data)[0])
        return [raw[a:b] for a, b in self.finditer(data)]

    def findall_ends(self, data) -> np.ndarray:
        """Byte offsets at which a match ends (just past its last byte, as
        ``re.Match.end()``)."""
        stream = _as_streams(data)[0]
        ends = self._scan_match_positions(stream)
        if (self.include_final_match and len(stream)
                and self._accept_eof[self._last_final]):
            ends = np.concatenate([ends, [len(stream)]])
        return ends


def _starts_from_reverse(rm: DfaMatcher, stream: np.ndarray) -> np.ndarray:
    """Ascending candidate match starts from one backward device pass of
    the reversed-pattern matcher ``rm`` (shared by
    ``DfaMatcher._match_starts`` and the host matcher's envelope
    prefilter). The reverse engine reports accept at reversed position p
    (the state before byte p of the reversed stream), which is a reverse
    match over reversed bytes [.., p): an original start l - p. p = 0 is
    start l, which the backward pass cannot see; the reverse matcher's
    end-of-stream accept (read on ``rm``) is start 0."""
    l = len(stream)
    pos = rm._scan_match_positions(stream, reverse=True)
    starts = (l - pos[pos > 0])[::-1]  # ascending, unique
    if rm._accept_eof[rm._last_final]:
        starts = np.concatenate([np.zeros(1, np.int64), starts])
    return starts


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
        """Token-start byte offsets for ``text``: the tokenizer DFA's flags
        as ``models.tokenizer_dfa.boundaries_from_flags`` reads them, each
        walked back to its character's first byte in UTF-8 mode."""
        with trace("rf.api.presplit"):
            stream = _as_streams(text)[0]
            n = len(stream)
            if n == 0:
                return np.zeros(0, dtype=np.int64)
            # an accept bit at byte i marks a token start at byte i - 1, byte 0
            # always starts one, and an accepting final state marks byte n - 1.
            # The compacted positions are ascending and distinct, so the
            # offsets follow without rebuilding the mask or sorting
            # (boundaries_from_flags does both, in Python lists: seconds at
            # 16 MiB).
            pos = self._scan_match_positions(stream)
            starts = pos[np.searchsorted(pos, 1):] - 1
            final = bool(self._accept_eof[self._last_final]) and n > 1
            tail = np.full(1 if final else 0, n - 1, np.int64)
            starts = np.concatenate([starts, tail])
            if getattr(self.tok, "utf8", False):
                # a flag sits on the last byte of a token's first character:
                # step back over its continuation bytes (at most three)
                for _ in range(3):
                    cont = (stream[starts] & 0xC0) == 0x80
                    if not cont.any():
                        break
                    starts[cont] -= 1
            head = np.zeros(0 if len(starts) and starts[0] == 0 else 1,
                            np.int64)
            return np.concatenate([head, starts])

    def pieces(self, text: bytes) -> list[bytes]:
        starts = self.presplit(text).tolist()
        return [text[a:b] for a, b in zip(starts, starts[1:] + [len(text)])]


_UNSET = object()


def _dead_dfa() -> CompiledDfa:
    """The 2-state all-dead automaton under the host matchers: it fills the
    base class's tables, and no device entry point ever scans it."""
    return CompiledDfa(table=np.ones((256, 2), dtype=np.int32),
                       accept=np.zeros(2, dtype=bool), start=0, dead=1)


class HostRegexMatcher(DfaMatcher):
    """Matcher for patterns with ``\\b``/``\\B`` word boundaries, ``(?m)``
    line anchors or lazy quantifiers.

    A boundary is not expressible in the streaming DFA engines, whose accept
    is a function of the state at a position alone: a trailing ``\\b`` needs
    the next byte. Span search therefore runs in two stages:

    1. **device prefilter**: the assertion-stripped envelope DFA (a superset
       language) is scanned backward on the device, as
       ``DfaMatcher.finditer``'s reversed pass, and yields every candidate
       match start;
    2. **host verify**: the Pike VM (``models/captures.py``) checks the
       assertions at those candidates only, with the same POSIX
       leftmost-longest spans as the device path (leftmost-first for lazy
       quantifiers, as Python ``re``).

    Patterns whose envelope is nullable (a bare ``\\b``) or does not compile
    take the pure host walk. The device-throughput APIs (``scan``,
    ``count``, ``stream_scanner``, ``findall_ends``) raise, and so does
    every internal device entry point of the base class.
    """

    def __init__(self, pattern: str | bytes,
                 config: EngineConfig = DEFAULT_CONFIG, device=None):
        super().__init__(_dead_dfa(), config, device)
        pp = parse_pattern(pattern)
        self._prog = CaptureProgram(pp)
        #: lazy quantifiers switch spans to leftmost-first (Python ``re``);
        #: otherwise POSIX leftmost-longest, as the device engines
        self._first_mode = contains_lazy(pp.node)
        self._finditer_source = (pattern, 0, config)
        self._capture_prog = self._prog if self._prog.num_groups else False
        self._envelope = _UNSET  # reversed envelope matcher, or None

    def _ensure_envelope(self):
        """The reversed assertion-stripped envelope matcher of the device
        prefilter, built at first use; None when it cannot prune (nullable)
        or does not compile (state blowup)."""
        if self._envelope is _UNSET:
            pattern = self._finditer_source[0]
            env = None
            if not nullable(strip_assertions(parse_pattern(pattern).node)):
                try:
                    rev = compile_pattern(pattern, anchored=False,
                                          reverse=True, strip=True)
                except (RegexError, DfaBlowupError):
                    rev = None
                if rev is not None:
                    env = DfaMatcher(rev, self.config, self.device)
            self._envelope = env
        return self._envelope

    def _candidate_starts(self, stream: np.ndarray) -> np.ndarray | None:
        """Ascending candidate match starts from the device envelope scan (a
        superset of the true starts), or None without an envelope."""
        env = self._ensure_envelope()
        if env is None or len(stream) == 0:
            return None
        return _starts_from_reverse(env, stream)

    def _no_device(self, name: str):
        raise NotImplementedError(
            f"{name}() runs on the streaming DFA engines, which cannot "
            "express \\b/\\B, (?m) anchors or lazy quantifiers (accept would "
            "depend on the next byte); use search/match/fullmatch/finditer/"
            "findall/split/sub, or drop the assertion for device-rate "
            "scanning"
        )

    def scan(self, data, collect_positions: bool = False):
        self._no_device("scan")

    def count(self, data):
        self._no_device("count")

    def stream_scanner(self, resume: dict | None = None):
        self._no_device("stream_scanner")

    def findall_ends(self, data):
        self._no_device("findall_ends")

    # every internal device entry point fails loudly too: the dead 2-state
    # automaton must never be scanned silently
    def _kgram(self):
        self._no_device("_kgram")

    def _scan_stream(self, stream):
        self._no_device("_scan_stream")

    def _mask_chunk_device(self, raw_chunk, cur, reverse=False):
        self._no_device("_mask_chunk_device")

    def _scan_match_positions(self, stream, reverse=False):
        self._no_device("_scan_match_positions")

    def _scan_match_states(self, stream):
        self._no_device("_scan_match_states")

    def _scan_stream_counts(self, stream, start=None):
        self._no_device("_scan_stream_counts")

    def _scan_batch_counts(self, arr):
        self._no_device("_scan_batch_counts")

    def _scan_ragged_counts(self, streams):
        self._no_device("_scan_ragged_counts")

    def _anchored_longest_end(self, stream, s0: int) -> int:
        # the base span helpers must not read the dead anchored tables
        return (self._prog.first_end_at(bytes(stream), s0) if self._first_mode
                else self._prog.longest_end_at(bytes(stream), s0))

    def finditer(self, data, limit: int | None = None,
                 pos: int = 0, endpos: int | None = None
                 ) -> list[tuple[int, int]]:
        raw, pos, ok = self._clip(bytes(_as_streams(data)[0]), pos, endpos)
        if not ok or (pos and self._pattern_start_anchored()):
            return []
        stream = np.frombuffer(raw, dtype=np.uint8)
        starts = self._candidate_starts(stream)
        if starts is None:  # nullable or uncompilable envelope: pure host
            if self._first_mode:
                return self._prog.finditer_spans_first(raw, limit,
                                                       start_at=pos)
            return self._prog.finditer_spans(raw, limit, start_at=pos)
        # the Pike VM verifies only the device's candidates. The candidates
        # are a superset of the true starts, and both walks take the
        # leftmost matching start, then the longest (or lazy-first) end,
        # without overlap; a non-nullable envelope cannot match empty.
        end_at = (self._prog.first_end_at if self._first_mode
                  else self._prog.longest_end_at)
        spans: list[tuple[int, int]] = []
        p = pos  # assertion context before pos stays visible (re's rule)
        for s0 in starts.tolist():
            if s0 < p:
                continue
            end = end_at(raw, s0)
            if end >= 0:
                spans.append((s0, end))
                if limit is not None and len(spans) >= limit:
                    return spans
                p = max(end, s0 + 1)
        return spans

    def finditer_arrays(self, data) -> np.ndarray:
        return np.asarray(self.finditer(data), dtype=np.int64).reshape(-1, 2)

    def search(self, data, pos: int = 0, endpos: int | None = None
               ) -> Match | None:
        # pos is native here: the Pike VM keeps the context before pos
        raw, pos, ok = self._clip(bytes(_as_streams(data)[0]), pos, endpos)
        if not ok:
            return None
        spans = self.finditer(raw, limit=1, pos=pos)
        if not spans:
            return None
        a, b = spans[0]
        return _stamp_pos(self._make_match(raw, a, b), pos)

    def match(self, data, pos: int = 0, endpos: int | None = None
              ) -> Match | None:
        raw, pos, ok = self._clip(bytes(_as_streams(data)[0]), pos, endpos)
        if not ok or (pos and self._pattern_start_anchored()):
            return None
        end = self._anchored_longest_end(raw, pos)
        return None if end < 0 else _stamp_pos(
            self._make_match(raw, pos, end), pos)

    def fullmatch(self, data, pos: int = 0, endpos: int | None = None
                  ) -> Match | None:
        raw, pos, ok = self._clip(bytes(_as_streams(data)[0]), pos, endpos)
        if not ok or (pos and self._pattern_start_anchored()):
            return None
        if self._prog.longest_end_at(raw, pos) == len(raw):
            return _stamp_pos(self._make_match(raw, pos, len(raw)), pos)
        return None


class HostBacktrackMatcher(HostRegexMatcher):
    """Matcher for patterns with backreferences, lookaround or conditionals.

    None of them fits the device engines (backreferences are not regular;
    lookaround reads bytes past the position) nor the tagged Pike VM, whose
    thread merge assumes that the future depends only on (state, position).
    These patterns run the host backtracking engine (``models/backtrack.py``)
    with Python ``re`` semantics end to end: leftmost-first spans, greedy and
    lazy backtracking order, fixed-width lookbehind, captures kept out of a
    positive lookahead. The device-throughput APIs raise, as for
    ``HostRegexMatcher``; there is no device prefilter."""

    def __init__(self, pattern: str | bytes,
                 config: EngineConfig = DEFAULT_CONFIG,
                 max_steps: int | None = None, device=None):
        DfaMatcher.__init__(self, _dead_dfa(), config, device)
        #: ``max_steps``: an opt-in budget of backtracking steps per search
        #: or match (None: unlimited, as ``re``); exceeding it raises
        #: ``models.backtrack.BacktrackLimitExceeded``
        self._bt = BacktrackProgram(parse_pattern(pattern),
                                    max_steps=max_steps)
        self._finditer_source = (pattern, 0, config)
        self._capture_prog = False  # groups come from the engine itself

    @property
    def num_groups(self) -> int:
        return self._bt.num_groups

    def _make_match(self, raw: bytes, a: int, b: int) -> Match:
        m = self._bt.match_at(raw, a)
        if (m is None or m[0] != b) and b > a:
            # the span may come from Python 3.7+'s empty-match rule
            # (finditer resumes at an empty match's end with the empty
            # match there refused); an unbanned re-run can prefer the empty
            # match, so re-run with it banned to get the groups of the span
            # that was emitted
            m = self._bt.match_at(raw, a, ban_empty=True)
        if m is None or m[0] != b:
            return Match(raw, a, b)
        _, groups, lastindex = m
        return Match(raw, a, b, groups[1:], self._bt.group_names, lastindex)

    def search(self, data, pos: int = 0, endpos: int | None = None
               ) -> Match | None:
        # pos is native: the backtracker keeps lookbehind context
        raw, pos, ok = self._clip(bytes(_as_streams(data)[0]), pos, endpos)
        if not ok:
            return None
        m = self._bt.search_spans(raw, pos)
        if m is None:
            return None
        groups, lastindex = m[2], m[3]
        return _stamp_pos(
            Match(raw, m[0], m[1], groups[1:], self._bt.group_names,
                  lastindex), pos)

    def finditer(self, data, limit: int | None = None,
                 pos: int = 0, endpos: int | None = None
                 ) -> list[tuple[int, int]]:
        # Python 3.7+'s empty-match rule (as BacktrackProgram.finditer_spans):
        # resume at an empty match's end with only the empty match there
        # refused
        raw, start, ok = self._clip(bytes(_as_streams(data)[0]), pos,
                                    endpos)
        if not ok:
            return []
        spans: list[tuple[int, int]] = []
        pos, ban, n = start, -1, len(raw)
        while pos <= n:
            m = self._bt.search_spans(raw, pos, ban_empty_at=ban)
            if m is None:
                break
            s, e = m[0], m[1]
            spans.append((s, e))
            if limit is not None and len(spans) >= limit:
                break
            if self._bt.pp.start_anchored:
                break
            pos = e
            ban = e if s == e else -1
            if s == e and e == n:
                break
        return spans

    def match(self, data, pos: int = 0, endpos: int | None = None
              ) -> Match | None:
        return self._anchored_match(data, pos, endpos, full=False)

    def fullmatch(self, data, pos: int = 0, endpos: int | None = None
                  ) -> Match | None:
        return self._anchored_match(data, pos, endpos, full=True)

    def _anchored_match(self, data, pos, endpos, full: bool) -> Match | None:
        raw, pos, ok = self._clip(bytes(_as_streams(data)[0]), pos, endpos)
        if not ok or (pos and self._bt.pp.start_anchored):
            return None
        m = self._bt.match_at(raw, pos, full=full)
        if m is None:
            return None
        end, groups, lastindex = m
        return _stamp_pos(
            Match(raw, pos, end, groups[1:], self._bt.group_names,
                  lastindex), pos)

    def _anchored_longest_end(self, stream, s0: int) -> int:
        m = self._bt.match_at(bytes(stream), s0)
        return -1 if m is None else m[0]


def compile_regex(pattern: str | bytes, anchored: bool = False,
                  max_states: int = 100_000,
                  config: EngineConfig = DEFAULT_CONFIG,
                  max_steps: int | None = None,
                  device=None) -> DfaMatcher:
    """Compile a pattern to the fast DFA engine. Default is scanning
    (unanchored) mode: a match is reported wherever it ends in the stream.
    The matcher also gives leftmost-longest spans (``finditer``, ``search``,
    ``findall``, ...) through a reversed-pattern backward scan.

    Patterns with ``\\b``/``\\B``, ``(?m)`` anchors or lazy quantifiers
    return a ``HostRegexMatcher``; patterns with backreferences, lookaround
    or conditionals ``(?(id)yes|no)`` a ``HostBacktrackMatcher``, whose
    opt-in ``max_steps`` bounds catastrophic backtracking (the linear-time
    engines ignore it)."""
    node = parse_pattern(pattern).node
    if contains_backtrack(node):
        return HostBacktrackMatcher(pattern, config, max_steps=max_steps,
                                    device=device)
    if contains_bound(node) or contains_lazy(node):
        return HostRegexMatcher(pattern, config, device)
    dfa = compile_pattern(pattern, max_states=max_states, anchored=anchored)
    m = DfaMatcher(dfa, config, device)
    # the reversed and anchored automata of span extraction compile at
    # first use
    m._finditer_source = (pattern, max_states, config)
    return m


def compile_tokenizer(pattern: str = GPT2_PRESPLIT,
                      config: EngineConfig = DEFAULT_CONFIG,
                      device=None, *, utf8: bool = False) -> TokenizerMatcher:
    """A pre-split matcher for ``pattern`` (``utf8=True``: over UTF-8
    characters, alternatives leftmost-first, as ``build_tokenizer_dfa``
    says; off, it builds as it always has). The automaton's build is an
    ``rf.compile.tokenizer`` span."""
    with trace("rf.compile.tokenizer"):
        tok = build_tokenizer_dfa(pattern, utf8=utf8)
    return TokenizerMatcher(tok, config, device)


@dataclasses.dataclass
class LiteralReport:
    """Per-pattern occurrence counts (streams x patterns) and the per-state
    report under them."""

    pattern_counts: np.ndarray  # (num_streams, num_patterns) int64
    report: ScanReport

    def histogram(self, stream: int = 0) -> dict[int, int]:
        row = self.pattern_counts[stream]
        return {int(i): int(c) for i, c in enumerate(row) if c}


class LiteralSetMatcher(DfaMatcher):
    """Multi-literal (Aho-Corasick) matcher on the fast DFA engines.

    Reports every occurrence of every literal, overlapping and nested
    included (Snort content-match semantics), unlike the regex path's
    non-overlapping leftmost-longest spans. ``scan``/``count`` count
    match-ending positions; ``scan_patterns`` folds them into exact
    per-pattern totals through the automaton's output sets."""

    def __init__(self, ac, config: EngineConfig = DEFAULT_CONFIG, device=None):
        super().__init__(ac.dfa, config, device)
        self.ac = ac
        # the output sets as (state, pattern) pairs on the device, for the
        # fold of per-state counts into per-pattern counts
        sizes = np.diff(ac.out_indptr)
        self._out_states = torch.as_tensor(
            np.repeat(np.arange(len(sizes), dtype=np.int32), sizes),
            device=self.device)
        self._out_patterns = torch.as_tensor(ac.out_indices.astype(np.int32),
                                             device=self.device)

    @property
    def num_patterns(self) -> int:
        return len(self.ac.patterns)

    def _fold(self, counts: torch.Tensor) -> torch.Tensor:
        """Per-state counts (..., S) -> per-pattern counts (..., P) of the
        same dtype and device: each state's count added to every pattern of
        its output set (a gather over the output CSR and a scatter-add);
        ``AhoCorasick.pattern_counts`` is the host's loop."""
        with trace("rf.engine.pattern_fold"):
            dim = counts.dim() - 1
            out = counts.new_zeros((*counts.shape[:-1], self.num_patterns))
            return out.index_add_(dim, self._out_patterns,
                                  counts.index_select(dim, self._out_states))

    def scan_patterns(self, data) -> LiteralReport:
        rep = self.scan(data)
        counts = self._fold(torch.as_tensor(rep.counts, device=self.device))
        return LiteralReport(pattern_counts=counts.cpu().numpy(), report=rep)

    def count_patterns(self, data) -> np.ndarray:
        """(P,) int64: the occurrences of every pattern in ``data`` (one
        stream, or the sum over several), overlapping and nested ones
        included, in pattern order; a duplicate pattern counts under each
        of its ids. Equals ``scan_patterns(data).pattern_counts.sum(0)``.
        Each chunk's per-state histogram stays on the device: K2's counts
        are folded there and the pattern counts ride in the read that
        carries the chunk's verdict and final state, so a chunk whose
        speculation verifies makes one host wait. A scan that the engine
        router sends to the host walker folds as ``scan_patterns`` does."""
        with trace("rf.api.count_patterns"):
            streams = _as_streams(data)
            if streams and self._host_backend(
                    len(streams), sum(len(s_) for s_ in streams)):
                return self.scan_patterns(streams).pattern_counts.sum(0)
            total = None  # the first chunk's counts, then the sum in place
            cb = self.config.chunk_bytes
            for stream in streams:
                if len(stream) == 0:
                    continue
                cur = self.start
                for off in range(0, len(stream), cb):
                    ch = self._scan_chunk(stream[off : off + cb], cur, "counts",
                                          fold=self._fold)
                    if total is None:
                        total = ch.counts
                    else:
                        total += ch.counts
                    cur = ch.final_state
                if self.include_final_match and bool(self._accept_eof[cur]):
                    ptr = self.ac.out_indptr
                    total[self.ac.out_indices[ptr[cur] : ptr[cur + 1]]] += 1
            if total is None:
                return np.zeros(self.num_patterns, dtype=np.int64)
            return total

    def finditer(self, data, limit: int | None = None,
                 pos: int = 0, endpos: int | None = None):
        """All (start, end, pattern_id) occurrences, by end, overlapping
        ones included. ``pos``/``endpos`` follow ``re`` (a span lies wholly
        inside ``[pos, endpos)``; literals carry no context, so scanning the
        suffix and shifting is exact). The ends and the state at each come
        from the device (``_scan_match_states``)."""
        if pos or endpos is not None:
            raw, pos, ok = self._clip(bytes(_as_streams(data)[0]), pos,
                                      endpos)
            if not ok:
                return []
            return [(a + pos, b + pos, pid)
                    for a, b, pid in self.finditer(raw[pos:], limit)]
        stream = _as_streams(data)[0]
        if len(stream) == 0:
            return []
        ends, states = self._scan_match_states(stream)
        ends, states = ends.tolist(), states.tolist()
        if self._accept_eof[self._last_final]:
            ends.append(len(stream))
            states.append(self._last_final)
        spans: list[tuple[int, int, int]] = []
        outputs, patterns = self.ac.outputs, self.ac.patterns
        for e, st in zip(ends, states):
            for pid in outputs[st]:
                spans.append((e - len(patterns[pid]), e, pid))
                if limit is not None and len(spans) >= limit:
                    return spans
        return spans

    def findall(self, data) -> list[bytes]:
        raw = bytes(_as_streams(data)[0])
        return [raw[a:b] for a, b, _ in self.finditer(raw)]

    def search(self, data, pos: int = 0, endpos: int | None = None
               ) -> Match | None:
        """Earliest-ending occurrence of any literal, or None."""
        raw, pos, ok = self._clip(bytes(_as_streams(data)[0]), pos, endpos)
        if not ok:
            return None
        hits = self.finditer(raw, limit=1, pos=pos)
        if not hits:
            return None
        a, b, _ = hits[0]
        return _stamp_pos(Match(raw, a, b), pos)

    def match(self, data) -> Match | None:
        """Longest literal that is a prefix of the stream, or None."""
        raw = bytes(_as_streams(data)[0])
        best = -1
        for p in self.ac.patterns:
            if len(p) > best and raw.startswith(p):
                best = len(p)
        return Match(raw, 0, best) if best >= 0 else None

    def fullmatch(self, data) -> Match | None:
        raw = bytes(_as_streams(data)[0])
        return Match(raw, 0, len(raw)) if raw in self.ac.patterns else None


def compile_literals(patterns, config: EngineConfig = DEFAULT_CONFIG,
                     device=None) -> LiteralSetMatcher:
    """Compile a set of literal byte strings (Aho-Corasick) into one dense
    DFA on the fast engines, with per-pattern occurrence counts."""
    with trace("rf.compile.literals"):
        return LiteralSetMatcher(build_aho_corasick(patterns), config, device)


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


# ------------------------------------------------------------- rule sets


@dataclasses.dataclass
class RuleSetReport:
    """Per-rule match counts (streams x rules) and the per-state report
    under them. ``report`` is None for a mixed anchored/unanchored set: it
    scans as two CSR partitions whose state spaces do not line up, so only
    the per-rule counts mean anything there."""

    rule_counts: np.ndarray  # (num_streams, num_rules) int64
    report: ScanReport | None

    def histogram(self, stream: int = 0) -> dict[int, int]:
        row = self.rule_counts[stream]
        return {int(i): int(c) for i, c in enumerate(row) if c}


class RuleSetMatcher:
    """Multi-rule matcher: a set of regexes compiled into CSR NFA(s) of the
    reference's convention and scanned by the bit-exact NFA engine
    (``NfaMatcher``, any strategy, on ``device``), with per-rule counts.

    Anchored (``^``) and unanchored rules cannot share one CSR hub (the
    always-active hub would fire anchored rules again at every byte), so a
    mixed set compiles into two partitions scanned one after the other;
    counts merge by rule index. A pure set stays one automaton and can be
    written as a ``.coe`` image."""

    def __init__(self, patterns, config: EngineConfig = DEFAULT_CONFIG,
                 strategy: str = "lazy", device=None):
        self.patterns = list(patterns)
        flags = [parse_pattern(p).start_anchored for p in self.patterns]
        #: (rule indices, owner, NfaMatcher) per partition
        self._parts = []
        for anchored in (False, True):
            idx = [i for i, a in enumerate(flags) if a == anchored]
            if idx:
                aut, owner = regexes_to_csr([self.patterns[i] for i in idx])
                self._parts.append(
                    (idx, owner, NfaMatcher(aut, config, strategy, device)))
        if len(self._parts) == 1:
            self.owner = self._parts[0][1]
            self.matcher = self._parts[0][2]
            self.automaton = self.matcher.automaton
        else:
            self.owner = self.matcher = self.automaton = None

    @property
    def num_rules(self) -> int:
        return len(self.patterns)

    def scan(self, data) -> RuleSetReport:
        streams = _as_streams(data)
        per = np.zeros((len(streams), self.num_rules), np.int64)
        rep = None
        for idx, owner, matcher in self._parts:
            rep = matcher.scan(streams)
            for k, i in enumerate(idx):
                per[:, i] = rep.counts[:, owner == k].sum(axis=1)
        return RuleSetReport(rule_counts=per,
                             report=rep if len(self._parts) == 1 else None)

    def export_coe(self, path: str) -> None:
        """Write the rule set as a ``.coe`` image the reference loads."""
        if self.automaton is None:
            raise ValueError(
                "mixed anchored/unanchored rulesets compile to two CSR "
                "partitions and have no single .coe image; export pure "
                "subsets separately"
            )
        write_coe(path, self.automaton.to_words())


def compile_regex_set(patterns, config: EngineConfig = DEFAULT_CONFIG,
                      strategy: str = "lazy", device=None) -> RuleSetMatcher:
    """Compile a list of patterns into one multi-rule NFA rule set with
    per-rule match counts (IDS style)."""
    return RuleSetMatcher(patterns, config, strategy, device)


class PrefilteredRuleSet:
    """Literal-prefiltered regex-set matcher (Hyperscan style).

    Each pattern with a ``required_literal`` (a byte string in every match,
    ``models/regex.py``) is guarded by one Aho-Corasick prefilter scanned on
    the fast DFA engines; a stream pays for the NFA rule set only over the
    rules whose literals it holds (and the rules without a usable literal).
    Counts equal ``compile_regex_set(...).scan(...)``: a stream without a
    rule's required literal cannot match that rule. Sub-rule-sets compile at
    first use and are cached per candidate subset, up to
    ``max_cached_subsets``; past it the full rule set answers."""

    def __init__(self, patterns, config: EngineConfig = DEFAULT_CONFIG,
                 strategy: str = "lazy", min_literal: int = 3, device=None):
        self.patterns = list(patterns)
        self.config = config
        self.strategy = strategy
        self.device = resolve_device(device)
        lits: list[bytes] = []
        self._lit_owner: list[int] = []
        self.always_check: list[int] = []
        for i, p in enumerate(self.patterns):
            lit = required_literal(parse_pattern(p).node)
            if lit is not None and len(lit) >= min_literal:
                lits.append(lit)
                self._lit_owner.append(i)
            else:
                self.always_check.append(i)
        self._ac = (compile_literals(lits, config, self.device) if lits
                    else None)
        #: bounded subset cache: diverse traffic could otherwise drive up to
        #: 2^num_prefiltered compiles; past the cap the full rule set (one
        #: compile, always sound) answers instead of evicting into thrash
        self._subs: dict[tuple, RuleSetMatcher] = {}
        self.max_cached_subsets = 64
        self._full: RuleSetMatcher | None = None

    @property
    def num_rules(self) -> int:
        return len(self.patterns)

    @property
    def num_prefiltered(self) -> int:
        return len(self._lit_owner)

    def _sub(self, subset: tuple) -> tuple[RuleSetMatcher, tuple]:
        """The matcher of a candidate subset and the rule indices it
        reports; past the cache cap, the full rule set's (scanning more
        rules is sound; the caller slices the counts)."""
        m = self._subs.get(subset)
        if m is not None:
            return m, subset
        if len(self._subs) < self.max_cached_subsets:
            m = RuleSetMatcher([self.patterns[i] for i in subset],
                               self.config, self.strategy, self.device)
            self._subs[subset] = m
            return m, subset
        if self._full is None:
            self._full = RuleSetMatcher(self.patterns, self.config,
                                        self.strategy, self.device)
        return self._full, tuple(range(self.num_rules))

    def scan(self, data) -> RuleSetReport:
        streams = _as_streams(data)
        per = np.zeros((len(streams), self.num_rules), np.int64)
        # one device pass of the literal set over every stream decides the
        # candidates
        lit_hits = (self._ac.scan_patterns(streams).pattern_counts
                    if self._ac is not None
                    else np.zeros((len(streams), 0), np.int64))
        groups: dict[tuple, list[int]] = {}
        for s, row in enumerate(lit_hits):
            cand = sorted(self.always_check
                          + [self._lit_owner[j] for j in np.nonzero(row)[0]])
            groups.setdefault(tuple(cand), []).append(s)
        for subset, members in groups.items():
            if not subset:
                continue
            m, scanned = self._sub(subset)
            rep = m.scan([streams[s] for s in members])
            cols = list(subset)
            for k, s in enumerate(members):
                per[s, cols] = (rep.rule_counts[k] if scanned == subset
                                else rep.rule_counts[k][cols])
        report = ScanReport(
            counts=np.zeros((len(streams), 0), np.int64),
            total=int(per.sum()), match_positions=None,
            metrics=RunMetrics(
                engine=f"prefiltered-{self.strategy}",
                bytes_scanned=sum(len(s) for s in streams),
                streams=len(streams), matches=int(per.sum()),
                wall_seconds=0.0,
            ),
        )
        return RuleSetReport(rule_counts=per, report=report)


def compile_regex_set_prefiltered(
    patterns, config: EngineConfig = DEFAULT_CONFIG, strategy: str = "lazy",
    min_literal: int = 3, device=None,
) -> PrefilteredRuleSet:
    """Literal-prefiltered ``compile_regex_set``: the same counts, with the
    streams that cannot match rejected at device rate."""
    return PrefilteredRuleSet(patterns, config, strategy, min_literal, device)


# ---------------------------------------------------------------- Snort


@dataclasses.dataclass
class SnortAlert:
    rule_index: int
    sid: int | None
    msg: str
    pcre_checked: bool  # False = content-verified only (pcre outside subset)


@dataclasses.dataclass
class SnortReport:
    """Per-stream alert lists + the device-side prefilter counts."""

    alerts: list  # per stream: list[SnortAlert]
    prefilter_candidates: list  # per stream: list[int] rule indices
    content_report: "LiteralReport | None"

    def sids(self, stream: int = 0) -> list[int]:
        return [a.sid for a in self.alerts[stream] if a.sid is not None]


#: byte_test comparison operators (Snort: ``&``/``^`` are true when the
#: bitwise result is non-zero)
_BYTE_OPS = {
    "<": lambda v, x: v < x,
    ">": lambda v, x: v > x,
    "=": lambda v, x: v == x,
    "<=": lambda v, x: v <= x,
    ">=": lambda v, x: v >= x,
    "&": lambda v, x: (v & x) != 0,
    "^": lambda v, x: (v ^ x) != 0,
}


def _byte_convert(raw: bytes, pos: int, op) -> tuple[int, int] | None:
    """Read + convert ``op.count`` bytes at ``pos`` per byte_test/byte_jump
    conversion rules: binary big/little endian, or ``string`` (ASCII
    digits in ``op.base``, ``strtoul``-style — leading spaces and an
    optional sign, stop at the first non-digit; no digits = fail).
    Returns (value, read_end) or None when the read falls outside the
    payload."""
    n = len(raw)
    if op.string:
        if pos < 0 or pos >= n:
            return None
        end = min(pos + op.count, n)
        i = pos
        while i < end and raw[i] in b" \t":
            i += 1
        sign = 1
        if i < end and raw[i] in b"+-":
            sign = -1 if raw[i] == 0x2D else 1
            i += 1
        v, start_digits = 0, i
        while i < end:
            try:
                d = int(chr(raw[i]), op.base)
            except ValueError:
                break
            v = v * op.base + d
            i += 1
        if i == start_digits:
            return None
        return sign * v, end
    if pos < 0 or pos + op.count > n:
        return None
    return int.from_bytes(raw[pos : pos + op.count], op.endian), pos + op.count


def _apply_bitmask(v: int, mask: int) -> int:
    """AND with ``mask`` then right-shift by its trailing zero count
    (Snort bitmask semantics)."""
    v &= mask
    return v >> ((mask & -mask).bit_length() - 1)


#: rule options the pipeline ENFORCES (affect matching and are applied).
#: ``rawbytes`` is enforced AS A NO-OP: it pins inspection to the raw
#: (undecoded) payload, which is exactly and only what this stream
#: scanner inspects.
_MATCH_ENFORCED_OPTS = frozenset({
    "content", "nocase", "offset", "depth", "distance", "within", "pcre",
    "byte_test", "byte_jump", "byte_extract", "isdataat", "rawbytes",
    # HTTP sticky buffers (conservative verbatim carve, models/http.py);
    # byte ops chained relative to a buffered content are NOT enforced
    # (dropped at parse, flagged via the byte-op counts)
    "http_uri", "http_raw_uri", "http_method", "http_header",
    "http_raw_header", "http_client_body", "http_cookie",
    "http_raw_cookie",
    "dsize",  # payload-size predicate (inclusive bounds, Snort 2.9 rules)
    "urilen",  # URI-length predicate (normalized by default, ",raw" raw)
})
#: options that do not constrain MATCHING on a payload stream (labels,
#: bookkeeping, performance hints) — a rule carrying only these +
#: enforced options is fully enforced.  Plain ``fast_pattern`` only
#: selects which content seeds the engine's own prefilter (ours uses ALL
#: non-negated contents, a strict superset); the ``fast_pattern:only``
#: FORM changes matching (MPSE-only, case-insensitive) and is classified
#: unenforced in ``enforcement_report``.
_METADATA_OPTS = frozenset({
    "msg", "sid", "rev", "gid", "classtype", "reference", "metadata",
    "priority", "service", "rem", "target", "fast_pattern",
})
#: session-scope predicates: constrain WHICH stream/direction the rule
#: applies to (like the header's addresses/ports), not what the payload
#: must contain — a single-payload matcher can't evaluate them and Snort
#: wouldn't either without the TCP/session context.  Reported per rule
#: as ``scope_options`` (visible, not silently ignored) but not counted
#: against payload-level enforcement.  ``flowbits`` is NOT here: isset/
#: set gate alerting across packets, so ignoring them would change
#: match output (they classify as partial).
_SCOPE_OPTS = frozenset({"flow"})


class SnortMatcher:
    """Snort-rules scanner: device AC prefilter + host per-rule verify.

    Stage 1 runs every rule's content literals through the literal engines
    on ``device`` (one automaton for case-sensitive contents, one over the
    case-folded stream for ``nocase`` ones; the whole batch of payloads in
    one ``scan_patterns`` call each, which is K2 with a histogram row per
    payload on a card); only rules whose non-negated
    contents ALL occur — the same multi-pattern prefilter architecture
    Snort uses — reach stage 2, which checks ordered occurrence WITH the
    positional modifiers ``offset``/``depth``/``distance``/``within``
    enforced (backtracking across occurrences), negated-content absence
    (stream-wide, or window-scoped when positionally constrained),
    ``byte_test``/``byte_jump`` span arithmetic (binary/string
    conversion, relative anchoring, bitmask/multiplier/align — the
    verify-program walk in ``_verify``), and the rule's ``pcre`` via the
    framework's own DFA compiler (``models/snort.py`` documents the
    supported subset).  ``enforcement_report()`` classifies every rule as
    fully enforced vs partially (content/pcre-only) verified. Stage 2,
    the normalized-URI automata and the pcre check run on the host."""

    def __init__(self, rules, config: EngineConfig = DEFAULT_CONFIG,
                 device=None):
        self.rules = list(rules)
        self.config = config
        self.device = resolve_device(device)
        # dedupe content literals across rules, split by case sensitivity;
        # uri-buffered contents get their OWN automata scanned over the
        # normalized URI (their decoded form need not occur literally in
        # the raw stream — "/%61dmin" normalizes to "/admin" — so they
        # cannot gate the raw-stream prefilter; without any gate every
        # http_uri rule would reach _verify on every payload)
        exact: dict[bytes, int] = {}
        fold: dict[bytes, int] = {}
        uri_exact: dict[bytes, int] = {}
        uri_fold: dict[bytes, int] = {}
        self._rule_contents: list[list[tuple[str, int, bool]]] = []
        for r in self.rules:
            entries = []
            for c in r.contents:
                if c.negated and (
                    c.offset is not None or c.depth is not None
                    or c.distance is not None or c.within is not None
                    or c.buffer is not None
                ):
                    # windowed (or buffer-scoped) negation asserts absence
                    # only INSIDE its window/buffer — stream-wide presence
                    # must not prefilter the rule away; _verify alone
                    # enforces it
                    continue
                if c.buffer == "uri":
                    if c.nocase:
                        pid = uri_fold.setdefault(c.pattern.lower(),
                                                  len(uri_fold))
                        entries.append(("uri_fold", pid, c.negated))
                    else:
                        pid = uri_exact.setdefault(c.pattern,
                                                   len(uri_exact))
                        entries.append(("uri_exact", pid, c.negated))
                    continue
                if c.nocase:
                    key = c.pattern.lower()
                    pid = fold.setdefault(key, len(fold))
                    entries.append(("fold", pid, c.negated))
                else:
                    pid = exact.setdefault(c.pattern, len(exact))
                    entries.append(("exact", pid, c.negated))
            self._rule_contents.append(entries)
        self._exact = (compile_literals(list(exact), config, self.device)
                       if exact else None)
        self._fold = (compile_literals(list(fold), config, self.device)
                      if fold else None)
        # normalized-URI prefilter automata: URIs are tens of bytes, so
        # these are walked host-side per carved request (models/literals
        # AC; the walk is O(len(uri)))
        self._uri_exact = (build_aho_corasick(list(uri_exact))
                           if uri_exact else None)
        self._uri_fold = (build_aho_corasick(list(uri_fold))
                          if uri_fold else None)
        # vectorized gate arrays: a per-rule Python entry loop costs
        # n_rules x n_payloads steps; one fancy-indexed compare per
        # automaton replaces it
        self._gate: dict[str, tuple] = {}
        for kind in ("exact", "fold", "uri_exact", "uri_fold"):
            rows, pids, negs = [], [], []
            for ri, entries in enumerate(self._rule_contents):
                for k, pid, neg in entries:
                    if k == kind:
                        rows.append(ri)
                        pids.append(pid)
                        negs.append(neg)
            if rows:
                self._gate[kind] = (np.asarray(rows), np.asarray(pids),
                                    np.asarray(negs, dtype=bool))
        self._lower_lut = np.arange(256, dtype=np.uint8)
        self._lower_lut[ord("A"):ord("Z") + 1] += 32
        self._pcre_cache: dict[int, tuple | None] = {}
        self._pcre_by_text: dict[str, tuple | None] = {}

    @property
    def num_rules(self) -> int:
        return len(self.rules)

    def export_coe(self, path: str):
        """Compile this ruleset's content literals into a reference-format
        ``.coe`` memory image — the "Snort rules → CSR_BlockMem" pipeline
        whose output the reference SHIPS but whose tooling it never
        published (``CSR_BlockMem_snort_16.coe`` derives from exactly such
        a ruleset, SURVEY.md §2.1 #14 / §0).

        Every rule's non-negated content literals (raw and buffered —
        the buffer/negation/pcre/byte-op constraints are host-verify
        stages with no RTL analogue) become one merged unanchored CSR
        NFA with per-literal accept states, loadable by the reference
        engine (accept = out-degree 0, per-state match counters =
        per-literal counters).  Returns ``(automaton, owner, literals)``
        where ``owner[s]`` is the literal index owning state ``s`` (-1
        for the shared hub)."""
        special = set(rb"\^$.[]()*+?{}|")
        literals = sorted({
            c.pattern for r in self.rules for c in r.contents
            if not c.negated and c.pattern
        })
        if not literals:
            raise RegexError("ruleset has no non-negated content literals")
        pats = [
            bytes(b for ch in lit
                  for b in ((0x5C, ch) if ch in special else (ch,)))
            for lit in literals
        ]
        aut, owner = regexes_to_csr(pats)
        write_coe(path, aut.to_words())
        return aut, owner, literals

    @staticmethod
    def _ac_presence(ac, data: bytes) -> np.ndarray:
        """Per-pattern occurrence counts of an AC automaton host-walked
        over a short derived buffer (normalized URI — tens of bytes, so
        a Python table walk beats any engine dispatch)."""
        table, accept = ac.dfa.table, ac.dfa.accept
        sc = np.zeros(ac.num_states, np.int64)
        s = 0
        for b in data:
            s = int(table[b, s])
            if accept[s]:
                sc[s] += 1
        return ac.pattern_counts(sc)

    def _pcre_tables(self, idx: int):
        """(table, accept, eof) for rule idx's pcre in scanning mode, or
        None when absent/outside the subset.  Compiled objects are shared
        across rules with identical pcre TEXT (community rulesets repeat
        boilerplate patterns, so compiling per rule is redundant). A pattern
        that the DFA compiler refuses (``\\b``/``\\B``, or a DFA blowup)
        goes to the Pike VM; one that neither takes is outside the subset.
        Rules files come from outside the program, so any exception counts
        as a refusal, as in the JAX package."""
        if idx not in self._pcre_cache:
            r = self.rules[idx]
            if r.pcre is not None and r.pcre in self._pcre_by_text:
                self._pcre_cache[idx] = self._pcre_by_text[r.pcre]
                return self._pcre_cache[idx]
            out = None
            if r.pcre is not None:
                pat = pcre_to_pattern(r.pcre)
                if pat is not None:
                    try:
                        d = compile_pattern(pat.encode(), anchored=False)
                        out = ("dfa", np.ascontiguousarray(d.table), d.accept,
                               d.eof_accept, d.start)
                    except Exception:
                        # \b/\B (or DFA blowup): host Pike-VM existence check
                        try:
                            out = ("host", CaptureProgram(pat.encode()))
                        except Exception:
                            out = None
            self._pcre_cache[idx] = out
            if r.pcre is not None:
                self._pcre_by_text[r.pcre] = out
        return self._pcre_cache[idx]

    def _pcre_hit(self, idx: int, raw: bytes,
                  memo: dict | None = None) -> bool | None:
        """True/False = verified; None = pcre absent or outside subset.
        ``memo`` (per stream) dedupes by pcre TEXT: content-less pcre
        rules are always prefilter candidates, and community corpora
        repeat the same pattern across many rules, so unmemoized a batch
        would run one native scan per rule and payload."""
        r = self.rules[idx]
        if r.pcre is None:
            return None
        if memo is not None and r.pcre in memo:
            return memo[r.pcre]
        t = self._pcre_tables(idx)
        if t is None:
            return None
        res = self._pcre_run(t, raw)
        if memo is not None:
            memo[r.pcre] = res
        return res

    @staticmethod
    def _pcre_run(t, raw: bytes) -> bool:
        if t[0] == "host":  # \b/\B patterns: Pike-VM match existence
            return bool(t[1].finditer_spans(raw, limit=1))
        _, table, accept, eof, start = t
        # the native walk (identity byte classes: pcre tables are raw-byte
        # indexed); a missing g++ raises, as everywhere in the port
        counts, _, final = native.dfa_scan(
            table, np.arange(256, dtype=np.int32), accept,
            np.frombuffer(raw, dtype=np.uint8), start=start, want_mask=False,
        )
        return bool(counts.sum() > 0 or accept[final] or eof[final])

    def _verify(self, idx: int, raw: bytes, low: bytes,
                http_cache: dict | None = None) -> bool:
        """Ordered-occurrence check over the rule's VERIFY PROGRAM
        (``SnortRule.verify_ops``: contents + byte_test/byte_jump in rule
        order) with the positional content modifiers ENFORCED
        (``models/snort.py``): ``offset``/``depth`` window the
        search absolutely — anchored to PAYLOAD START, independent of the
        ordered-walk cursor, depth measured from offset (Snort semantics);
        ``distance``/``within`` window it relative to the previous content
        match's end (``within`` bounds the current match's END).  Negated
        contents assert absence — stream-wide by default, inside their
        window when positionally constrained.  ``byte_test`` is a
        zero-width predicate on converted payload bytes (cursor
        unchanged); ``byte_jump`` converts, scales, aligns, and MOVES the
        cursor — out-of-payload reads or jump targets fail the rule.
        Fuzz-validated against a brute-force all-assignments oracle
        (``tests/test_snort.py::test_verify_fuzz_vs_bruteforce_oracle``).

        The walk BACKTRACKS over occurrences of content ``i`` ONLY when a
        later op is positioned relative to it (``distance``/``within`` on
        a content, ``relative`` on a byte op, somewhere after ``i``):
        there the occurrence choice matters (greedy first-occurrence would
        wrongly refuse e.g. ``content:"A"; content:"B"; within:3;`` on
        ``b"A....A..B"``), and the windows bound the retry cost.  When no
        later op is relative, the earliest occurrence is provably optimal
        (every later content searches FROM the previous match end, so an
        earlier end only widens its window) and the walk stays greedy —
        this also keeps the verify stage LINEAR on attacker-controlled
        payloads (unbounded backtracking is quadratic on a crafted
        packet)."""
        rule = self.rules[idx]
        contents = rule.verify_ops or rule.contents
        n = len(raw)
        dsz = getattr(rule, "dsize", None)
        if dsz is not None:
            lo, hi = dsz
            if (lo is not None and n < lo) or (hi is not None and n > hi):
                return False
        http_bufs = None
        ul = getattr(rule, "urilen", None)
        if ul is not None or any(
                isinstance(c, SnortContent) and c.buffer for c in contents):
            if http_cache is None:
                http_cache = {}
            if "bufs" not in http_cache:  # carve once per stream
                http_cache["bufs"] = parse_http_request(raw)
            http_bufs = http_cache["bufs"]
        if ul is not None:
            # urilen: inclusive URI-length predicate against the
            # normalized (default) or raw URI; no parseable request ->
            # no URI -> the rule cannot fire (Snort: buffer absent)
            if http_bufs is None:
                return False
            lo, hi, mode = ul
            u0, u1 = http_bufs.uri
            if mode == "norm" and http_bufs.uri_norm is not None:
                ulen = len(http_bufs.uri_norm)
            else:
                ulen = u1 - u0
            if (lo is not None and ulen < lo) \
                    or (hi is not None and ulen > hi):
                return False
        # later_relative[i]: some op at index >= i anchors to the cursor
        # (distance/within content, or a relative byte op); queried at
        # [ci + 1] to ask "does any LATER op depend on where op ci ended?"
        later_relative = [False] * (len(contents) + 1)
        for i in range(len(contents) - 1, -1, -1):
            c = contents[i]
            rel = (c.relative
                   if isinstance(c, (ByteTest, ByteJump, ByteExtract,
                                     IsDataAt))
                   else (c.distance is not None or c.within is not None))
            later_relative[i] = later_relative[i + 1] or rel

        _missing = object()  # unresolved byte_extract variable sentinel

        def ok_from(ci: int, prev_end: int, env: dict,
                    bufpos: dict) -> bool:
            if ci == len(contents):
                return True
            c = contents[ci]

            def rv(x):
                # int | None pass through; variable name -> bound value
                return env.get(x, _missing) if isinstance(x, str) else x

            if isinstance(c, ByteTest):
                off, val = rv(c.offset), rv(c.value)
                if off is _missing or val is _missing:
                    return False
                got = _byte_convert(raw, (prev_end if c.relative else 0)
                                    + off, c)
                if got is None:
                    return False
                v, _ = got
                if c.bitmask is not None:
                    v = _apply_bitmask(v, c.bitmask)
                res = _BYTE_OPS[c.op](v, val)
                if c.negate:
                    res = not res
                return bool(res) and ok_from(ci + 1, prev_end, env, bufpos)
            if isinstance(c, ByteExtract):
                off = rv(c.offset)
                if off is _missing:
                    return False
                got = _byte_convert(raw, (prev_end if c.relative else 0)
                                    + off, c)
                if got is None:
                    return False
                v, read_end = got
                # bindings are IMMUTABLE per path: backtracking into an
                # earlier content re-runs the extract with the new cursor
                return ok_from(ci + 1, read_end,
                               {**env, c.name: v * c.multiplier}, bufpos)
            if isinstance(c, IsDataAt):
                pos = rv(c.pos)
                if pos is _missing:
                    return False
                base = prev_end if c.relative else 0
                exists = 0 <= base + pos < n
                if exists == c.negate:
                    return False
                return ok_from(ci + 1, prev_end, env, bufpos)
            if isinstance(c, ByteJump):
                off = rv(c.offset)
                if off is _missing:
                    return False
                pos = (prev_end if c.relative else 0) + off
                if c.count == 0:
                    v, read_end = 0, pos
                else:
                    got = _byte_convert(raw, pos, c)
                    if got is None:
                        return False
                    v, read_end = got
                if c.bitmask is not None:
                    v = _apply_bitmask(v, c.bitmask)
                v *= c.multiplier
                if c.align:
                    v = (v + 3) & ~3
                if c.from_beginning:
                    target = v
                elif c.from_end:
                    target = n + v
                else:
                    target = read_end + v
                target += c.post_offset
                if target < 0 or target > n:
                    return False
                return ok_from(ci + 1, target, env, bufpos)
            c_off, c_dep = rv(c.offset), rv(c.depth)
            c_dist, c_win = rv(c.distance), rv(c.within)
            if _missing in (c_off, c_dep, c_dist, c_win):
                return False
            # HTTP buffer carve: a buffered content searches only its
            # buffer's payload SLICE, with buffer-relative windows and a
            # per-buffer cursor (Snort per-buffer DOE; models/http.py).
            # A payload that isn't a parseable HTTP request has no
            # buffers, so buffered contents fail (Snort: buffer absent).
            bhay = None  # non-None: buffer-local haystack (normalized URI)
            if c.buffer is not None:
                if http_bufs is None:
                    return False
                if c.buffer == "uri" and http_bufs.uri_norm is not None:
                    # http_uri matches the NORMALIZED buffer: percent-decoded + path-compressed bytes,
                    # buffer-relative coordinates, per-buffer DOE cursor.
                    # No raw span exists for these matches; the alert
                    # surface carries rule ids, not spans, so nothing is
                    # lost.  http_raw_uri stays the verbatim slice.
                    norm = http_bufs.uri_norm
                    if c.nocase:
                        if "uri_norm_low" not in http_cache:
                            http_cache["uri_norm_low"] = norm.lower()
                        bhay = http_cache["uri_norm_low"]
                    else:
                        bhay = norm
                    base_off, blen = 0, len(norm)
                else:
                    span = getattr(http_bufs, c.buffer)
                    if span is None:
                        return False
                    base_off, buf_end = span
                    blen = buf_end - base_off
                cur = bufpos.get(c.buffer, 0)
            else:
                base_off, blen, cur = 0, n, prev_end
            hay = bhay if bhay is not None else (low if c.nocase else raw)
            needle = c.pattern.lower() if c.nocase else c.pattern
            relative = c_dist is not None or c_win is not None
            absolute = (
                (c_off is not None or c_dep is not None)
                and not relative
            )
            if absolute:
                # Snort semantics: offset/depth anchor to PAYLOAD (or
                # buffer) START, independent of the ordered-walk cursor
                start = c_off or 0
            elif relative:
                start = cur + (c_dist or 0)
                if c_off is not None:  # mixed: both constraints apply
                    start = max(start, c_off)
            else:
                start = cur  # ordered-occurrence walk
            end_limit = (
                cur + c_win if c_win is not None else None
            )
            if c_dep is not None:
                dl = (c_off or 0) + c_dep
                end_limit = dl if end_limit is None else min(end_limit, dl)
            start = max(start, 0)

            def advance(rel_end: int):
                if c.buffer is not None:
                    return ok_from(ci + 1, prev_end, env,
                                   {**bufpos, c.buffer: rel_end})
                return ok_from(ci + 1, rel_end, env, bufpos)

            if c.negated:
                windowed = (relative or c_off is not None
                            or c_dep is not None)
                seg_end = (min(end_limit, blen) if end_limit is not None
                           else blen)
                frm = start if windowed else 0
                if hay.find(needle, base_off + frm,
                            base_off + (seg_end if windowed else blen)
                            ) != -1:
                    return False
                # a negated content matches "nothing": cursor stays put
                return ok_from(ci + 1, prev_end, env, bufpos)
            # bound the search by end_limit so find() never scans past the
            # window: an occurrence must END by end_limit, which is exactly
            # bytes.find's slice-end semantics.  Without the bound, each
            # backtracking retry of an earlier content re-scans to payload
            # end (quadratic again on a crafted b"A"*n + b"BB" packet
            # against `content:"AA"; content:"BB"; within:4;`)
            bound = blen if end_limit is None else min(end_limit, blen)
            at = hay.find(needle, base_off + start, base_off + bound)
            if not later_relative[ci + 1]:
                # greedy: earliest occurrence is optimal (see docstring)
                if at == -1:
                    return False
                return advance(at - base_off + len(needle))
            while at != -1:
                if advance(at - base_off + len(needle)):
                    return True
                at = hay.find(needle, at + 1, base_off + bound)
            return False

        return ok_from(0, 0, {}, {})

    def enforcement_report(self) -> dict:
        """Per-rule enforcement coverage: which rules this pipeline fully
        enforces vs verifies partially (content/pcre only), and why.

        ``status`` per rule: ``"enforced"`` — every match-constraining
        option is applied (byte ops parsed into the verify program, pcre
        compiled into the engine subset); ``"partial"`` — some match
        constraint is not applied (names in ``unenforced_options``,
        byte ops whose modifiers fell outside the parsed subset in
        ``byte_ops_unparsed``, or a pcre outside the compiler subset).
        Metadata options (msg/sid/rev/classtype/reference/...) never
        affect matching and don't count against a rule."""
        rows = []
        for i, r in enumerate(self.rules):
            scope = sorted({nm for nm, _ in r.options if nm in _SCOPE_OPTS})
            unenforced = sorted({
                nm for nm, v in r.options
                if (nm not in _MATCH_ENFORCED_OPTS
                    and nm not in _METADATA_OPTS
                    and nm not in _SCOPE_OPTS)
                # fast_pattern:only is NOT a pure hint: Snort then skips
                # the rule-option content check and matches it
                # case-insensitively via the MPSE — semantics this
                # pipeline does not reproduce
                or (nm == "fast_pattern" and v and "only" in v)
                or (nm == "dsize"
                    and getattr(r, "dsize", None) is None)
                or (nm == "urilen"
                    and getattr(r, "urilen", None) is None)
            })
            byte_opt_names = ("byte_test", "byte_jump", "byte_extract",
                              "isdataat")
            n_byte_opts = sum(
                1 for nm, _ in r.options if nm in byte_opt_names
            )
            n_byte_ops = sum(
                1 for o in (r.verify_ops or ())
                if isinstance(o, (ByteTest, ByteJump, ByteExtract, IsDataAt))
            )
            byte_unparsed = n_byte_opts - n_byte_ops
            dropped_mods = list(getattr(r, "unenforced_modifiers", ()))
            pcre_state = "none"
            if r.pcre is not None:
                pcre_state = ("enforced" if self._pcre_tables(i) is not None
                              else "outside-subset")
            full = (not unenforced and byte_unparsed == 0
                    and not dropped_mods
                    and pcre_state != "outside-subset")
            rows.append({
                "rule": i,
                "sid": r.sid,
                "status": "enforced" if full else "partial",
                "unenforced_options": unenforced,
                "scope_options": scope,
                "byte_ops_unparsed": byte_unparsed,
                "dropped_modifiers": dropped_mods,
                "pcre": pcre_state,
            })
        summary = {
            "total": len(rows),
            "enforced": sum(r["status"] == "enforced" for r in rows),
            "partial": sum(r["status"] == "partial" for r in rows),
            "with_scope_options": sum(
                bool(r["scope_options"]) for r in rows
            ),
            "pcre_outside_subset": sum(
                r["pcre"] == "outside-subset" for r in rows
            ),
            "byte_ops_unparsed": sum(r["byte_ops_unparsed"] for r in rows),
            "dropped_modifiers": sum(
                len(r["dropped_modifiers"]) for r in rows
            ),
        }
        return {"rules": rows, "summary": summary}

    def _prefilter_counts(self, streams):
        """Stage 1: per-payload occurrence counts of the exact and the
        case-folded content literals, (streams, patterns) each or None.
        The WHOLE batch goes through one engine call per automaton: a call
        per payload would pay the dispatch once per payload."""
        ecs = fcs = None
        if streams:
            if self._exact is not None:
                ecs = self._exact.scan_patterns(streams).pattern_counts
            if self._fold is not None:
                lows = [self._lower_lut[s] for s in streams]
                fcs = self._fold.scan_patterns(lows).pattern_counts
        return ecs, fcs

    def scan(self, data) -> SnortReport:
        streams = _as_streams(data)
        alerts, cands = [], []
        content_report = None
        ecs, fcs = self._prefilter_counts(streams)
        for si, stream in enumerate(streams):
            raw = bytes(stream)
            low = bytes(self._lower_lut[stream])
            http_cache: dict = {}  # per-stream carve memo (_verify fills
            # it on the FIRST buffered rule that survives the prefilter)
            pcre_memo: dict = {}   # per-stream pcre-text result memo
            ec = ecs[si] if ecs is not None else None
            fc = fcs[si] if fcs is not None else None
            uce = ucf = None
            if self._uri_exact is not None or self._uri_fold is not None:
                # normalized-URI prefilter: carve once (shared with
                # _verify via http_cache), walk the short buffer through
                # the uri AC automata host-side
                carve = parse_http_request(raw)
                http_cache["bufs"] = carve
                if carve is not None:
                    u0, u1 = carve.uri
                    ub = (carve.uri_norm if carve.uri_norm is not None
                          else raw[u0:u1])
                    if self._uri_exact is not None:
                        uce = self._ac_presence(self._uri_exact, ub)
                    if self._uri_fold is not None:
                        ucf = self._ac_presence(self._uri_fold,
                                                ub.lower())
            vecs = {"exact": ec, "fold": fc,
                    "uri_exact": uce, "uri_fold": ucf}
            ok = np.ones(len(self.rules), dtype=bool)
            for kind, (rows, pids, negs) in self._gate.items():
                vec = vecs[kind]
                # an absent vector = the haystack itself is absent (no
                # HTTP request -> no uri buffer): non-negated contents
                # there can never match
                present = (np.zeros(len(pids), dtype=bool) if vec is None
                           else np.asarray(vec)[pids] > 0)
                # a rule fails when a content's presence equals its
                # negation flag ((n == 0) != negated in scalar form)
                ok[rows[present == negs]] = False
            out: list[SnortAlert] = []
            hits = np.nonzero(ok)[0].tolist()
            for i in hits:
                if not self._verify(i, raw, low, http_cache=http_cache):
                    continue
                ph = self._pcre_hit(i, raw, memo=pcre_memo)
                if ph is False:
                    continue
                r = self.rules[i]
                out.append(SnortAlert(rule_index=i, sid=r.sid, msg=r.msg,
                                      pcre_checked=ph is True))
            alerts.append(out)
            cands.append(hits)
        return SnortReport(alerts=alerts, prefilter_candidates=cands,
                           content_report=content_report)


def compile_snort(source: str, config: EngineConfig = DEFAULT_CONFIG,
                  device=None) -> SnortMatcher:
    """Load a Snort ``.rules`` file (path) or rules text into the
    prefilter+verify pipeline, with stage 1 on ``device``."""
    rules = (load_snort_rules(source) if os.path.exists(source)
             else parse_snort_rules(source))
    if not rules:
        raise ValueError("no rules parsed")
    return SnortMatcher(rules, config, device)


def compile_l7(path: str, config: EngineConfig = DEFAULT_CONFIG,
               strategy: str = "lazy", prefilter: bool = False, device=None):
    """Compile l7-filter ``.pat`` protocol pattern file(s) — the upstream
    source format of the reference's l-7_filter ruleset (models/l7.py) —
    into one multi-rule matcher on ``device``.  ``path`` is one ``.pat``
    file or a directory of them; rule names land in ``matcher.rule_names``.
    ``prefilter=True`` guards literal-bearing protocols behind the
    Aho-Corasick prefilter on the device (``PrefilteredRuleSet``;
    identical counts)."""
    pats = (load_l7_dir(path) if os.path.isdir(path)
            else [load_l7_pattern(path)])
    if not pats:
        raise ValueError(f"no .pat files under {path!r}")
    patterns = [p.compile_pattern for p in pats]
    if prefilter:
        m = PrefilteredRuleSet(patterns, config, strategy=strategy,
                               device=device)
    else:
        m = RuleSetMatcher(patterns, config, strategy=strategy, device=device)
    m.rule_names = [p.name for p in pats]
    return m
