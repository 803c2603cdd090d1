"""Capture-group extraction: a tagged Pike VM over device-found spans.

The reference design reports only accept-state indices (`Design/FPGA.v:210-226`
— there is no notion of sub-spans in the RTL), and the TPU scan engines are
(subset-)DFAs, which cannot track capture groups.  This module supplies the
two-stage design used by production DFA engines (RE2, Hyperscan): the device
engines find match SPANS at full throughput; group sub-spans are then
recovered host-side by re-walking just the matched bytes — O(span × NFA
states), and spans are short.

Disambiguation: the overall span is fixed by the caller (the engines are
POSIX leftmost-longest); WITHIN that span, group assignment follows greedy
(Perl/PCRE) thread priority — alternation prefers the leftmost branch,
quantifiers prefer more repetitions, and a repeated group captures its last
repetition.  This matches Python ``re`` whenever Python agrees on the span.

Construction: the parsed AST (``models/regex.py``, including ``Group`` nodes)
is lowered to an eps-NFA whose eps out-edges are *priority-ordered* and may
carry a tag id; tag ``2k`` / ``2k+1`` records the open / close byte offset of
group ``k+1``.  Simulation is the classic Pike VM: an ordered thread list per
position, state-deduplicated so the highest-priority thread owns each state.
"""

from __future__ import annotations

from .regex import (
    Alt,
    Anchor,
    Bound,
    Cat,
    Group,
    Lit,
    ParsedPattern,
    Rep,
    parse_pattern,
)

_WORDBYTES = frozenset(
    list(range(ord("a"), ord("z") + 1))
    + list(range(ord("A"), ord("Z") + 1))
    + list(range(ord("0"), ord("9") + 1))
    + [ord("_")]
)

__all__ = ["CaptureProgram"]

_UNSET = -1


class _Prog:
    """Tagged eps-NFA with ordered successors.

    ``char[s]`` = (charset, dst) for byte-consuming states, else None.
    ``eps[s]``  = ordered list of (dst, tag|None, assert|None); tag writes
    the current byte offset into slot ``tag`` when the edge is traversed;
    assert is "b"/"B" for word-boundary edges, crossable only when the
    buffer context satisfies the assertion.
    """

    def __init__(self):
        self.char: list[tuple[frozenset, int] | None] = []
        self.eps: list[list[tuple[int, int | None, str | None]]] = []

    def new(self) -> int:
        self.char.append(None)
        self.eps.append([])
        return len(self.char) - 1


def _lower(prog: _Prog, node) -> tuple[int, int]:
    """Lower one AST fragment; returns (entry, exit).  Eps edges are appended
    in PRIORITY order: earlier edge = preferred path (greedy)."""
    if isinstance(node, Lit):
        a, b = prog.new(), prog.new()
        prog.char[a] = (node.chars, b)
        return a, b
    if isinstance(node, Cat):
        if not node.parts:
            a = prog.new()
            return a, a
        entry, cur = _lower(prog, node.parts[0])
        for part in node.parts[1:]:
            na, nb = _lower(prog, part)
            prog.eps[cur].append((na, None, None))
            cur = nb
        return entry, cur
    if isinstance(node, Alt):
        a, b = prog.new(), prog.new()
        for opt in node.options:  # textual order = priority order
            fa, fb = _lower(prog, opt)
            prog.eps[a].append((fa, None, None))
            prog.eps[fb].append((b, None, None))
        return a, b
    if isinstance(node, Rep):
        lo, hi = node.lo, node.hi
        lazy = node.lazy
        a = prog.new()
        cur = a
        for _ in range(lo):
            fa, fb = _lower(prog, node.node)
            prog.eps[cur].append((fa, None, None))
            cur = fb
        if hi is None:
            # loop head: greedy prefers another iteration, lazy prefers
            # leaving (edge order IS thread priority)
            loop = prog.new()
            prog.eps[cur].append((loop, None, None))
            out = prog.new()
            fa, fb = _lower(prog, node.node)
            if lazy:
                prog.eps[loop].append((out, None, None))  # 1st: leave
                prog.eps[loop].append((fa, None, None))   # 2nd: take the body
            else:
                prog.eps[loop].append((fa, None, None))   # 1st: take the body
                prog.eps[loop].append((out, None, None))  # 2nd: leave
            prog.eps[fb].append((loop, None, None))
            return a, out
        out = prog.new()
        copies = []
        for _ in range(hi - lo):
            fa, fb = _lower(prog, node.node)
            copies.append((cur, fa))
            cur = fb
        prog.eps[cur].append((out, None, None))
        for c_, fa in copies:
            if lazy:
                prog.eps[c_].append((out, None, None))  # 1st: skip out
                prog.eps[c_].append((fa, None, None))   # 2nd: take the copy
            else:
                prog.eps[c_].append((fa, None, None))   # 1st: take the copy
                prog.eps[c_].append((out, None, None))  # 2nd: skip out
        return a, out
    if isinstance(node, Bound):
        a, b = prog.new(), prog.new()
        prog.eps[a].append((b, None, "B" if node.negate else "b"))
        return a, b
    if isinstance(node, Anchor):  # (?m) line anchors: "^" / "$"
        a, b = prog.new(), prog.new()
        prog.eps[a].append((b, None, node.kind))
        return a, b
    if isinstance(node, Group):
        a, b = prog.new(), prog.new()
        fa, fb = _lower(prog, node.node)
        k = node.index - 1
        prog.eps[a].append((fa, 2 * k, None))
        prog.eps[fb].append((b, 2 * k + 1, None))
        return a, b
    raise TypeError(node)


class CaptureProgram:
    """Compiled capture extractor for one pattern.

    ``extract(data, start, end)`` re-matches ``data[start:end]`` (anchored at
    both ends — the span is already known to match) and returns one
    ``(open, close)`` absolute-offset pair per capture group, or ``None`` for
    groups not reached on the winning path.
    """

    def __init__(self, pattern_or_parsed: str | bytes | ParsedPattern):
        pp = (
            pattern_or_parsed
            if isinstance(pattern_or_parsed, ParsedPattern)
            else parse_pattern(pattern_or_parsed)
        )
        self.num_groups = pp.num_groups
        self.group_names = dict(pp.group_names)
        node = pp.node
        # whole-pattern anchors were stripped by the parser — restore them
        # as absolute zero-width assertions so host scanning honors them
        if pp.start_anchored or pp.end_anchored:
            parts = []
            if pp.start_anchored:
                parts.append(Anchor("A"))
            parts.append(node)
            if pp.end_anchored:
                parts.append(Anchor("Z"))
            node = Cat(tuple(parts))
        prog = _Prog()
        self._entry, self._accept = _lower(prog, node)
        self._prog = prog

    # -- Pike VM -----------------------------------------------------------

    def _assert_ok(self, asrt: str, data, pos: int) -> bool:
        r"""Zero-width assertion check at ``pos`` against the whole buffer:
        \b/\B word boundaries and (?m) line anchors (``^`` = buffer start
        or right after newline; ``$`` = buffer end or right before one)."""
        if asrt == "^":
            return pos == 0 or data[pos - 1] == 0x0A
        if asrt == "$":
            return pos == len(data) or data[pos] == 0x0A
        if asrt == "A":  # absolute buffer start (whole-pattern ^)
            return pos == 0
        if asrt == "Z":  # absolute buffer end (whole-pattern $, == accept_eof)
            return pos == len(data)
        return self._at_boundary(data, pos) == (asrt == "b")

    @staticmethod
    def _at_boundary(data, pos: int) -> bool:
        """Word boundary at ``pos`` (between bytes pos-1 and pos), judged
        against the WHOLE buffer — context outside the span counts, exactly
        as in a streaming scan.  Buffer edges are non-word context."""
        prev_w = pos > 0 and data[pos - 1] in _WORDBYTES
        next_w = pos < len(data) and data[pos] in _WORDBYTES
        return prev_w != next_w

    def _close(self, threads, state, tags, last, pos, seen, data):
        """Priority-ordered eps closure: DFS appending byte-consuming states
        (and the accept state) to the ordered thread list.  ``last`` tracks
        the chronologically last tag written on the thread's path — the
        source of ``Match.lastindex`` (Python ``re``'s "lastmark")."""
        if state in seen:
            return
        seen.add(state)
        if self._prog.char[state] is not None or state == self._accept:
            threads.append((state, tags, last))
        for dst, tag, asrt in self._prog.eps[state]:
            if asrt is not None and not self._assert_ok(asrt, data, pos):
                continue
            nt, nl = tags, last
            if tag is not None:
                nt = list(tags)
                nt[tag] = pos
                nl = tag
            self._close(threads, dst, nt, nl, pos, seen, data)

    def extract(
        self, data: bytes | bytearray | memoryview, start: int, end: int
    ) -> tuple[list[tuple[int, int] | None], int | None]:
        """Returns ``(group_spans, lastindex)``."""
        if self.num_groups == 0:
            return [], None
        threads: list = []
        self._close(
            threads, self._entry, [_UNSET] * (2 * self.num_groups), None,
            start, set(), data,
        )
        for pos in range(start, end):
            b = data[pos]
            nxt: list = []
            seen: set = set()
            for state, tags, last in threads:
                edge = self._prog.char[state]
                if edge is not None and b in edge[0]:
                    self._close(nxt, edge[1], tags, last, pos + 1, seen, data)
            threads = nxt
            if not threads:
                break
        for state, tags, last in threads:
            if state == self._accept:
                spans = [
                    None
                    if tags[2 * k] == _UNSET or tags[2 * k + 1] == _UNSET
                    else (tags[2 * k], tags[2 * k + 1])
                    for k in range(self.num_groups)
                ]
                return spans, (None if last is None else last // 2 + 1)
        # span was produced by the same language — should be unreachable
        return [None] * self.num_groups, None

    # -- scanning (the host-verified path for \b/\B patterns) ---------------

    def _sclose(self, threads, state, startpos, pos, seen, data):
        """Tag-free closure for scanning threads (state, match-start)."""
        if state in seen:
            return
        seen.add(state)
        if self._prog.char[state] is not None or state == self._accept:
            threads.append((state, startpos))
        for dst, _tag, asrt in self._prog.eps[state]:
            if asrt is not None and not self._assert_ok(asrt, data, pos):
                continue
            self._sclose(threads, dst, startpos, pos, seen, data)

    def longest_end_at(self, data, s0: int) -> int:
        """Longest match end for a match anchored at offset ``s0``, or -1.
        Assertions see the whole buffer (bytes before ``s0`` included)."""
        threads: list = []
        self._sclose(threads, self._entry, s0, s0, set(), data)
        best = -1
        pos = s0
        n = len(data)
        while True:
            if any(st == self._accept for st, _ in threads):
                best = pos
            if pos >= n or not threads:
                return best
            b = data[pos]
            nxt: list = []
            seen: set = set()
            for st, sp in threads:
                edge = self._prog.char[st]
                if edge is not None and b in edge[0]:
                    self._sclose(nxt, edge[1], sp, pos + 1, seen, data)
            threads = nxt
            pos += 1

    def first_end_at(self, data, s0: int) -> int:
        """PCRE/Python match end for a match anchored at ``s0``: thread
        PRIORITY decides (lazy quantifiers prefer short), not length.  A
        lower-priority accept is overridden if a higher-priority thread
        accepts later.  Returns -1 when nothing matches."""
        threads: list = []
        self._sclose(threads, self._entry, s0, s0, set(), data)
        best = -1
        pos = s0
        n = len(data)
        while True:
            for i, (st, _) in enumerate(threads):
                if st == self._accept:
                    best = pos
                    threads = threads[:i]  # kill lower-priority threads
                    break
            if pos >= n or not threads:
                return best
            b = data[pos]
            nxt: list = []
            seen: set = set()
            for st, sp in threads:
                edge = self._prog.char[st]
                if edge is not None and b in edge[0]:
                    self._sclose(nxt, edge[1], sp, pos + 1, seen, data)
            threads = nxt
            pos += 1

    def finditer_spans_first(
        self, data, limit: int | None = None, start_at: int = 0
    ) -> list[tuple[int, int]]:
        """Non-overlapping LEFTMOST-FIRST (PCRE/Python ``re``) spans — the
        scanning mode for patterns with non-greedy quantifiers, where the
        span is decided by thread priority rather than POSIX length.
        New-start threads join at the tail (lowest priority), so earlier
        starts always win; once a match is recorded only higher-priority
        threads may override it.  After an EMPTY match at q the search
        resumes AT q with only the empty match at q banned (Python re's
        rule — a lazy pattern prefers empty, so a non-empty match at the
        same position must still be findable)."""
        n = len(data)
        spans: list[tuple[int, int]] = []
        p = start_at  # re's Pattern.finditer pos: context BEFORE p stays
        ban_pos = -1  # position where an empty match was already emitted
        while p <= n:
            threads: list = []
            match: tuple[int, int] | None = None
            pos = p
            while True:
                if match is None:
                    seen = {st for st, _ in threads}
                    self._sclose(threads, self._entry, pos, pos, seen, data)
                for i, (st, s0) in enumerate(threads):
                    if st == self._accept and not (s0 == pos == ban_pos):
                        match = (s0, pos)
                        threads = threads[:i]
                        break
                if pos >= n or (match is not None and not threads):
                    break
                b = data[pos]
                nxt: list = []
                seen = set()
                for st, s0 in threads:
                    edge = self._prog.char[st]
                    if edge is not None and b in edge[0]:
                        self._sclose(nxt, edge[1], s0, pos + 1, seen, data)
                threads = nxt
                pos += 1
            if match is None:
                if p == ban_pos and p < n:
                    # nothing (non-empty) at the banned position: step past
                    p += 1
                    continue
                break
            spans.append(match)
            if limit is not None and len(spans) >= limit:
                break
            a, b_ = match
            p = b_
            ban_pos = b_ if a == b_ else -1
            if a == b_ and b_ == n:
                break  # trailing empty emitted; nothing can follow
        return spans

    def finditer_spans(
        self, data, limit: int | None = None, start_at: int = 0
    ) -> list[tuple[int, int]]:
        """Non-overlapping POSIX leftmost-longest spans — single forward
        pass, threads tagged with their match start; the same span semantics
        as ``DfaMatcher.finditer`` (reverse-scan + anchored walks), computed
        entirely host-side because assertions need next-byte context."""
        n = len(data)
        spans: list[tuple[int, int]] = []
        p = start_at  # re's Pattern.finditer pos (assertion context kept)
        while p <= n:
            threads: list = []
            match: tuple[int, int] | None = None
            pos = p
            while True:
                if match is None:
                    seen = {st for st, _ in threads}
                    self._sclose(threads, self._entry, pos, pos, seen, data)
                for st, s0 in threads:
                    if st == self._accept and (
                        match is None
                        or s0 < match[0]
                        or (s0 == match[0] and pos > match[1])
                    ):
                        match = (s0, pos)
                if match is not None:
                    # leftmost locked in: drop later starts, keep earlier
                    # unaccepted threads (they could still win leftmost-ness)
                    threads = [
                        (st, s0) for st, s0 in threads
                        if s0 <= match[0] and st != self._accept
                    ]
                if pos >= n:
                    break
                b = data[pos]
                nxt: list = []
                seen = set()
                for st, s0 in threads:
                    edge = self._prog.char[st]
                    if edge is not None and b in edge[0]:
                        self._sclose(nxt, edge[1], s0, pos + 1, seen, data)
                threads = nxt
                pos += 1
                if not threads and match is not None:
                    break
            if match is None:
                break
            spans.append(match)
            if limit is not None and len(spans) >= limit:
                break
            p = max(match[1], match[0] + 1)
        return spans
