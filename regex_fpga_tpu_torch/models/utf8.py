"""The regex compiler's UTF-8 mode: code points, matched leftmost-first.

``build_tokenizer_dfa(..., utf8=True)`` compiles its pattern here; every
other pattern takes ``regex.py``'s byte compiler unchanged.

**Characters.** The pattern is a ``str`` of code points. A literal is its
UTF-8 encoding; a class, negated ones included, is a set of code points
(surrogates excluded), compiled into the byte-range sequences that encode
it, suffixes shared. ``\\p{L}``, ``\\p{N}`` (and ``\\P{..}``) are Unicode
15.0.0's general-category groups and ``\\s`` is White_Space, from the
committed tables of ``unicode.py``; ``.`` is any code point but ``\\n``.
``(?i)`` at the pattern's start and the scoped ``(?i:...)`` fold with
simple case folding (``'ſ'`` matches ``s``). Supported besides: ``|``,
groups ``(...)``/``(?:...)``, greedy ``* + ? {m} {m,} {m,n}``, and the
escapes ``\\n \\t \\r \\f \\v \\0 \\xNN \\uNNNN \\UNNNNNNNN``. Anything else
(anchors, lazy or possessive quantifiers, ``\\d``/``\\w``, lookaround)
raises ``RegexError``: nothing is ever taken silently as a literal.

**Leftmost-first.** The automaton of a backtracking engine's first choice,
built as RE2 builds its DFA: a DFA state is the ordered list of NFA threads
(alternatives in pattern order, a greedy quantifier's loop before its
exit), and in the closure a thread that reaches the match drops every
thread after it. ``accept`` then marks the bytes where the highest-priority
thread still alive has matched. The automaton is anchored.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import unicode as uni
from .regex import (Alt, Cat, CompiledDfa, DfaBlowupError, EpsNfa, RegexError,
                    Rep, minimize_dfa)

__all__ = ["Chars", "utf8_sequences", "parse_utf8", "compile_ordered"]

MAX_CP = 0x10FFFF
_SURROGATES = (0xD800, 0xDFFF)


@dataclasses.dataclass(frozen=True)
class Chars:
    """One character out of a set of code points: sorted disjoint
    inclusive (lo, hi) ranges."""

    ranges: tuple


# ---------------------------------------------------------------------------
# code-point sets
# ---------------------------------------------------------------------------


def _union(*sets) -> tuple:
    spans = sorted(r for s in sets for r in s)
    out: list[list[int]] = []
    for a, b in spans:
        if out and a <= out[-1][1] + 1:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return tuple((a, b) for a, b in out)


def _complement(ranges) -> tuple:
    out, at = [], 0
    for a, b in ranges:
        if a > at:
            out.append((at, a - 1))
        at = max(at, b + 1)
    if at <= MAX_CP:
        out.append((at, MAX_CP))
    return tuple(out)


def _fold(ranges) -> tuple:
    """Close a set over simple case folding."""
    orbits = uni.fold_orbits()
    extra = {o for c, orbit in orbits.items() if uni.in_ranges(ranges, c)
             for o in orbit}
    return _union(ranges, uni.ranges_of(sorted(extra)))


# ---------------------------------------------------------------------------
# code points -> UTF-8 byte-range sequences
# ---------------------------------------------------------------------------


def _encode(c: int) -> bytes:
    return chr(c).encode("utf-8")


def utf8_sequences(lo: int, hi: int) -> list[tuple[tuple[int, int], ...]]:
    """The UTF-8 encodings of [lo, hi] (surrogates left out) as sequences
    of byte ranges: each sequence matches exactly the encodings of one
    sub-range, and the sub-ranges tile [lo, hi] in order."""
    out = []
    stack = [(lo, hi)]
    while stack:
        a, b = stack.pop()
        if a > b:
            continue
        s0, s1 = _SURROGATES
        if a <= s1 and b >= s0:  # cut the surrogates out
            stack += [(s1 + 1, b), (a, s0 - 1)]
            continue
        for edge in (0x7F, 0x7FF, 0xFFFF):  # one encoded length at a time
            if a <= edge < b:
                stack += [(edge + 1, b), (a, edge)]
                break
        else:
            for i in (1, 2, 3):  # continuation bytes each over a whole range
                m = (1 << (6 * i)) - 1
                if (a & ~m) != (b & ~m):
                    if a & m:
                        stack += [((a | m) + 1, b), (a, a | m)]
                        break
                    if (b & m) != m:
                        stack += [(b & ~m, b), (a, (b & ~m) - 1)]
                        break
            else:
                ea, eb = _encode(a), _encode(b)
                out.append(tuple(zip(ea, eb)))
    return out


# ---------------------------------------------------------------------------
# parsing (UTF-8 mode)
# ---------------------------------------------------------------------------

_SIMPLE = {"n": 0x0A, "t": 0x09, "r": 0x0D, "f": 0x0C, "v": 0x0B, "0": 0x00}


class _U8Parser:
    def __init__(self, pattern: str, fold: bool):
        self.p = pattern
        self.i = 0
        self.fold = fold

    def error(self, msg: str) -> RegexError:
        return RegexError(f"{msg} at offset {self.i} in {self.p!r} (UTF-8 mode)")

    def peek(self):
        return self.p[self.i] if self.i < len(self.p) else None

    def eat(self) -> str:
        c = self.p[self.i]
        self.i += 1
        return c

    def chars(self, ranges) -> Chars:
        return Chars(_fold(ranges) if self.fold else tuple(ranges))

    def parse_alt(self):
        opts = [self.parse_cat()]
        while self.peek() == "|":
            self.eat()
            opts.append(self.parse_cat())
        return opts[0] if len(opts) == 1 else Alt(tuple(opts))

    def parse_cat(self):
        parts = []
        while self.peek() not in (None, "|", ")"):
            parts.append(self.parse_rep())
        if len(parts) == 1:
            return parts[0]
        return Cat(tuple(parts))

    def parse_rep(self):
        node = self.parse_atom()
        while True:
            c = self.peek()
            if c in ("*", "+", "?"):
                self.eat()
                lo, hi = {"*": (0, None), "+": (1, None), "?": (0, 1)}[c]
            elif c == "{":
                save = self.i
                rep = self._braces()
                if rep is None:
                    self.i = save
                    break
                lo, hi = rep
            else:
                break
            if self.peek() in ("?", "+"):
                raise self.error("lazy and possessive quantifiers are not supported")
            node = Rep(node, lo, hi)
        return node

    def _braces(self):
        self.eat()
        lo = self._int()
        if lo is None:
            return None
        hi = lo
        if self.peek() == ",":
            self.eat()
            hi = self._int()
        if self.peek() != "}":
            return None
        self.eat()
        if hi is not None and hi < lo:
            raise self.error("bad repeat range")
        return lo, hi

    def _int(self):
        s = ""
        while self.peek() is not None and self.peek().isascii() and self.peek().isdigit():
            s += self.eat()
        return int(s) if s else None

    def parse_atom(self):
        c = self.peek()
        if c is None:
            raise self.error("unexpected end")
        if c == "(":
            self.eat()
            saved = self.fold
            if self.peek() == "?":
                j = self.p.find(":", self.i)
                flags = self.p[self.i + 1:j] if j > 0 else None
                if flags is None or any(f not in "i-" for f in flags):
                    raise self.error("unsupported (?...) construct (UTF-8 mode: "
                                     "(?:...), (?i:...), (?-i:...))")
                on, _, off = flags.partition("-")
                self.fold = ("i" in on) or (saved and "i" not in off)
                self.i = j + 1
            node = self.parse_alt()
            if self.peek() != ")":
                raise self.error("unbalanced (")
            self.eat()
            self.fold = saved
            return node
        if c == "[":
            return self.parse_class()
        if c == ".":
            self.eat()
            return Chars(_complement(((0x0A, 0x0A),)))
        if c == "\\":
            self.eat()
            return self.chars(self.parse_escape())
        if c in "*+?":
            raise self.error("quantifier with nothing to repeat")
        if c in "^$":
            raise self.error("anchors are not supported")
        self.eat()
        return self.chars(((ord(c), ord(c)),))

    def _hex(self, n: int) -> int:
        h = self.p[self.i:self.i + n]
        if len(h) != n or any(x not in "0123456789abcdefABCDEF" for x in h):
            raise self.error("bad hex escape")
        self.i += n
        return int(h, 16)

    def parse_escape(self) -> tuple:
        """The ranges of one escape (the backslash already eaten)."""
        if self.peek() is None:
            raise self.error("trailing backslash")
        c = self.eat()
        if c in _SIMPLE:
            return ((_SIMPLE[c], _SIMPLE[c]),)
        if c in "xuU":
            v = self._hex({"x": 2, "u": 4, "U": 8}[c])
            if v > MAX_CP:
                raise self.error("code point out of range")
            return ((v, v),)
        if c in "sS":
            ws = uni.tables()["White_Space"]
            return ws if c == "s" else _complement(ws)
        if c in "pP":
            if self.peek() != "{":
                raise self.error("\\p needs {name}")
            j = self.p.find("}", self.i)
            name = self.p[self.i + 1:j] if j > 0 else ""
            key = {"L": "L", "Letter": "L", "N": "N", "Number": "N"}.get(name)
            if key is None:
                raise self.error(f"unsupported property \\{c}{{{name}}} "
                                 "(UTF-8 mode: L, N)")
            self.i = j + 1
            r = uni.tables()[key]
            return r if c == "p" else _complement(r)
        if c.isascii() and c.isalnum():
            raise self.error(f"unsupported escape \\{c}")
        return ((ord(c), ord(c)),)  # an escaped metacharacter

    def parse_class(self) -> Chars:
        self.eat()  # [
        negate = self.peek() == "^"
        if negate:
            self.eat()
        sets: list[tuple] = []
        first = True
        while True:
            c = self.peek()
            if c is None:
                raise self.error("unbalanced [")
            if c == "]" and not first:
                self.eat()
                break
            first = False
            if c == "\\":
                self.eat()
                sub = self.parse_escape()
                if len(sub) != 1 or sub[0][0] != sub[0][1]:
                    sets.append(sub)
                    continue
                lo = sub[0][0]
            else:
                lo = ord(self.eat())
            if (self.peek() == "-" and self.i + 1 < len(self.p)
                    and self.p[self.i + 1] != "]"):
                self.eat()
                if self.peek() == "\\":
                    self.eat()
                    sub = self.parse_escape()
                    if len(sub) != 1 or sub[0][0] != sub[0][1]:
                        raise self.error("bad class range")
                    hi = sub[0][0]
                else:
                    hi = ord(self.eat())
                if hi < lo:
                    raise self.error("bad class range")
                sets.append(((lo, hi),))
            else:
                sets.append(((lo, lo),))
        ranges = _union(*sets)
        if self.fold:
            ranges = _fold(ranges)
        return Chars(_complement(ranges) if negate else ranges)


def parse_utf8(pattern: str):
    """The AST of a UTF-8-mode pattern (``Chars`` for its characters)."""
    if not isinstance(pattern, str):
        raise RegexError("a UTF-8-mode pattern is a str")
    fold = False
    while pattern.startswith("(?") and ")" in pattern:
        j = pattern.index(")")
        flags = pattern[2:j]
        if not flags or any(f != "i" for f in flags):
            break
        fold = True
        pattern = pattern[j + 1:]
    p = _U8Parser(pattern, fold)
    node = p.parse_alt()
    if p.i != len(pattern):
        raise p.error("unexpected )")
    return node


# ---------------------------------------------------------------------------
# Thompson construction in priority order
# ---------------------------------------------------------------------------


def _chars_fragment(nfa: EpsNfa, node: Chars) -> tuple[int, int]:
    """A character's byte automaton: one edge a sequence's first byte range
    from the entry, then states shared by every sequence with the same
    remaining ranges."""
    a, b = nfa.new_state(), nfa.new_state()
    tails: dict[tuple, int] = {(): b}
    seqs = [s for lo, hi in node.ranges for s in utf8_sequences(lo, hi)]

    def tail(rest: tuple) -> int:
        if rest not in tails:
            t = nfa.new_state()
            nfa.add(t, frozenset(range(rest[0][0], rest[0][1] + 1)), tail(rest[1:]))
            tails[rest] = t
        return tails[rest]

    for seq in seqs:
        nfa.add(a, frozenset(range(seq[0][0], seq[0][1] + 1)), tail(seq[1:]))
    return a, b


def build_ordered(nfa: EpsNfa, node) -> tuple[int, int]:
    """(entry, exit) of ``node``'s fragment, every state's epsilon edges
    added in priority order: alternatives left to right, a quantifier's
    next copy before its exit (every quantifier is greedy)."""
    if isinstance(node, Chars):
        return _chars_fragment(nfa, node)
    if isinstance(node, Cat):
        a = cur = nfa.new_state()
        for part in node.parts:
            f = build_ordered(nfa, part)
            nfa.add(cur, None, f[0])
            cur = f[1]
        return a, cur
    if isinstance(node, Alt):
        a, b = nfa.new_state(), nfa.new_state()
        for opt in node.options:
            f = build_ordered(nfa, opt)
            nfa.add(a, None, f[0])
            nfa.add(f[1], None, b)
        return a, b
    if isinstance(node, Rep):
        if node.lo > 64 or (node.hi is not None and node.hi > 64):
            raise RegexError("repeat bound too large (>64)")
        a = cur = nfa.new_state()
        for _ in range(node.lo):
            f = build_ordered(nfa, node.node)
            nfa.add(cur, None, f[0])
            cur = f[1]
        b = nfa.new_state()
        if node.hi is None:
            f = build_ordered(nfa, node.node)
            nfa.add(cur, None, f[0])
            nfa.add(cur, None, b)
            nfa.add(f[1], None, cur)
            return a, b
        for _ in range(node.hi - node.lo):
            f = build_ordered(nfa, node.node)
            nfa.add(cur, None, f[0])
            nfa.add(cur, None, b)
            cur = f[1]
        nfa.add(cur, None, b)
        return a, b
    raise RegexError(f"{type(node).__name__} is not supported in UTF-8 mode")


# ---------------------------------------------------------------------------
# subset construction over thread lists
# ---------------------------------------------------------------------------


def _subset(nfa: EpsNfa, entry: int, exit_: int, max_states: int) -> CompiledDfa:
    """A DFA state is the list of the NFA's byte-consuming states alive, in
    priority order and cut after the first that reaches the match, and
    whether the match was reached."""
    n = nfa.n
    eps: list[list[int]] = [[] for _ in range(n)]
    edges: list[list[int]] = [[] for _ in range(n)]
    masks, dsts = [], []
    for src, cs, dst in nfa.edges:
        if cs is None:
            eps[src].append(dst)
        else:
            m = np.zeros(256, bool)
            m[list(cs)] = True
            edges[src].append(len(dsts))
            masks.append(m)
            dsts.append(dst)
    masks = np.array(masks, bool).reshape(-1, 256)
    dsts = np.array(dsts, np.int64)

    memo: dict[tuple, tuple] = {}

    def close(seeds: tuple) -> tuple:
        if seeds in memo:
            return memo[seeds]
        out, seen, matched = [], set(), False
        stack = list(reversed(seeds))
        while stack:
            s = stack.pop()
            if s in seen:
                continue
            seen.add(s)
            if s == exit_:
                matched = True
                break
            if edges[s]:
                out.append(s)
            stack.extend(reversed(eps[s]))
        key = (tuple(out), matched)
        memo[seeds] = key
        return key

    dead_key = ((), False)
    start = close((entry,))
    ids = {start: 0}
    order = [start]
    rows = []
    for key in order:  # grows as states are found
        threads = key[0]
        row = np.full(256, -1, np.int64)
        eidx = [k for t in threads for k in edges[t]]
        if eidx:
            cols, inv = np.unique(masks[eidx].T, axis=0, return_inverse=True)
            inv = inv.reshape(-1)
            for u in range(len(cols)):
                hit = np.nonzero(cols[u])[0]
                if not len(hit):
                    continue
                nxt = close(tuple(int(dsts[eidx[j]]) for j in hit))
                if nxt == dead_key:
                    continue
                if nxt not in ids:
                    if len(ids) >= max_states:
                        raise DfaBlowupError(
                            f"subset construction exceeded {max_states} states")
                    ids[nxt] = len(order)
                    order.append(nxt)
                row[inv == u] = ids[nxt]
        rows.append(row)
    s = len(order)
    table = np.full((256, s + 1), s, np.int32)
    for i, row in enumerate(rows):
        live = row >= 0
        table[live, i] = row[live]
    accept = np.array([k[1] for k in order] + [False], bool)
    return CompiledDfa(table=table, accept=accept, start=0, dead=s)


def compile_ordered(pattern: str, *, max_states: int = 100_000,
                    minimize: bool = True) -> CompiledDfa:
    """The anchored leftmost-first DFA of a UTF-8-mode pattern over bytes."""
    nfa = EpsNfa()
    entry, exit_ = build_ordered(nfa, parse_utf8(pattern))
    dfa = _subset(nfa, entry, exit_, max_states)
    return minimize_dfa(dfa) if minimize else dfa
