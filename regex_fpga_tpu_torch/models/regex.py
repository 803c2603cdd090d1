"""Byte-level regex compiler: pattern -> Thompson eps-NFA -> DFA -> minimal DFA.

The reference ships only *compiled* automata (the `.coe` images; no compiler
exists anywhere in `linfenghuaster/Regex-FPGA` — SURVEY.md SS0), so this
stage is new surface area the TPU framework must provide to be usable as a
regex engine: users compile patterns, the reference's users load `.coe`.

Supported syntax (byte-oriented):
  literals, ``.`` (any byte except \\n), escapes ``\\n \\t \\r \\f \\v \\0
  \\xNN \\d \\D \\w \\W \\s \\S`` and escaped metachars, classes
  ``[a-z0-9]`` / negated ``[^...]`` (ranges, escapes), alternation ``|``,
  groups: capturing ``(...)`` / named ``(?P<name>...)`` (spans recovered by
  ``models/captures.py``) / non-capturing ``(?:...)``, quantifiers
  ``* + ? {m} {m,} {m,n}``, the pattern-prefix flags ``(?i)`` (ASCII case
  folding) and ``(?s)`` (DOTALL: ``.`` matches ``\\n``), word boundaries
  ``\\b``/``\\B`` (host Pike-VM path — see ``Bound``), absolute anchors
  ``\\A``/``\\Z`` (host path — ``Anchor``), backreferences ``\\1``-``\\99``/
  ``(?P=name)``, lookaround ``(?=) (?!) (?<=) (?<!)``, and conditionals
  ``(?(id)yes|no)`` (host backtracking path — ``Backref``/``Look``/
  ``Cond``, ``models/backtrack.py``), and whole-pattern
  anchors: a leading ``^`` pins
  the match to the start of the stream, a trailing ``$`` to its end (EOF
  acceptance is carried in ``CompiledDfa.accept_eof``).  Anchors apply to
  the ENTIRE pattern — ``ab|cd$`` is rejected as ambiguous (group it);
  mid-pattern anchors are errors, never silently literal.

The DFA is produced by subset construction with a configurable state-count
guard (the shipped IDS rulesets exceed 300k states and must stay on the NFA
engine — SURVEY.md SS0), then Hopcroft minimization.  Output is a dense
(256, S) table + accept mask, directly consumable by ``ops.build_dfa_tables``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "RegexError",
    "DfaBlowupError",
    "parse",
    "parse_pattern",
    "ParsedPattern",
    "Group",
    "Bound",
    "Backref",
    "Look",
    "Cond",
    "contains_bound",
    "contains_backtrack",
    "strip_assertions",
    "nullable",
    "compile_nfa",
    "nfa_to_dfa",
    "minimize_dfa",
    "compile_pattern",
    "CompiledDfa",
]


class RegexError(ValueError):
    pass


class DfaBlowupError(RuntimeError):
    """Subset construction exceeded the state guard; use the NFA engine."""


# ---------------------------------------------------------------------------
# parsing to an AST
# ---------------------------------------------------------------------------

_DIGITS = frozenset(range(ord("0"), ord("9") + 1))
_WORD = (
    frozenset(range(ord("a"), ord("z") + 1))
    | frozenset(range(ord("A"), ord("Z") + 1))
    | _DIGITS
    | {ord("_")}
)
_SPACE = frozenset(b" \t\n\r\f\v")
_ALL = frozenset(range(256))


@dataclasses.dataclass(frozen=True)
class Lit:
    chars: frozenset  # set of byte values


@dataclasses.dataclass(frozen=True)
class Cat:
    parts: tuple


@dataclasses.dataclass(frozen=True)
class Alt:
    options: tuple


@dataclasses.dataclass(frozen=True)
class Rep:
    node: object
    lo: int
    hi: int | None  # None = unbounded
    #: non-greedy (``*?``/``+?``/``??``/``{m,n}?``).  The matched LANGUAGE is
    #: identical either way (the DFA compiler ignores it); only span/group
    #: disambiguation changes, so lazy patterns route to the host Pike VM
    #: in leftmost-FIRST (PCRE/Python) mode.
    lazy: bool = False


@dataclasses.dataclass(frozen=True)
class Bound:
    """Zero-width word-boundary assertion ``\\b`` (``negate`` = ``\\B``).

    Not expressible in the streaming DFA engines (accept there is a pure
    function of the state at a position, but a trailing ``\\b`` needs the
    NEXT byte — e.g. ``foo\\b`` on ``food`` vs ``foo!``), so patterns
    containing it route to the host Pike-VM path (``models/captures.py``),
    which checks assertions against the surrounding buffer context."""

    negate: bool


@dataclasses.dataclass(frozen=True)
class Anchor:
    """Zero-width LINE anchor ``^``/``$`` under ``(?m)`` (MULTILINE).

    Like ``Bound``, not expressible in the streaming DFA engines (a ``$``
    needs the NEXT byte to be ``\\n`` or end-of-buffer), so patterns
    containing it route to the host Pike-VM path.  ``kind`` is ``"^"``
    (start of buffer or right after ``\\n``) or ``"$"`` (end of buffer or
    right before ``\\n``) — Python ``re.MULTILINE`` semantics — or the
    absolute forms ``"A"``/``"Z"`` (``\\A``/``\\Z``: buffer start/end
    only, no newline allowance)."""

    kind: str  # "^" | "$" | "A" | "Z"


@dataclasses.dataclass(frozen=True)
class Group:
    """Capturing group ``(...)`` / ``(?P<name>...)``.  Transparent to the
    DFA/CSR compilation paths (captures do not change the language); consumed
    by the submatch extractor (``models/captures.py``), which re-walks a
    device-found span with a tagged Pike VM to recover group spans."""

    node: object
    index: int  # 1-based, textual order of '('
    name: str | None = None


@dataclasses.dataclass(frozen=True)
class Backref:
    """Backreference ``\\1``-``\\99`` / ``(?P=name)`` — matches the exact
    bytes its group captured.  Not a regular language (classically: the
    copy language), so patterns containing one route to the host
    backtracking engine (``models/backtrack.py``,
    ``api.HostBacktrackMatcher``) with Python ``re`` leftmost-first
    semantics; the DFA/NFA compilers refuse the node."""

    index: int
    name: str | None = None


@dataclasses.dataclass(frozen=True)
class Cond:
    """Conditional ``(?(id)yes|no)`` / ``(?(name)yes|no)`` — matches the
    ``yes`` branch if the referenced group has participated in the match so
    far, the ``no`` branch (epsilon when absent) otherwise.  The branch
    choice depends on runtime group state, so like ``Backref`` the pattern
    routes to the host backtracking engine (``models/backtrack.py``) with
    Python ``re`` semantics.  Numeric ids are validated against the FINAL
    group count after the whole pattern parses (``(?(1)a|b)(x)`` is legal
    in ``re`` — the condition is simply false at that point)."""

    index: int
    yes: object
    no: object | None = None
    name: str | None = None


@dataclasses.dataclass(frozen=True)
class Look:
    """Zero-width lookaround ``(?=...)``/``(?!...)``/``(?<=...)``/
    ``(?<!...)``.  Lookbehind requires a fixed-width sub-pattern (same
    rule as Python ``re``; validated at matcher build).  Like ``Backref``,
    routes the pattern to the host backtracking engine — a streaming DFA's
    accept is a pure function of the state at a position and cannot
    consult bytes past it (same argument as ``Bound``)."""

    node: object
    behind: bool
    negate: bool


def _casefold(chars: frozenset) -> frozenset:
    """Close a byte set over ASCII case (the ``(?i)`` flag)."""
    out = set(chars)
    for c in chars:
        if ord("a") <= c <= ord("z"):
            out.add(c - 32)
        elif ord("A") <= c <= ord("Z"):
            out.add(c + 32)
    return frozenset(out)


class _Parser:
    def __init__(self, pattern: bytes, fold: bool = False,
                 dotall: bool = False, multiline: bool = False):
        self.p = pattern
        self.i = 0
        self.fold = fold
        self.dotall = dotall
        self.multiline = multiline
        self.ngroups = 0
        self.group_names: dict[str, int] = {}
        #: numeric ``(?(N)...)`` references: (index, offset) pairs, checked
        #: against the FINAL group count once the whole pattern has parsed
        #: (``re`` allows a conditional to reference a later group)
        self.cond_refs: list[tuple[int, int]] = []

    def lit(self, chars: frozenset) -> Lit:
        return Lit(_casefold(chars) if self.fold else chars)

    def error(self, msg: str) -> RegexError:
        return RegexError(f"{msg} at offset {self.i} in {self.p!r}")

    def peek(self):
        return self.p[self.i] if self.i < len(self.p) else None

    def eat(self):
        c = self.p[self.i]
        self.i += 1
        return c

    def parse_alt(self):
        opts = [self.parse_cat()]
        while self.peek() == ord("|"):
            self.eat()
            opts.append(self.parse_cat())
        return opts[0] if len(opts) == 1 else Alt(tuple(opts))

    def parse_cat(self):
        parts = []
        while self.peek() not in (None, ord("|"), ord(")")):
            parts.append(self.parse_rep())
        if not parts:
            return Cat(())
        return parts[0] if len(parts) == 1 else Cat(tuple(parts))

    def parse_rep(self):
        node = self.parse_atom()
        while True:
            c = self.peek()
            if c == ord("*"):
                self.eat()
                node = self._lazy_mod(Rep(node, 0, None))
            elif c == ord("+"):
                self.eat()
                node = self._lazy_mod(Rep(node, 1, None))
            elif c == ord("?"):
                self.eat()
                node = self._lazy_mod(Rep(node, 0, 1))
            elif c == ord("{"):
                save = self.i
                rep = self._try_braces()
                if rep is None:
                    self.i = save
                    break
                node = self._lazy_mod(Rep(node, rep[0], rep[1]))
            else:
                break
        return node

    def _lazy_mod(self, node: Rep) -> Rep:
        """A ``?`` directly after a quantifier marks it non-greedy (re
        semantics — NOT a nested optional)."""
        if self.peek() == ord("?"):
            self.eat()
            return dataclasses.replace(node, lazy=True)
        return node

    def _try_braces(self):
        self.eat()  # {
        lo = self._int()
        if lo is None:
            return None
        hi = lo
        if self.peek() == ord(","):
            self.eat()
            hi = self._int()  # None = unbounded
        if self.peek() != ord("}"):
            return None
        self.eat()
        if hi is not None and hi < lo:
            raise self.error("bad repeat range")
        return lo, hi

    def _int(self):
        s = ""
        while self.peek() is not None and self.peek() in _DIGITS:
            s += chr(self.eat())
        return int(s) if s else None

    def parse_atom(self):
        c = self.peek()
        if c is None:
            raise self.error("unexpected end")
        if c == ord("("):
            self.eat()
            capture: int | None = None
            name: str | None = None
            if self.peek() == ord("?"):
                if self.p[self.i : self.i + 2] == b"?:":
                    self.i += 2
                elif self.p[self.i : self.i + 3] == b"?P<":
                    self.i += 3
                    j = self.p.find(b">", self.i)
                    if j < 0:
                        raise self.error("unterminated group name")
                    raw = self.p[self.i : j]
                    if not raw or not raw.decode("ascii", "replace").isidentifier():
                        raise self.error(f"bad group name {raw!r}")
                    name = raw.decode("ascii")
                    if name in self.group_names:
                        raise self.error(f"redefinition of group name {name!r}")
                    self.i = j + 1
                    self.ngroups += 1
                    capture = self.ngroups
                    self.group_names[name] = capture
                elif (self.p[self.i : self.i + 2] in (b"?=", b"?!")
                      or self.p[self.i : self.i + 3] in (b"?<=", b"?<!")):
                    behind = self.p[self.i + 1 : self.i + 2] == b"<"
                    off = 3 if behind else 2
                    negate = self.p[self.i + off - 1] == ord("!")
                    self.i += off
                    sub = self.parse_alt()
                    if self.peek() != ord(")"):
                        raise self.error("unbalanced (")
                    self.eat()
                    return Look(sub, behind, negate)
                elif self.p[self.i : self.i + 2] == b"?(":
                    # conditional (?(id)yes|no) — re semantics: at most one
                    # top-level '|' (two branches), no-branch optional
                    self.i += 2
                    j = self.p.find(b")", self.i)
                    if j < 0:
                        raise self.error("unterminated conditional (?(id)")
                    raw = self.p[self.i : j]
                    name: str | None = None
                    if raw.isdigit():
                        idx = int(raw)
                        if idx == 0:
                            raise self.error("bad group number 0")
                        # deferred: re validates numeric conditional refs
                        # against the FINAL group count ((?(1)a|b)(x) is
                        # legal; the condition is just false there)
                        self.cond_refs.append((idx, self.i))
                    elif not raw:
                        raise self.error("missing group id in (?(id)")
                    else:
                        name = raw.decode("ascii", "replace")
                        if name not in self.group_names:
                            raise self.error(f"unknown group name {name!r}")
                        idx = self.group_names[name]
                    self.i = j + 1
                    yes = self.parse_cat()
                    no = None
                    if self.peek() == ord("|"):
                        self.eat()
                        no = self.parse_cat()
                    if self.peek() == ord("|"):
                        raise self.error(
                            "conditional backref with more than two branches"
                        )
                    if self.peek() != ord(")"):
                        raise self.error("unbalanced (")
                    self.eat()
                    return Cond(idx, yes, no, name)
                elif self.p[self.i : self.i + 3] == b"?P=":
                    self.i += 3
                    j = self.p.find(b")", self.i)
                    if j < 0:
                        raise self.error("unterminated (?P=name)")
                    name = self.p[self.i : j].decode("ascii", "replace")
                    if name not in self.group_names:
                        raise self.error(f"unknown group name {name!r}")
                    self.i = j + 1
                    return Backref(self.group_names[name], name)
                else:
                    # (?#..., conditionals, inline mid-pattern flags, ... —
                    # not implemented; never silently literal
                    raise self.error(
                        "unsupported (?...) construct (implemented: (?:...) "
                        "(?P<name>...) (?P=name) (?=...) (?!...) (?<=...) "
                        "(?<!...))"
                    )
            else:
                self.ngroups += 1
                capture = self.ngroups
            node = self.parse_alt()
            if self.peek() != ord(")"):
                raise self.error("unbalanced (")
            self.eat()
            return node if capture is None else Group(node, capture, name)
        if c == ord("["):
            return self.parse_class()
        if c == ord("."):
            self.eat()
            return Lit(_ALL if self.dotall else frozenset(_ALL - {ord("\n")}))
        if c == ord("\\"):
            if self.p[self.i + 1 : self.i + 2] in (b"b", b"B"):
                self.i += 2
                return Bound(negate=self.p[self.i - 1] == ord("B"))
            if self.p[self.i + 1 : self.i + 2] in (b"A", b"Z"):
                # \A = absolute buffer start, \Z = absolute buffer end (no
                # trailing-newline allowance, exactly Python re).  The Pike
                # VM already speaks these assertion kinds (whole-pattern
                # anchors lower to them); inside [...] they still raise.
                self.i += 2
                return Anchor(chr(self.p[self.i - 1]))
            nc = self.p[self.i + 1 : self.i + 2]
            if nc.isdigit() and nc != b"0":
                # \N / \NN backreference (atom context only; inside [...]
                # the class parser still rejects it).  Exactly re's digit
                # rule (sre_parse._escape): at most TWO digits form a group
                # number, except when the escape is three octal digits —
                # re reads that as an octal character escape, which this
                # byte-oriented parser does not support (use \xNN); it
                # raises rather than silently changing meaning.  The group
                # must already be open/closed to the LEFT (re rejects
                # forward plain backrefs too).
                self.i += 1  # consume backslash; now at the first digit
                digits = bytearray([self.eat()])
                if self.peek() is not None and self.peek() in _DIGITS:
                    digits.append(self.eat())
                    _oct = frozenset(b"01234567")
                    if (digits[0] in _oct and digits[1] in _oct
                            and self.peek() is not None
                            and self.peek() in _oct):
                        raise self.error(
                            "octal escapes (\\NNN) are not supported — "
                            "use \\xNN"
                        )
                idx = int(bytes(digits))
                if idx > self.ngroups:
                    raise self.error(f"invalid group reference {idx}")
                return Backref(idx)
            self.eat()
            return self.lit(self.parse_escape())
        if c in b"*+?":
            raise self.error("quantifier with nothing to repeat")
        if c == ord("^"):
            if self.multiline:
                self.eat()
                return Anchor("^")
            raise self.error(
                "'^' anchor only supported at pattern start (escape as \\^ "
                "for a literal caret, or use (?m) for line anchors)"
            )
        if c == ord("$"):
            if self.multiline:
                self.eat()
                return Anchor("$")
            raise self.error(
                "'$' anchor only supported at pattern end (escape as \\$ "
                "for a literal dollar, or use (?m) for line anchors)"
            )
        self.eat()
        return self.lit(frozenset({c}))

    def parse_escape(self):
        if self.peek() is None:
            raise self.error("trailing backslash")
        c = self.eat()
        simple = {
            ord("n"): b"\n", ord("t"): b"\t", ord("r"): b"\r",
            ord("f"): b"\f", ord("v"): b"\v", ord("0"): b"\0",
            # only reachable from class context: [\b] = backspace (as in re);
            # outside a class \b/\B are intercepted as Bound assertions
            ord("b"): b"\x08",
        }
        if c in simple:
            return frozenset(simple[c])
        if c == ord("x"):
            hx = self.p[self.i : self.i + 2]
            if len(hx) != 2:
                raise self.error("bad \\x escape")
            self.i += 2
            try:
                return frozenset({int(hx, 16)})
            except ValueError:
                raise self.error("bad \\x escape")
        classes = {
            ord("d"): _DIGITS, ord("D"): _ALL - _DIGITS,
            ord("w"): _WORD, ord("W"): _ALL - _WORD,
            ord("s"): _SPACE, ord("S"): _ALL - _SPACE,
        }
        if c in classes:
            return frozenset(classes[c])
        if c < 128 and chr(c).isalnum():
            # zero-width assertions (\b \B \A \Z) and other letter escapes
            # are not expressible in this byte-DFA compiler; treating them
            # as literals would silently change the pattern's meaning
            raise self.error(f"unsupported escape \\{chr(c)}")
        return frozenset({c})  # escaped literal metachar

    def parse_class(self):
        self.eat()  # [
        negate = False
        if self.peek() == ord("^"):
            negate = True
            self.eat()
        chars: set = set()
        first = True
        while True:
            c = self.peek()
            if c is None:
                raise self.error("unbalanced [")
            if c == ord("]") and not first:
                self.eat()
                break
            first = False
            if c == ord("\\"):
                self.eat()
                sub = self.parse_escape()
                if len(sub) > 1:
                    chars |= sub
                    continue
                lo = next(iter(sub))
            else:
                lo = self.eat()
            if self.peek() == ord("-") and self.i + 1 < len(self.p) and self.p[self.i + 1] != ord("]"):
                self.eat()
                if self.peek() == ord("\\"):
                    self.eat()
                    sub = self.parse_escape()
                    if len(sub) != 1:
                        raise self.error("bad class range")
                    hi = next(iter(sub))
                else:
                    hi = self.eat()
                if hi < lo:
                    raise self.error("bad class range")
                chars |= set(range(lo, hi + 1))
            else:
                chars.add(lo)
        folded = _casefold(frozenset(chars)) if self.fold else frozenset(chars)
        return Lit(frozenset(_ALL - folded) if negate else folded)


@dataclasses.dataclass(frozen=True)
class ParsedPattern:
    node: object
    start_anchored: bool
    end_anchored: bool
    ignore_case: bool
    num_groups: int = 0
    group_names: dict = dataclasses.field(default_factory=dict)
    multiline: bool = False


def _has_toplevel_alt(data: bytes) -> bool:
    """Unescaped ``|`` at group depth 0 outside a character class."""
    depth, i, in_class = 0, 0, False
    while i < len(data):
        c = data[i]
        if c == ord("\\"):
            i += 2
            continue
        if in_class:
            if c == ord("]"):
                in_class = False
        elif c == ord("["):
            in_class = True
        elif c == ord("("):
            depth += 1
        elif c == ord(")"):
            depth -= 1
        elif c == ord("|") and depth == 0:
            return True
        i += 1
    return False


def parse_pattern(pattern: str | bytes) -> ParsedPattern:
    """Parse a pattern, extracting the ``(?i)``/``(?s)``/``(?m)`` flags and
    whole-pattern anchors.  Without ``(?m)``, ``^``/``$`` anywhere but the
    pattern edges raise (they are never literals); under ``(?m)`` they
    parse as LINE anchors (``Anchor`` nodes) everywhere instead, routing
    the pattern to the host-verified path."""
    data = pattern.encode() if isinstance(pattern, str) else bytes(pattern)
    # pattern-prefix flag groups: (?i) (?s) (?m) (?ism) ... (whole-pattern)
    fold = dotall = multiline = False
    while data[:2] == b"(?":
        j = data.find(b")", 2)
        if j < 0 or not data[2:j] or any(c not in b"ism" for c in data[2:j]):
            break  # not a flag prefix — (?:, (?P<, (?= etc. parse normally
        fold |= ord("i") in data[2:j]
        dotall |= ord("s") in data[2:j]
        multiline |= ord("m") in data[2:j]
        data = data[j + 1 :]
    start_anchored = end_anchored = False
    if not multiline:
        # whole-pattern anchors; under (?m) the parser instead treats ^/$ as
        # LINE assertions everywhere (which still match buffer start/end)
        start_anchored = data[:1] == b"^"
        if start_anchored:
            data = data[1:]
        # trailing unescaped '$': count preceding backslashes (even = anchor)
        if data[-1:] == b"$":
            nbs = 0
            while nbs < len(data) - 1 and data[-2 - nbs] == ord("\\"):
                nbs += 1
            if nbs % 2 == 0:
                end_anchored = True
                data = data[:-1]
    if (start_anchored or end_anchored) and _has_toplevel_alt(data):
        raise RegexError(
            "anchor with a top-level alternation is ambiguous (anchors "
            "apply to the whole pattern) — group the alternation: "
            "^(?:a|b)$"
        )
    p = _Parser(data, fold=fold, dotall=dotall, multiline=multiline)
    node = p.parse_alt()
    if p.i != len(data):
        raise p.error("unexpected )")
    for idx, off in p.cond_refs:
        if idx > p.ngroups:
            raise RegexError(
                f"invalid group reference {idx} at offset {off} in {data!r}"
            )
    return ParsedPattern(
        node=node,
        start_anchored=start_anchored,
        end_anchored=end_anchored,
        ignore_case=fold,
        num_groups=p.ngroups,
        group_names=dict(p.group_names),
        multiline=multiline,
    )


def parse(pattern: str | bytes):
    """Bare-AST parse (no anchors permitted) — the ruleset-export path:
    the reference CSR format has no EOF concept (its engine scans forever,
    ``Design/FPGA.v:717-743``), so anchored patterns cannot round-trip."""
    pp = parse_pattern(pattern)
    if pp.start_anchored or pp.end_anchored:
        raise RegexError(
            "anchors are not supported here (CSR rulesets have no "
            "stream-end concept); use compile_pattern for anchored scans"
        )
    return pp.node


# ---------------------------------------------------------------------------
# Thompson construction: AST -> eps-NFA
# ---------------------------------------------------------------------------


class EpsNfa:
    """States 0..n-1; edges: list of (src, charset|None, dst); None = eps."""

    def __init__(self):
        self.n = 0
        self.edges: list[tuple[int, frozenset | None, int]] = []

    def new_state(self) -> int:
        self.n += 1
        return self.n - 1

    def add(self, src, charset, dst):
        self.edges.append((src, charset, dst))


def _build(nfa: EpsNfa, node) -> tuple[int, int]:
    """Returns (entry, exit) state pair for the fragment."""
    if isinstance(node, Lit):
        a, b = nfa.new_state(), nfa.new_state()
        nfa.add(a, node.chars, b)
        return a, b
    if isinstance(node, Cat):
        if not node.parts:
            a = nfa.new_state()
            return a, a
        first = _build(nfa, node.parts[0])
        cur = first
        for part in node.parts[1:]:
            nxt = _build(nfa, part)
            nfa.add(cur[1], None, nxt[0])
            cur = nxt
        return first[0], cur[1]
    if isinstance(node, Alt):
        a, b = nfa.new_state(), nfa.new_state()
        for opt in node.options:
            f = _build(nfa, opt)
            nfa.add(a, None, f[0])
            nfa.add(f[1], None, b)
        return a, b
    if isinstance(node, Rep):
        lo, hi = node.lo, node.hi
        if lo > 64 or (hi is not None and hi > 64):
            raise RegexError("repeat bound too large (>64)")
        a = nfa.new_state()
        cur = a
        for _ in range(lo):
            f = _build(nfa, node.node)
            nfa.add(cur, None, f[0])
            cur = f[1]
        if hi is None:  # unbounded tail: loop
            f = _build(nfa, node.node)
            nfa.add(cur, None, f[0])
            nfa.add(f[1], None, cur)
            return a, cur
        b = nfa.new_state()
        nfa.add(cur, None, b)
        for _ in range(hi - lo):
            f = _build(nfa, node.node)
            nfa.add(cur, None, f[0])
            cur = f[1]
            nfa.add(cur, None, b)
        return a, b
    if isinstance(node, Group):  # captures don't change the language
        return _build(nfa, node.node)
    if isinstance(node, (Bound, Anchor)):
        raise RegexError(
            "zero-width assertions (\\b/\\B, (?m) line anchors) are not "
            "expressible in the streaming DFA engines (accept would depend "
            "on the next byte); such patterns run on the host-verified "
            "path: search/match/fullmatch/finditer"
        )
    if isinstance(node, (Backref, Look, Cond)):
        raise RegexError(
            "backreferences, lookaround, and conditionals are not regular "
            "languages (or depend on runtime group state) and cannot "
            "compile to the device DFA/NFA engines; such patterns run on "
            "the host backtracking engine: search/match/fullmatch/"
            "finditer (api.compile_regex routes them automatically)"
        )
    raise TypeError(node)


def compile_nfa(pattern: str | bytes) -> tuple[EpsNfa, int, int]:
    nfa = EpsNfa()
    entry, exit_ = _build(nfa, parse(pattern))
    return nfa, entry, exit_


# ---------------------------------------------------------------------------
# subset construction + Hopcroft minimization
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CompiledDfa:
    """Dense DFA: ``table[b, s]`` next state on byte b; dead state included
    (absorbing, index ``dead``); ``accept`` marks accepting states."""

    table: np.ndarray   # (256, S) int32
    accept: np.ndarray  # (S,) bool — accept at any stream position
    start: int
    dead: int
    #: accept mask to apply to the FINAL state (end-of-stream).  ``None``
    #: means same as ``accept``; end-anchored patterns (trailing ``$``) set
    #: ``accept`` to all-False and carry the real mask here.
    accept_eof: np.ndarray | None = None

    @property
    def num_states(self) -> int:
        return self.table.shape[1]

    @property
    def eof_accept(self) -> np.ndarray:
        return self.accept if self.accept_eof is None else self.accept_eof


def nfa_to_dfa(
    nfa: EpsNfa, entry: int, exit_: int, max_states: int = 100_000
) -> CompiledDfa:
    # adjacency
    eps_adj: list[list[int]] = [[] for _ in range(nfa.n)]
    char_adj: list[list[tuple[frozenset, int]]] = [[] for _ in range(nfa.n)]
    for src, charset, dst in nfa.edges:
        if charset is None:
            eps_adj[src].append(dst)
        else:
            char_adj[src].append((charset, dst))

    def eclose(states: frozenset) -> frozenset:
        stack, seen = list(states), set(states)
        while stack:
            s = stack.pop()
            for t in eps_adj[s]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    start_set = eclose(frozenset({entry}))
    ids: dict[frozenset, int] = {start_set: 0}
    rows: dict[int, np.ndarray] = {}
    accept: list[bool] = [exit_ in start_set]
    work = [start_set]
    while work:
        cur = work.pop()
        sid = ids[cur]
        # successors per byte
        targets: list[set] = [set() for _ in range(256)]
        for s in cur:
            for charset, dst in char_adj[s]:
                for b in charset:
                    targets[b].add(dst)
        row = np.full(256, -1, dtype=np.int64)
        memo: dict[frozenset, int] = {}
        for b in range(256):
            if not targets[b]:
                continue
            key = frozenset(targets[b])
            if key in memo:
                row[b] = memo[key]
                continue
            nxt = eclose(key)
            if nxt not in ids:
                if len(ids) >= max_states:
                    raise DfaBlowupError(
                        f"subset construction exceeded {max_states} states"
                    )
                ids[nxt] = len(ids)
                accept.append(exit_ in nxt)
                work.append(nxt)
            row[b] = memo[key] = ids[nxt]
        rows[sid] = row

    n = len(ids)
    dead = n
    table = np.full((256, n + 1), dead, dtype=np.int32)
    for sid, row in rows.items():
        live = row >= 0
        table[live, sid] = row[live]
    accept_arr = np.array(accept + [False], dtype=bool)
    return CompiledDfa(table=table, accept=accept_arr, start=0, dead=dead)


def minimize_dfa(dfa: CompiledDfa) -> CompiledDfa:
    """Hopcroft minimization (partition refinement over the 256-byte alphabet)."""
    n = dfa.num_states
    table = dfa.table
    # initial partition: (accepting, accepting-at-eof) signature
    part = dfa.accept.astype(np.int64) * 2 + dfa.eof_accept.astype(np.int64)
    _, part = np.unique(part, return_inverse=True)
    nparts = len(np.unique(part))
    while True:
        # signature of each state: (own part, parts of successors on each byte)
        sig = part[table]  # (256, n)
        keys = np.concatenate([part[None, :], sig], axis=0).T  # (n, 257)
        _, part = np.unique(keys, axis=0, return_inverse=True)
        new_nparts = len(np.unique(part))
        if new_nparts == nparts:  # refinement only splits; equal count = fixpoint
            break
        nparts = new_nparts
    # rebuild
    m = int(part.max()) + 1
    reps = np.zeros(m, dtype=np.int64)
    reps[part] = np.arange(n)
    new_table = part[table[:, reps]].astype(np.int32)
    new_accept = dfa.accept[reps]
    return CompiledDfa(
        table=new_table,
        accept=new_accept,
        start=int(part[dfa.start]),
        dead=int(part[dfa.dead]),
        accept_eof=None if dfa.accept_eof is None else dfa.accept_eof[reps],
    )


def contains_bound(node) -> bool:
    """True if the AST contains a zero-width assertion — \\b/\\B or a
    (?m) line anchor (routes the pattern to the host Pike-VM path)."""
    if isinstance(node, (Bound, Anchor)):
        return True
    if isinstance(node, Cat):
        return any(contains_bound(p) for p in node.parts)
    if isinstance(node, Alt):
        return any(contains_bound(o) for o in node.options)
    if isinstance(node, (Rep, Group)):
        return contains_bound(node.node)
    if isinstance(node, Cond):
        return contains_bound(node.yes) or (
            node.no is not None and contains_bound(node.no)
        )
    return False


def contains_backtrack(node) -> bool:
    """True if the AST contains a backreference, lookaround, or conditional
    — features outside the regular languages (or outside streaming-DFA
    expressibility), routed to the host backtracking engine
    (``api.HostBacktrackMatcher``)."""
    if isinstance(node, (Backref, Look, Cond)):
        return True
    if isinstance(node, Cat):
        return any(contains_backtrack(p) for p in node.parts)
    if isinstance(node, Alt):
        return any(contains_backtrack(o) for o in node.options)
    if isinstance(node, (Rep, Group)):
        return contains_backtrack(node.node)
    return False


def strip_assertions(node):
    """Replace every zero-width assertion (``\\b``/``\\B``, (?m) line
    anchors) with epsilon.  Assertions only CONSTRAIN context, so the
    stripped pattern's language is a SUPERSET of the original's — a DFA
    compiled from it is a sound device prefilter for the host Pike-VM path
    (every true match span is also an envelope match span)."""
    if isinstance(node, (Bound, Anchor)):
        return Cat(())
    if isinstance(node, Cat):
        return Cat(tuple(strip_assertions(p) for p in node.parts))
    if isinstance(node, Alt):
        return Alt(tuple(strip_assertions(o) for o in node.options))
    if isinstance(node, (Rep, Group)):
        return dataclasses.replace(node, node=strip_assertions(node.node))
    if isinstance(node, Cond):
        return dataclasses.replace(
            node,
            yes=strip_assertions(node.yes),
            no=None if node.no is None else strip_assertions(node.no),
        )
    return node


def nullable(node) -> bool:
    """True if the AST matches the empty string (assertions count as
    epsilon).  A nullable envelope accepts at EVERY position — zero pruning
    power — so the prefilter path declines it."""
    if isinstance(node, Lit):
        return False
    if isinstance(node, Cat):
        return all(nullable(p) for p in node.parts)
    if isinstance(node, Alt):
        return any(nullable(o) for o in node.options)
    if isinstance(node, Rep):
        return node.lo == 0 or nullable(node.node)
    if isinstance(node, Group):
        return nullable(node.node)
    if isinstance(node, Cond):
        # conservative: nullable if EITHER branch is (branch choice depends
        # on runtime group state the static analysis cannot see)
        return nullable(node.yes) or node.no is None or nullable(node.no)
    return True  # Bound / Anchor


def contains_lazy(node) -> bool:
    """True if the AST contains a non-greedy quantifier (routes the pattern
    to the host Pike VM in leftmost-FIRST mode — span disambiguation is
    PCRE/Python, not POSIX-longest)."""
    if isinstance(node, Rep):
        return node.lazy or contains_lazy(node.node)
    if isinstance(node, Cat):
        return any(contains_lazy(p) for p in node.parts)
    if isinstance(node, Alt):
        return any(contains_lazy(o) for o in node.options)
    if isinstance(node, Group):
        return contains_lazy(node.node)
    if isinstance(node, Cond):
        return contains_lazy(node.yes) or (
            node.no is not None and contains_lazy(node.no)
        )
    return False


def required_literal(node) -> bytes | None:
    """Longest byte string guaranteed to appear contiguously in EVERY match
    of the AST — the Hyperscan-style prefilter key.

    Conservative by construction: returns None when no such literal exists
    (top-level alternation, case-folded letters under ``(?i)``, pure
    classes).  Soundness contract (tested property): if ``required_literal``
    returns L, then L is a substring of every string the pattern matches —
    so a stream NOT containing L cannot match and the pattern can be pruned
    by an Aho–Corasick prefilter (``api.compile_regex_set_prefiltered``).
    """
    best, run = _req_lit(node)
    cand = _longer(best, run)
    return cand if cand else None


def _longer(a: bytes | None, b: bytes | None) -> bytes | None:
    if a is None:
        return b
    if b is None:
        return a
    return a if len(a) >= len(b) else b


def _req_lit(node) -> tuple[bytes | None, bytes | None]:
    """Returns (best, exact): ``best`` = longest guaranteed substring found
    anywhere inside; ``exact`` = the ONE byte sequence this node always
    matches (joinable with neighbours inside a Cat), or None if the node
    can match more than one string.  Zero-width assertions are exact ``b""``
    (they do not interrupt byte adjacency)."""
    if isinstance(node, Lit):
        if len(node.chars) == 1:
            b = bytes([next(iter(node.chars))])
            return b, b
        return None, None
    if isinstance(node, (Bound, Anchor)):
        return None, b""  # zero-width: joins neighbouring runs
    if isinstance(node, Group):
        return _req_lit(node.node)
    if isinstance(node, Cat):
        best: bytes | None = None
        run: bytes | None = b""
        all_exact = True
        for part in node.parts:
            b, e = _req_lit(part)
            best = _longer(best, b)
            if e is None:
                all_exact = False
            if e is not None and run is not None:
                run += e
            else:
                best = _longer(best, run)
                run = e  # part's own exact seq starts a new run (or None)
        best = _longer(best, run)
        # the Cat matches exactly one string only if EVERY part did
        return best, (run if all_exact else None)
    if isinstance(node, Alt):
        if len(node.options) == 1:
            return _req_lit(node.options[0])
        return None, None  # no guarantee common to all branches (MVP)
    if isinstance(node, Cond):
        return None, None  # branch depends on runtime group state
    if isinstance(node, Rep):
        b, e = _req_lit(node.node)
        if node.lo == 0:
            return None, (b"" if node.hi == 0 else None)
        exact = e * node.lo if (e is not None and node.hi == node.lo) else None
        # lo >= 1: one copy of the body is guaranteed; e*lo is guaranteed
        # contiguous when every copy is the same exact sequence
        best = _longer(b, e * node.lo if e is not None else None)
        return best, exact
    raise TypeError(node)


def reverse_ast(node):
    """AST of the reversed language (for backward scans: a match of R ending
    at i in the stream is a match of reverse(R) starting at i in the
    reversed stream)."""
    if isinstance(node, Lit):
        return node
    if isinstance(node, Cat):
        return Cat(tuple(reverse_ast(p) for p in reversed(node.parts)))
    if isinstance(node, Alt):
        return Alt(tuple(reverse_ast(o) for o in node.options))
    if isinstance(node, Rep):
        return Rep(reverse_ast(node.node), node.lo, node.hi, node.lazy)
    if isinstance(node, Group):
        return Group(reverse_ast(node.node), node.index, node.name)
    if isinstance(node, Bound):
        return node  # a word boundary is symmetric under reversal
    if isinstance(node, Anchor):
        return Anchor("$" if node.kind == "^" else "^")  # line-start <-> end
    raise TypeError(node)


def compile_pattern(
    pattern: str | bytes,
    max_states: int = 100_000,
    minimize: bool = True,
    anchored: bool = True,
    reverse: bool = False,
    strip: bool = False,
) -> CompiledDfa:
    """Compile a pattern to a minimal dense DFA.

    ``strip=True`` compiles the assertion-stripped ENVELOPE (``\\b``/``\\B``
    and (?m) line anchors replaced by epsilon — a superset language), the
    device prefilter for host-routed patterns.

    ``anchored=True``: accept iff the whole input so far matches (fullmatch
    semantics).  ``anchored=False``: scanning DFA for ``.*pattern`` — accept
    at position i iff *some* match ends at i (the natural stream-scanning
    mode, matching the reference rulesets' unanchored hub structure).

    Whole-pattern anchors override: a leading ``^`` suppresses the ``.*``
    prefix even when ``anchored=False``; a trailing ``$`` moves the accept
    mask to ``accept_eof`` so matches only count at end of stream.
    ``reverse=True`` swaps the two anchors (a ``$`` becomes a start anchor
    of the reversed language and vice versa).
    """
    pp = parse_pattern(pattern)
    node = strip_assertions(pp.node) if strip else pp.node
    if reverse:
        node = reverse_ast(node)
        start_anchored, end_anchored = pp.end_anchored, pp.start_anchored
    else:
        start_anchored, end_anchored = pp.start_anchored, pp.end_anchored
    if not anchored and not start_anchored:
        node = Cat((Rep(Lit(frozenset(_ALL)), 0, None), node))
    nfa = EpsNfa()
    entry, exit_ = _build(nfa, node)
    dfa = nfa_to_dfa(nfa, entry, exit_, max_states=max_states)
    if end_anchored:
        dfa = dataclasses.replace(
            dfa,
            accept=np.zeros_like(dfa.accept),
            accept_eof=dfa.accept,
        )
    return minimize_dfa(dfa) if minimize else dfa
