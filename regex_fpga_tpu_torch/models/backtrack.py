"""Host backtracking regex engine: backreferences, lookaround, conditionals.

Backreferences make a pattern non-regular (the copy language), and
lookaround needs to consult bytes past the current position — neither fits
the device DFA/NFA engines or the tagged Pike VM (``models/captures.py``),
whose thread-merge step is only sound when the future is a function of
(state, position).  Patterns containing either therefore run on this
classic recursive-descent backtracker with **Python ``re`` semantics**:
leftmost-FIRST disambiguation, greedy/lazy quantifier ordering, fixed-width
lookbehind, capture persistence out of positive lookahead, and the empty-
match iteration rules (validated by a directed + fuzz suite against ``re``
itself, ``tests/test_backtrack.py``).

This is deliberately the one engine family with super-linear worst cases
(catastrophic backtracking exists in every backtracking engine, including
``re``); everything device-routed stays linear.  The opt-in ``max_steps``
budget (default None = unlimited, strict ``re`` parity) bounds a hostile
pattern x input pair to a prompt ``BacktrackLimitExceeded`` instead of an
indefinite hang — exposed through ``api.HostBacktrackMatcher`` and
``re_compat.compile(..., max_steps=)``.  The reference has no
regex front-end at all (SURVEY.md §0 — pure RTL), so this layer is part of
the "usable framework" surface built on top of its semantics, like the
rest of the ``re``-compat stack.

Compilation: each AST node lowers once to a closure
``f(data, pos, k) -> end | None`` where ``k(pos2)`` is the continuation;
group state lives in a shared list the closures save/restore around
backtracking.
"""

from __future__ import annotations

from .regex import (
    Alt, Anchor, Backref, Bound, Cat, Cond, Group, Lit, Look, ParsedPattern,
    RegexError, Rep, parse_pattern,
)

__all__ = ["BacktrackProgram", "BacktrackLimitExceeded"]


class BacktrackLimitExceeded(RegexError):
    """The engine exceeded its opt-in ``max_steps`` budget.

    Raised only when a budget was requested (``max_steps=None``, the
    default, is unlimited — strict ``re`` parity).  A bounded budget turns
    catastrophic backtracking (hostile pattern x input pairs like
    ``(a+)+b`` on ``'a'*n``) from an indefinite hang into a prompt,
    catchable failure — the mitigation an IDS-facing deployment should
    enable."""

_WORD = frozenset(
    list(range(ord("a"), ord("z") + 1))
    + list(range(ord("A"), ord("Z") + 1))
    + list(range(ord("0"), ord("9") + 1))
    + [ord("_")]
)


def _width(node) -> tuple[int, int | None]:
    """(min, max) matched byte width; max None = unbounded."""
    if isinstance(node, Lit):
        return 1, 1
    if isinstance(node, Cat):
        lo = hi = 0
        for p in node.parts:
            a, b = _width(p)
            lo += a
            hi = None if (hi is None or b is None) else hi + b
        return lo, hi
    if isinstance(node, Alt):
        ws = [_width(o) for o in node.options]
        los = [a for a, _ in ws]
        his = [b for _, b in ws]
        return min(los), (None if any(b is None for b in his) else max(his))
    if isinstance(node, Rep):
        a, b = _width(node.node)
        return (a * node.lo,
                None if (b is None or node.hi is None) else b * node.hi)
    if isinstance(node, Group):
        return _width(node.node)
    if isinstance(node, Backref):
        return 0, None  # depends on what the group captured
    if isinstance(node, Cond):
        ys = _width(node.yes)
        ns = _width(node.no) if node.no is not None else (0, 0)
        lo = min(ys[0], ns[0])
        hi = None if (ys[1] is None or ns[1] is None) else max(ys[1], ns[1])
        return lo, hi
    return 0, 0  # Bound / Anchor / Look are zero-width


def _det_width(node) -> int | None:
    """Fixed byte width ``w`` if the node matches DETERMINISTICALLY: at any
    position it either fails or succeeds with the unique end ``pos + w``
    and no observable side effects (no captures, no backrefs, no
    lookaround).  Such a node inside a quantifier needs no per-iteration
    continuation — the iterative Rep path uses this to avoid the
    one-stack-frame-per-iteration recursion that overflows on long inputs
    (e.g. ``(?:ab)+`` over kilobytes).  Returns None when the node is not
    provably deterministic."""
    if isinstance(node, Lit):
        return 1
    if isinstance(node, Cat):
        total = 0
        for p in node.parts:
            w = _det_width(p)
            if w is None:
                return None
            total += w
        return total
    if isinstance(node, Alt):
        # equal-width capture-free branches: first-match-wins cannot change
        # the end position, so the node is observably deterministic
        ws = [_det_width(o) for o in node.options]
        if any(w is None for w in ws) or len(set(ws)) != 1:
            return None
        return ws[0]
    if isinstance(node, Rep):
        if node.hi is None or node.hi != node.lo:
            return None
        w = _det_width(node.node)
        return None if w is None else w * node.lo
    if isinstance(node, (Bound, Anchor)):
        return 0  # zero-width deterministic predicates
    return None  # Group / Backref / Look / Cond


class BacktrackProgram:
    """Compiled backtracking matcher for one parsed pattern."""

    def __init__(self, pattern_or_parsed, max_steps: int | None = None):
        pp = (pattern_or_parsed
              if isinstance(pattern_or_parsed, ParsedPattern)
              else parse_pattern(pattern_or_parsed))
        self.pp = pp
        self.num_groups = pp.num_groups
        self.group_names = dict(pp.group_names)
        self._fold = pp.ignore_case
        self._multiline = pp.multiline
        # groups[i] = (start, end, seq) | None; seq orders lastindex
        self._groups: list = [None] * (pp.num_groups + 1)
        self._seq = 0
        self._data = b""
        #: opt-in backtracking budget: None (default) = unlimited, exact
        #: ``re`` parity.  A bounded value counts engine steps (byte tests,
        #: quantifier continuation tries, backref compares) per
        #: ``search_spans``/``match_at`` call and raises
        #: ``BacktrackLimitExceeded`` when exhausted — bounded-time defense
        #: against catastrophic backtracking.
        self.max_steps = max_steps
        self._steps = 0
        self._body = self._compile(pp.node)

    def _tick(self):
        if self.max_steps is not None:
            self._steps += 1
            if self._steps > self.max_steps:
                raise BacktrackLimitExceeded(
                    f"backtracking exceeded max_steps={self.max_steps} "
                    f"(catastrophic backtracking guard; raise or disable "
                    f"the budget for exhaustive search)"
                )

    # -- node lowering ---------------------------------------------------

    def _compile(self, node):
        if isinstance(node, Lit):
            chars = node.chars

            def f(d, p, k, chars=chars):
                if self.max_steps is not None:
                    self._tick()
                return k(p + 1) if p < len(d) and d[p] in chars else None

            return f
        if isinstance(node, Cat):
            fs = [self._compile(p) for p in node.parts]

            def f(d, p, k, fs=fs):
                def step(i, p2):
                    if i == len(fs):
                        return k(p2)
                    return fs[i](d, p2, lambda p3, i=i: step(i + 1, p3))

                return step(0, p)

            return f
        if isinstance(node, Alt):
            fs = [self._compile(o) for o in node.options]

            def f(d, p, k, fs=fs):
                for sub in fs:
                    r = sub(d, p, k)
                    if r is not None:
                        return r
                return None

            return f
        if isinstance(node, Rep) and isinstance(node.node, Lit):
            # iterative fast path: a repeated character class needs no
            # per-iteration recursion (the general path recurses once per
            # byte, which would hit Python's recursion limit on long runs)
            chars = node.node.chars
            lo, hi, lazy = node.lo, node.hi, node.lazy

            def f(d, p, k, chars=chars, lo=lo, hi=hi, lazy=lazy):
                n = len(d)
                m = 0
                limit = n - p if hi is None else min(hi, n - p)
                while m < limit and d[p + m] in chars:
                    m += 1
                if m < lo:
                    return None
                counts = range(lo, m + 1) if lazy else range(m, lo - 1, -1)
                for cnt in counts:
                    if self.max_steps is not None:
                        self._tick()
                    r = k(p + cnt)
                    if r is not None:
                        return r
                return None

            return f
        if isinstance(node, Rep) and (_det_width(node.node) or 0) > 0:
            # iterative path for deterministic fixed-width sub-patterns
            # (e.g. ``(?:ab)+``, ``(?:foo|bar)+``): each iteration has a
            # unique end and no observable state, so the choice point is
            # ONLY the repeat count — match greedily with an identity
            # continuation, then offer counts to the continuation in
            # greedy/lazy order.  Avoids the general path's one recursion
            # level per iteration (RecursionError on kilobyte repeats).
            sub = self._compile(node.node)
            lo, hi, lazy = node.lo, node.hi, node.lazy

            def f(d, p, k, sub=sub, lo=lo, hi=hi, lazy=lazy):
                ident = lambda p2: p2  # noqa: E731
                ends = [p]
                cur = p
                while hi is None or len(ends) - 1 < hi:
                    r = sub(d, cur, ident)
                    if r is None:
                        break
                    cur = r
                    ends.append(cur)
                m = len(ends) - 1
                if m < lo:
                    return None
                counts = range(lo, m + 1) if lazy else range(m, lo - 1, -1)
                for cnt in counts:
                    if self.max_steps is not None:
                        self._tick()
                    r = k(ends[cnt])
                    if r is not None:
                        return r
                return None

            return f
        if isinstance(node, Rep):
            sub = self._compile(node.node)
            lo, hi, lazy = node.lo, node.hi, node.lazy

            def f(d, p, k, sub=sub, lo=lo, hi=hi, lazy=lazy):
                def rep(count, p2):
                    if self.max_steps is not None:
                        self._tick()
                    can_more = hi is None or count < hi
                    done_ok = count >= lo

                    def again(p3, count=count, p2=p2):
                        if p3 == p2 and count + 1 >= lo:
                            # empty iteration past the minimum: stop
                            # looping (re's empty-repeat rule)
                            return k(p3)
                        return rep(count + 1, p3)

                    if lazy:
                        if done_ok:
                            r = k(p2)
                            if r is not None:
                                return r
                        return sub(d, p2, again) if can_more else None
                    if can_more:
                        r = sub(d, p2, again)
                        if r is not None:
                            return r
                    return k(p2) if done_ok else None

                return rep(0, p)

            return f
        if isinstance(node, Group):
            sub = self._compile(node.node)
            idx = node.index

            def f(d, p, k, sub=sub, idx=idx):
                old = self._groups[idx]

                def k2(p2):
                    self._seq += 1
                    self._groups[idx] = (p, p2, self._seq)
                    r = k(p2)
                    if r is None:
                        self._groups[idx] = old
                    return r

                r = sub(d, p, k2)
                if r is None:
                    self._groups[idx] = old
                return r

            return f
        if isinstance(node, Backref):
            idx = node.index
            fold = self._fold

            def f(d, p, k, idx=idx, fold=fold):
                if self.max_steps is not None:
                    self._tick()
                g = self._groups[idx]
                if g is None:
                    return None  # unmatched group: backref fails (as in re)
                ref = d[g[0] : g[1]]
                cand = d[p : p + len(ref)]
                if len(cand) != len(ref):
                    return None
                if cand != ref and not (
                    fold and cand.lower() == ref.lower()
                ):
                    return None
                return k(p + len(ref))

            return f
        if isinstance(node, Bound):
            neg = node.negate

            def f(d, p, k, neg=neg):
                before = p > 0 and d[p - 1] in _WORD
                after = p < len(d) and d[p] in _WORD
                return k(p) if (before != after) != neg else None

            return f
        if isinstance(node, Anchor):
            kind = node.kind

            def f(d, p, k, kind=kind):
                if kind == "^":
                    ok = p == 0 or d[p - 1] == 0x0A
                elif kind == "$":
                    ok = p == len(d) or d[p] == 0x0A
                elif kind == "A":
                    ok = p == 0
                else:  # "Z": absolute end, no trailing-newline allowance
                    ok = p == len(d)
                return k(p) if ok else None

            return f
        if isinstance(node, Look):
            sub = self._compile(node.node)
            if node.behind:
                wlo, whi = _width(node.node)
                if whi is None or wlo != whi:
                    raise RegexError(
                        "look-behind requires a fixed-width sub-pattern "
                        "(same rule as Python re)"
                    )
                w = wlo

                def f(d, p, k, sub=sub, w=w, neg=node.negate):
                    snap = list(self._groups)
                    hit = (p - w >= 0 and
                           sub(d, p - w, lambda p2: p2 if p2 == p else None)
                           is not None)
                    if hit == neg:
                        self._groups[:] = snap
                        return None
                    if neg:  # captures inside a failed branch don't leak
                        self._groups[:] = snap
                    r = k(p)
                    if r is None:
                        # captures made inside a SUCCESSFUL positive look
                        # persist only while this path is alive; when the
                        # continuation fails they must not leak into
                        # sibling alternatives (re parity — advisor r3)
                        self._groups[:] = snap
                    return r

                return f

            def f(d, p, k, sub=sub, neg=node.negate):
                snap = list(self._groups)
                hit = sub(d, p, lambda p2: p2) is not None
                if hit == neg:
                    self._groups[:] = snap
                    return None
                if neg:
                    self._groups[:] = snap
                r = k(p)
                if r is None:
                    self._groups[:] = snap  # see lookbehind note above
                return r

            return f
        if isinstance(node, Cond):
            yes = self._compile(node.yes)
            no = self._compile(node.no) if node.no is not None else None
            idx = node.index

            def f(d, p, k, yes=yes, no=no, idx=idx):
                # (?(id)yes|no): branch on whether the group has matched so
                # far; absent no-branch = epsilon (re semantics).  No
                # backtracking BETWEEN branches — the condition picks one.
                if self._groups[idx] is not None:
                    return yes(d, p, k)
                return no(d, p, k) if no is not None else k(p)

            return f
        raise TypeError(node)

    # -- matching --------------------------------------------------------

    def match_at(self, data: bytes, pos: int, full: bool = False,
                 _fresh_budget: bool = True, ban_empty: bool = False):
        """Leftmost-first anchored match at ``pos``: returns
        ``(end, groups, lastindex)`` with ``groups[i] = (start, end) |
        None`` and ``groups[0]`` the whole span, or None.  Honors the
        pattern's whole-pattern ``$``; ``full=True`` additionally requires
        the match to consume the whole buffer (``re.fullmatch`` — the
        engine backtracks into shorter-preferred alternatives to reach
        end-of-buffer).  Each call gets a fresh ``max_steps`` budget
        (``search_spans`` shares ONE budget across its start positions).
        ``ban_empty=True`` refuses the empty match at ``pos`` (the engine
        then backtracks into a NON-empty alternative if one exists) — the
        piece of Python 3.7+'s finditer empty-match rule the iteration
        loops need."""
        if _fresh_budget:
            self._steps = 0
        self._groups = [None] * (self.num_groups + 1)
        self._seq = 0
        if full or self.pp.end_anchored:
            end_ok = lambda p2: p2 == len(data)  # noqa: E731
        else:
            end_ok = lambda p2: True  # noqa: E731
        if ban_empty:
            k = lambda p2: (p2 if p2 != pos and end_ok(p2)
                            else None)  # noqa: E731
        else:
            k = lambda p2: p2 if end_ok(p2) else None  # noqa: E731
        try:
            end = self._body(data, pos, k)
        except RecursionError:
            raise RegexError(
                "backtracking recursion depth exceeded: a quantifier over "
                "a capturing/backreferencing sub-pattern recurses once per "
                "iteration (deterministic fixed-width bodies run "
                "iteratively and are unaffected); shorten the input, "
                "simplify the repeated body, or raise "
                "sys.setrecursionlimit"
            ) from None
        if end is None:
            return None
        groups = [(pos, end)] + [
            (g[0], g[1]) if g is not None else None
            for g in self._groups[1:]
        ]
        seqs = [(g[2], i) for i, g in enumerate(self._groups) if i and g]
        lastindex = max(seqs)[1] if seqs else None
        return end, groups, lastindex

    def search_spans(self, data: bytes, start_at: int = 0,
                     ban_empty_at: int = -1):
        """Leftmost match at/after ``start_at`` (None if none).  One
        ``max_steps`` budget covers the WHOLE search (all start
        positions), so a bounded budget bounds total work, not
        per-position work.  ``ban_empty_at``: position where an empty
        match was already emitted — the empty match THERE is refused
        (non-empty ones still win), Python 3.7+ iteration rule."""
        self._steps = 0
        n = len(data)
        last = 0 if self.pp.start_anchored else n
        for s in range(start_at, min(last, n) + 1):
            m = self.match_at(data, s, _fresh_budget=False,
                              ban_empty=(s == ban_empty_at))
            if m is not None:
                return (s,) + m
        return None

    def finditer_spans(self, data: bytes, start_at: int = 0):
        """Non-overlapping (start, end) spans, Python 3.7+ ``re``
        iteration rules: after an empty match at q the search resumes AT
        q with only the empty match at q banned — a non-empty match at
        the same position must still be findable (``re.finditer`` of
        ``(a)?(?(1)|b??)`` on ``b"b"`` yields (0,0), (0,1), (1,1)).
        ``start_at`` is re's ``Pattern.finditer`` pos (context before it
        stays visible to lookbehind/boundaries)."""
        out = []
        pos, ban = start_at, -1
        n = len(data)
        while pos <= n:
            m = self.search_spans(data, pos, ban_empty_at=ban)
            if m is None:
                break
            s, e = m[0], m[1]
            out.append((s, e))
            if self.pp.start_anchored:
                break
            pos = e
            ban = e if s == e else -1
            if s == e and e == n:
                break  # trailing empty emitted; nothing can follow
        return out
