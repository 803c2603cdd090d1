"""``regex_fpga_tpu_torch.re_compat``: a drop-in subset of Python's ``re``
module backed by the port's DFA engines on a CUDA card.

The counterpart of ``regex_fpga_tpu/re_compat.py``: ``compile``/``search``/
``match``/``fullmatch``/``findall``/``finditer``/``split``/``sub`` with
``re``-style signatures, including ``pos``/``endpos`` on the ``Pattern``
methods (``pos`` keeps lookbehind and boundary context and never lets ``^``
match mid-string; ``endpos`` truncates, exactly as ``re``), plus the
engine-native extras ``count`` (``grep -c`` throughput mode, the k-gram
engine) and ``scan``. ``compile`` and the module-level functions take a
keyword-only ``device=`` (default: the first CUDA card; ``"cpu"`` runs the
kernels' plain versions), which is part of the compile cache's key.

Semantics differences vs ``re`` (inherent to DFA matching):
  * spans are POSIX leftmost-LONGEST, not backtracking leftmost-first —
    ``ab|abc`` on ``"abc"`` matches ``abc`` here, ``ab`` in ``re``;
  * capture groups ARE tracked (``(...)``, ``(?P<name>...)``; group spans
    recovered host-side per match — ``models/captures.py``); WITHIN the
    fixed leftmost-longest span, group assignment is greedy like ``re``, so
    results agree whenever ``re`` picks the same span.  Backreferences
    (``\\1``-``\\99``, ``(?P=name)``), lookaround (``(?=)`` ``(?!)``
    ``(?<=)`` ``(?<!)``), and conditionals (``(?(id)yes|no)``) ARE
    supported — such patterns run the host backtracking engine
    (``api.HostBacktrackMatcher``) with exact Python ``re`` semantics
    (leftmost-first, fixed-width lookbehind), and their device-throughput
    extras raise; ``compile(..., max_steps=N)`` opts into a
    catastrophic-backtracking budget for them; ``\\1``/``\\g<name>`` in
    ``sub`` REPLACEMENT templates are supported everywhere;
  * ``\\b``/``\\B`` word boundaries ARE supported — such patterns run on the
    host Pike VM (``api.HostRegexMatcher``; same leftmost-longest spans);
    their device-throughput extras (``Pattern.scan``/``count``) raise;
  * patterns and subjects are byte-oriented: ``str`` input is UTF-8 encoded
    and spans are byte offsets.

Supported flags: ``IGNORECASE`` (ASCII folding, as ``(?i)``), ``DOTALL``
(``(?s)``), ``VERBOSE``/``X`` (whitespace + ``#`` comments stripped
outside classes), and ``MULTILINE`` (``(?m)`` — line anchors are zero-width
assertions, so multiline patterns run on the host Pike-VM path like
``\\b``).
"""

from __future__ import annotations

import functools

from .api import DfaMatcher, Match, compile_regex
from .models.regex import RegexError as error  # re.error analogue

__all__ = [
    "compile",
    "search",
    "match",
    "fullmatch",
    "findall",
    "finditer",
    "split",
    "sub",
    "subn",
    "count",
    "purge",
    "escape",
    "IGNORECASE",
    "I",
    "DOTALL",
    "S",
    "MULTILINE",
    "M",
    "VERBOSE",
    "X",
    "Pattern",
    "Match",
    "error",
]

IGNORECASE = I = 2  # values mirror re's flag constants for interchangeability
MULTILINE = M = 8
DOTALL = S = 16
VERBOSE = X = 64


def _strip_verbose(pat: bytes) -> bytes:
    """``re.X`` preprocessing: drop unescaped whitespace and ``#``-to-EOL
    comments outside character classes (inside ``[...]`` and after ``\\``
    everything is literal, as in ``re``)."""
    out = bytearray()
    i, n = 0, len(pat)
    in_class = False
    while i < n:
        c = pat[i]
        if c == 0x5C and i + 1 < n:  # backslash: escape copied verbatim
            out += pat[i : i + 2]
            i += 2
            continue
        if in_class:
            out.append(c)
            if c == 0x5D:
                in_class = False
            i += 1
            continue
        if c == 0x5B:
            in_class = True
            out.append(c)
            i += 1
            continue
        if c in b" \t\n\r\f\v":
            i += 1
            continue
        if c == 0x23:  # '#': comment to end of line
            while i < n and pat[i] != 0x0A:
                i += 1
            continue
        out.append(c)
        i += 1
    return bytes(out)


def escape(pattern):
    """``re.escape`` equivalent for this engine's byte-oriented syntax."""
    special = frozenset(b"\\.^$*+?{}[]|()")
    if isinstance(pattern, str):
        return "".join(
            "\\" + c if ord(c) < 128 and ord(c) in special else c
            for c in pattern
        )
    return b"".join(
        b"\\" + bytes([c]) if c in special else bytes([c]) for c in pattern
    )


def _has_backrefs(template: bytes) -> bool:
    return b"\\" in template


def _expand(template: bytes, m: Match) -> bytes:
    """Expand a ``re.sub``-style replacement template against a Match:
    ``\\1``..``\\99``, ``\\g<name>``, ``\\g<num>`` (incl. ``\\g<0>``), and
    the escapes ``\\\\ \\n \\t \\r \\f \\v``.  Unmatched groups expand
    to the empty string (Python 3.7+ ``re.sub`` behavior)."""
    out = bytearray()
    i = 0
    n = len(template)
    esc = {ord("n"): b"\n", ord("t"): b"\t", ord("r"): b"\r",
           ord("f"): b"\f", ord("v"): b"\v", ord("\\"): b"\\"}
    while i < n:
        c = template[i]
        if c != ord("\\"):
            out.append(c)
            i += 1
            continue
        if i + 1 >= n:
            raise error("bad escape (end of pattern) in replacement")
        d = template[i + 1]
        if d in esc:
            out += esc[d]
            i += 2
        elif d == ord("0"):
            out.append(0)  # \0 is an octal NUL escape in re templates
            i += 2
        elif ord("1") <= d <= ord("9"):
            j = i + 1
            num = 0
            while j < n and j < i + 3 and ord("0") <= template[j] <= ord("9"):
                num = num * 10 + (template[j] - ord("0"))
                j += 1
            out += m.group(num) or b""
            i = j
        elif d == ord("g"):
            if template[i + 2 : i + 3] != b"<":
                raise error("missing < after \\g in replacement")
            j = template.find(b">", i + 3)
            if j < 0:
                raise error("missing >, unterminated \\g<...> in replacement")
            name = template[i + 3 : j].decode("ascii", "replace")
            key: int | str = int(name) if name.isdigit() else name
            out += m.group(key) or b""
            i = j + 1
        else:
            raise error(f"bad escape \\{chr(d)} in replacement")
    return bytes(out)


class Pattern:
    """Compiled pattern wrapper; see module docstring for semantics."""

    def __init__(self, pattern: str | bytes, flags: int = 0,
                 max_steps: int | None = None, *, device=None):
        if flags & ~(IGNORECASE | DOTALL | MULTILINE | VERBOSE):
            raise ValueError(
                f"unsupported flags {flags:#x}: only IGNORECASE, DOTALL, "
                "MULTILINE and VERBOSE are implemented"
            )
        self._text_mode = isinstance(pattern, str)
        pat = pattern.encode("utf-8") if self._text_mode else bytes(pattern)
        if flags & VERBOSE:
            pat = _strip_verbose(pat)
        if flags & MULTILINE:
            pat = b"(?m)" + pat
        if flags & DOTALL:
            pat = b"(?s)" + pat
        if flags & IGNORECASE:
            pat = b"(?i)" + pat
        self.pattern = pattern
        self.flags = flags
        #: ``max_steps`` (engine extra, keyword-only via compile): bounds
        #: the BACKTRACKING engine's per-search work; exceeding it raises
        #: ``models.backtrack.BacktrackLimitExceeded`` (a subclass of
        #: ``error``).  No effect on the linear-time DFA/Pike-VM routes.
        self._m: DfaMatcher = compile_regex(pat, max_steps=max_steps,
                                            device=device)

    @property
    def groups(self) -> int:
        return self._m.num_groups

    @property
    def groupindex(self) -> dict:
        bt = getattr(self._m, "_bt", None)  # backtracking engine patterns
        if bt is not None:
            return dict(bt.group_names)
        self._m._make_match(b"", 0, 0)  # force lazy capture-program build
        prog = self._m._capture_prog
        return {} if prog is False else dict(prog.group_names)

    # -- helpers ---------------------------------------------------------
    def _enc(self, data):
        return data.encode("utf-8") if isinstance(data, str) else data

    def _dec(self, b: bytes):
        return b.decode("utf-8", errors="surrogateescape") if self._text_mode else b

    def _attach(self, m):
        """Stamp ``Match.re`` (re parity) with this Pattern."""
        if m is not None:
            m.re = self
        return m

    # -- re API ----------------------------------------------------------
    def search(self, string, pos: int = 0,
               endpos: int | None = None) -> Match | None:
        return self._attach(self._m.search(self._enc(string), pos, endpos))

    def match(self, string, pos: int = 0,
              endpos: int | None = None) -> Match | None:
        return self._attach(self._m.match(self._enc(string), pos, endpos))

    def fullmatch(self, string, pos: int = 0,
                  endpos: int | None = None) -> Match | None:
        return self._attach(
            self._m.fullmatch(self._enc(string), pos, endpos))

    def finditer(self, string, pos: int = 0, endpos: int | None = None):
        raw = self._enc(string)
        if pos or endpos is not None:
            clipped = raw if endpos is None else raw[:max(endpos, 0)]
            cpos = min(max(int(pos), 0), len(raw))
            for a, b in self._m.finditer(raw, pos=pos, endpos=endpos):
                m = self._attach(self._m._make_match(clipped, a, b))
                m.pos = cpos
                yield m
            return
        for m in self._m.finditer_matches(raw):
            yield self._attach(m)

    def findall(self, string, pos: int = 0,
                endpos: int | None = None) -> list:
        """``re.findall`` group semantics: 0 groups → list of matches;
        1 group → list of group 1; n groups → list of n-tuples."""
        ng = self._m.num_groups
        if ng == 0:
            raw = self._enc(string)
            if pos or endpos is not None:
                clipped = (raw if endpos is None
                           else raw[:max(endpos, 0)])
                return [
                    self._dec(clipped[a:b])
                    for a, b in self._m.finditer(raw, pos=pos,
                                                 endpos=endpos)
                ]
            return [self._dec(g) for g in self._m.findall(raw)]
        out = []
        for m in self.finditer(string, pos, endpos):
            gs = tuple(
                self._dec(g) if g is not None else self._dec(b"")
                for g in m.groups()
            )
            out.append(gs[0] if ng == 1 else gs)
        return out

    def split(self, string, maxsplit: int = 0) -> list:
        """``re.split`` semantics incl. captured groups appearing in the
        result list (None for unmatched groups)."""
        if self._m.num_groups == 0:
            return [
                self._dec(p) for p in self._m.split(self._enc(string), maxsplit)
            ]
        raw = self._enc(string)
        out: list = []
        p = 0
        n = 0
        for m in self._m.finditer_matches(raw):
            if maxsplit and n >= maxsplit:
                break
            a, b = m.span()
            out.append(self._dec(raw[p:a]))
            out.extend(
                None if g is None else self._dec(g) for g in m.groups()
            )
            p = b
            n += 1
        out.append(self._dec(raw[p:]))
        return out

    def sub(self, repl, string, count: int = 0):
        return self.subn(repl, string, count)[0]

    def subn(self, repl, string, count: int = 0):
        if callable(repl):
            f = repl
            r = lambda m: self._enc(f(m))  # noqa: E731
        else:
            template = self._enc(repl)
            if _has_backrefs(template):
                r = lambda m: _expand(template, m)  # noqa: E731
            else:
                r = template
        out, n = self._m.subn(r, self._enc(string), count)
        return self._dec(out), n

    # -- engine-native extras -------------------------------------------
    def count(self, string) -> int:
        """Total match-end count at k-gram engine throughput (``grep -c``)."""
        return self._m.count(self._enc(string))

    def scan(self, string):
        """Full per-state ScanReport from the fast DFA engine."""
        return self._m.scan(self._enc(string))

    def __repr__(self) -> str:
        return f"re_compat.compile({self.pattern!r})"


@functools.lru_cache(maxsize=512)
def _compile_cached(pattern, flags: int, max_steps: int | None,
                    device) -> Pattern:
    return Pattern(pattern, flags, max_steps=max_steps, device=device)


def compile(pattern, flags: int = 0,  # noqa: A001 (re parity)
            max_steps: int | None = None, *, device=None) -> Pattern:
    """``re.compile`` equivalent.  ``max_steps`` (engine extra): opt-in
    catastrophic-backtracking budget for backreference/lookaround/
    conditional patterns — see ``Pattern``. ``device``: where the
    pattern's tables live and its scans run."""
    return _compile_cached(pattern, flags, max_steps, device)


def purge() -> None:
    _compile_cached.cache_clear()


def search(pattern, string, flags: int = 0, *, device=None):
    return compile(pattern, flags, device=device).search(string)


def match(pattern, string, flags: int = 0, *, device=None):
    return compile(pattern, flags, device=device).match(string)


def fullmatch(pattern, string, flags: int = 0, *, device=None):
    return compile(pattern, flags, device=device).fullmatch(string)


def findall(pattern, string, flags: int = 0, *, device=None):
    return compile(pattern, flags, device=device).findall(string)


def finditer(pattern, string, flags: int = 0, *, device=None):
    return compile(pattern, flags, device=device).finditer(string)


def split(pattern, string, maxsplit: int = 0, flags: int = 0, *, device=None):
    return compile(pattern, flags, device=device).split(string, maxsplit)


def sub(pattern, repl, string, count: int = 0, flags: int = 0, *,
        device=None):
    return compile(pattern, flags, device=device).sub(repl, string, count)


def subn(pattern, repl, string, count: int = 0, flags: int = 0, *,
         device=None):
    return compile(pattern, flags, device=device).subn(repl, string, count)


def count(pattern, string, flags: int = 0, *, device=None) -> int:
    return compile(pattern, flags, device=device).count(string)
