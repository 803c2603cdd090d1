"""l7-filter ``.pat`` protocol-pattern files — the upstream source format.

The reference's ``CSR_BlockMem.coe`` ruleset is compiled from l7-filter
protocol patterns (the ruleset name "l-7_filter" in the shipped trace files,
``Simulation/input_trace_lo_l-7_filter.mem``); the compiler that produced it
was never published (SURVEY.md SS0: the reference repo has no software at
all).  This module reads the public ``.pat`` format so users can go straight
from upstream pattern files to a scannable ruleset:

    file format (l7-filter userspace/kernel convention):
      - ``#`` comment lines and blank lines are skipped
      - first significant line: protocol name
      - next significant line: the regex (POSIX-ish, byte escapes ``\\xNN``)
      - optional attribute lines (``userspace pattern=...``,
        ``userspace flags=...``) override the pattern/flags for
        userspace matchers — honored here since this IS a userspace matcher

l7-filter matches case-insensitively when the ``REG_ICASE`` flag is given;
that maps to this compiler's ``(?i)`` prefix.
"""

from __future__ import annotations

import dataclasses
import os

__all__ = ["L7Pattern", "parse_l7_pattern", "load_l7_pattern", "load_l7_dir"]


@dataclasses.dataclass(frozen=True)
class L7Pattern:
    name: str
    pattern: str
    ignore_case: bool = False

    @property
    def compile_pattern(self) -> str:
        """Pattern string for ``api.compile_regex`` / ``compile_regex_set``."""
        return ("(?i)" if self.ignore_case else "") + self.pattern


def parse_l7_pattern(text: str, name_hint: str = "") -> L7Pattern:
    name = None
    pattern = None
    ignore_case = False
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("userspace pattern="):
            pattern = line.split("=", 1)[1]
        elif line.startswith("userspace flags="):
            ignore_case = "REG_ICASE" in line
        elif name is None:
            name = line
        elif pattern is None:
            pattern = line
    if name is None or pattern is None:
        raise ValueError(
            f"not an l7-filter pattern file: {name_hint or text[:40]!r}"
        )
    return L7Pattern(name=name, pattern=pattern, ignore_case=ignore_case)


def load_l7_pattern(path: str) -> L7Pattern:
    with open(path, "r", encoding="latin-1") as f:
        return parse_l7_pattern(f.read(), name_hint=path)


def load_l7_dir(path: str) -> list[L7Pattern]:
    """Load every ``*.pat`` in a directory (one protocol per file)."""
    out = []
    for fn in sorted(os.listdir(path)):
        if fn.endswith(".pat"):
            out.append(load_l7_pattern(os.path.join(path, fn)))
    return out
