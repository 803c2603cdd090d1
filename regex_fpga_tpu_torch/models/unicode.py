"""The Unicode data of the regex compiler's UTF-8 mode, as code-point ranges.

The tables are committed data (``unicode_15_0_0.json`` beside this file), so
an automaton compiled in UTF-8 mode is the same whatever Python builds it:

- ``L`` and ``N``: the general-category groups ``\\p{L}`` (Lu Ll Lt Lm Lo)
  and ``\\p{N}`` (Nd Nl No) of Unicode 15.0.0;
- ``White_Space``: the 25 code points of PropList.txt's White_Space, which
  ``\\s`` means in UTF-8 mode (the ``regex`` module's ``\\s``; Python's
  ``str.isspace`` also takes U+001C-U+001F);
- ``simple_fold``: (code point, its simple case folding) for every code
  point that folds to another, the folding ``(?i:...)`` applies.

``generate()`` rebuilds them from ``unicodedata`` when that module carries
Unicode 15.0.0 (Python 3.12):

    python -m regex_fpga_tpu_torch.models.unicode  # rewrites the JSON file
"""

from __future__ import annotations

import bisect
import functools
import json
import os

__all__ = ["VERSION", "WHITE_SPACE", "tables", "generate", "ranges_of",
           "in_ranges", "fold_orbits"]

VERSION = "15.0.0"
_PATH = os.path.join(os.path.dirname(__file__), "unicode_15_0_0.json")
MAX_CP = 0x10FFFF

#: PropList.txt's White_Space property (stable since Unicode 6.3)
WHITE_SPACE = ((0x09, 0x0D), (0x20, 0x20), (0x85, 0x85), (0xA0, 0xA0),
               (0x1680, 0x1680), (0x2000, 0x200A), (0x2028, 0x2029),
               (0x202F, 0x202F), (0x205F, 0x205F), (0x3000, 0x3000))


def ranges_of(points) -> list[tuple[int, int]]:
    """Sorted code points -> merged inclusive (lo, hi) ranges."""
    out: list[list[int]] = []
    for c in points:
        if out and c == out[-1][1] + 1:
            out[-1][1] = c
        else:
            out.append([c, c])
    return [(a, b) for a, b in out]


def in_ranges(ranges, c: int) -> bool:
    k = bisect.bisect_right(ranges, (c, MAX_CP + 1)) - 1
    return k >= 0 and ranges[k][0] <= c <= ranges[k][1]


def _simple_fold(ch: str) -> str:
    """Simple case folding from ``str``'s own tables: the full folding where
    it is one code point (CaseFolding.txt's C entries), else the lower case
    where that is one other code point (its S entries), else the code point
    itself (F and T entries have no simple form)."""
    cf = ch.casefold()
    if len(cf) == 1:
        return cf
    lo = ch.lower()
    return lo if len(lo) == 1 else ch


def generate() -> dict:
    """The tables from this Python's ``unicodedata``, which must carry
    Unicode 15.0.0."""
    import unicodedata

    if unicodedata.unidata_version != VERSION:
        raise RuntimeError(f"unicodedata has Unicode {unicodedata.unidata_version}, "
                           f"not {VERSION}")
    cats = [unicodedata.category(chr(c)) for c in range(MAX_CP + 1)]
    fold = []
    for c in range(MAX_CP + 1):
        if 0xD800 <= c <= 0xDFFF:
            continue
        f = ord(_simple_fold(chr(c)))
        if f != c:
            fold.append([c, f])
    return {
        "version": VERSION,
        "L": [list(r) for r in ranges_of(c for c, k in enumerate(cats) if k[0] == "L")],
        "N": [list(r) for r in ranges_of(c for c, k in enumerate(cats) if k[0] == "N")],
        "White_Space": [list(r) for r in WHITE_SPACE],
        "simple_fold": fold,
    }


@functools.lru_cache(maxsize=1)
def tables() -> dict:
    """The committed tables: ``L``, ``N`` and ``White_Space`` as tuples of
    (lo, hi) ranges, ``simple_fold`` as a dict."""
    with open(_PATH) as f:
        raw = json.load(f)
    out = {k: tuple((a, b) for a, b in raw[k]) for k in ("L", "N", "White_Space")}
    out["simple_fold"] = {a: b for a, b in raw["simple_fold"]}
    out["version"] = raw["version"]
    return out


@functools.lru_cache(maxsize=1)
def fold_orbits() -> dict[int, tuple[int, ...]]:
    """Each code point that simple case folding relates to another, with
    every code point of its class (those with the same folding)."""
    fold = tables()["simple_fold"]
    members: dict[int, set[int]] = {}
    for c, f in fold.items():
        members.setdefault(f, {f}).add(c)
    out: dict[int, tuple[int, ...]] = {}
    for group in members.values():
        t = tuple(sorted(group))
        for c in t:
            out[c] = t
    return out


if __name__ == "__main__":
    data = generate()
    with open(_PATH, "w") as f:
        json.dump(data, f, separators=(",", ":"))
        f.write("\n")
    print(f"wrote {_PATH}: L {len(data['L'])} ranges, N {len(data['N'])}, "
          f"folds {len(data['simple_fold'])}")
