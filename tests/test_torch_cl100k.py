"""The cl100k_base pre-tokenizer on the port: the UTF-8 compiler's Unicode
tables, leftmost-first alternation, and the invalid-byte rule, held to the
``regex`` module on the CPU.

The pattern is the ``cl100k-pretok-utf8`` configuration's ``pat``: the
published ``pat_str`` with its whitespace alternatives replaced by ``\\s+``
and its possessive quantifiers written greedy. Ground truth is
``regex.finditer(pat)`` over the text's valid UTF-8 characters, each run
of bytes that are no character cutting the text (the configuration's
invalid-byte rule), with every token's first character mapped to its byte
offset. Strings are drawn only from code points on which ``regex``'s classes
agree with the port's Unicode 15.0.0 tables. The automaton builds once for
the file (a few seconds).
"""

import json
import unicodedata
from pathlib import Path

import numpy as np
import pytest
import regex

from regex_fpga_tpu_torch import api
from regex_fpga_tpu_torch.models import RegexError
from regex_fpga_tpu_torch.models import unicode as uni
from regex_fpga_tpu_torch.models.utf8 import utf8_sequences
from regex_fpga_tpu_torch.utils.config import EngineConfig

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "benchmark/configs/cl100k-pretok-utf8.json").read_text())
PAT, SOURCE_PAT = CONFIG["pat"], CONFIG["source_pat"]
#: chunks of 64 KiB on 256 lanes: a stream of a few hundred KiB takes
#: several chunks, each with stall padding in front
SMALL = EngineConfig(num_blocks=256, min_block_bytes=32, chunk_bytes=1 << 16,
                     scan_backend="device")
SEP = b"\xff"  # no character: it ends the token before it

#: an alphabet aimed at each rule of the pattern
ALPHABET = (
    "'\u2019\u017fSsLlVvEeRrTtDdMmaxKk"   # contractions, case folding
    "0123456789\u0663\u09eb\u00b2\u00bd\u2460"  # Nd and No digits
    "\u4e2d\u6587\u03bb\u0436\u00e9\u0130"  # letters of other scripts
    "\u0301\U0001f600"  # a combining mark, an emoji (neither L nor N)
    "\r\n\t \u00a0\u3000\u0085"  # whitespace
    "!,.\"()-\u2014\u201c\u201d\u2026#"  # punctuation
)


def _agrees(ch: str) -> bool:
    """``regex``'s classes and the port's tables agree on ``ch``."""
    t = uni.tables()
    c = ord(ch)
    return ((regex.match(r"\p{L}", ch) is not None) == uni.in_ranges(t["L"], c)
            and (regex.match(r"\p{N}", ch) is not None) == uni.in_ranges(t["N"], c)
            and (regex.match(r"\s", ch) is not None) == uni.in_ranges(t["White_Space"], c))


CHARS = [c for c in ALPHABET if _agrees(c)]
WHITE = {c for c in CHARS if regex.match(r"\s", c)}


def truth(data: bytes, pat: str = PAT) -> np.ndarray:
    """Token-start byte offsets by ``regex``: the valid characters between
    runs of bytes that are no character, each run tokenized apart; byte 0
    always starts the first piece."""
    if not data:
        return np.zeros(0, np.int64)
    out, seg, offs, at = {0}, [], [], 0

    def flush():
        text = "".join(seg)
        pieces = [m for m in regex.finditer(pat, text)]
        assert "".join(m.group() for m in pieces) == text
        out.update(offs[m.start()] for m in pieces)

    for ch in data.decode("utf-8", "surrogateescape"):
        if 0xDC80 <= ord(ch) <= 0xDCFF:  # an escaped byte: no character
            flush()
            seg, offs = [], []
            at += 1
            continue
        seg.append(ch)
        offs.append(at)
        at += len(ch.encode("utf-8"))
    flush()
    return np.array(sorted(out), np.int64)


@pytest.fixture(scope="module")
def tok():
    port = CONFIG["port"]
    return api.compile_tokenizer(PAT, config=SMALL, device="cpu", **port["kwargs"])


def _strings(seed: int, n: int, spaced: bool = False) -> list[str]:
    """Seeded strings over the alphabet; ``spaced``: no two whitespace
    characters side by side and none at the end."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        s = "".join(CHARS[k] for k in rng.integers(0, len(CHARS), rng.integers(1, 30)))
        if spaced:
            s = regex.sub(r"\s+", lambda m: m.group()[0], s).rstrip(
                "".join(WHITE))
            if not s:
                s = "x"
        out.append(s)
    return out


def _joined(strings: list[bytes]) -> tuple[bytes, np.ndarray]:
    """The strings joined by ``SEP``, and every string's truth at its offset."""
    data = SEP.join(strings)
    want, at = [], 0
    for s in strings:
        want.append(truth(s) + at if s else np.zeros(0, np.int64))
        at += len(s) + len(SEP)
    starts = np.unique(np.concatenate(want + [np.zeros(1, np.int64)]))
    return data, starts


def test_tables_are_unicode_15_data():
    t = uni.tables()
    assert t["version"] == "15.0.0"
    assert sum(b - a + 1 for a, b in t["White_Space"]) == 25
    if unicodedata.unidata_version != "15.0.0":
        pytest.skip(f"unicodedata has {unicodedata.unidata_version}")
    fresh = uni.generate()
    for key in ("L", "N", "White_Space"):
        assert [list(r) for r in t[key]] == fresh[key], key
    assert t["simple_fold"] == {a: b for a, b in fresh["simple_fold"]}


@pytest.mark.parametrize("lo,hi", [(0, 0x7F), (0x80, 0x10FFFF), (0x7F0, 0x810),
                                   (0xD000, 0xE100), (0x10000, 0x10FFFF),
                                   (0xFFF0, 0x10005)])
def test_utf8_sequences_tile_the_range(lo, hi):
    """Every code point's encoding matches exactly one sequence (sampled),
    and surrogates none."""
    seqs = utf8_sequences(lo, hi)
    rng = np.random.default_rng(lo)
    for c in list(range(lo, min(hi, lo + 300) + 1)) + list(rng.integers(lo, hi + 1, 3000)):
        c = int(c)
        hits = sum(len(s) == len(e) and all(a <= x <= b for x, (a, b) in zip(e, s))
                   for s in seqs for e in [chr(c).encode("utf-8", "surrogatepass")])
        assert hits == (0 if 0xD800 <= c <= 0xDFFF else 1), hex(c)


def test_automaton_size(tok):
    """The configuration's automaton as the port builds it: over 32 states,
    so ``count()`` leaves K3, and within K1/K2's uint16 limit."""
    assert 32 < tok.num_states <= 32767
    assert tok.tables.num_classes <= 255
    assert tok.tok.utf8


@pytest.mark.parametrize("text,pieces", [
    (b"'strict'", [b"'s", b"trict", b"'"]),
    ("it'S 'LL 'Ve x'ſ".encode(), [b"it", b"'S", b" '", b"LL", b" '", b"Ve",
                                   b" x", "'ſ".encode()]),
    ("’s ’S".encode(), ["’s".encode(), " ’".encode(), b"S"]),
    (b"1234567 a", [b"123", b"456", b"7", b" a"]),
    (b"!!\n\nx \ty\tz", [b"!!\n\n", b"x", b" \t", b"y", b"\tz"]),
])
def test_leftmost_first_pieces(tok, text, pieces):
    assert [text[a:b] for a, b in zip(truth(text), list(truth(text)[1:]) + [None])] == pieces
    assert tok.pieces(text) == pieces
    assert tok.count(text) == len(pieces) - 1


@pytest.mark.parametrize("data", [
    b"a\xe2\x80b", b"\xe2\x80ab", b"ab\xe2\x80", "ab’".encode()[:-1],
    b"a\x80\x80b c", b"1\xff2", b"\xff", b"\xc0\xaf x", b"\xed\xa0\x80y",
    b"\xf4\x90\x80\x80z", b"x\xe0\x80y", "中文".encode()[:-2] + b" ok",
])
def test_invalid_byte_rule(tok, data):
    want = truth(data)
    np.testing.assert_array_equal(tok.presplit(data), want)
    assert tok.count(data) == len(want) - 1


def test_seeded_strings_match_regex(tok):
    strings = [s.encode() for s in _strings(17, 3000)]
    for s in strings[:40]:  # one call a string
        np.testing.assert_array_equal(tok.presplit(s), truth(s))
        assert tok.count(s) == len(truth(s)) - 1
    data, want = _joined(strings)  # one stream of every string
    np.testing.assert_array_equal(tok.presplit(data), want)
    assert tok.count(data) == len(want) - 1


def test_cut_and_corrupted_strings_match_regex(tok):
    """Strings cut mid-character and with stray bytes spliced in."""
    rng = np.random.default_rng(23)
    strings = []
    for s in _strings(29, 1500):
        b = bytearray(s.encode())
        for _ in range(rng.integers(0, 3)):
            b.insert(int(rng.integers(0, len(b) + 1)), int(rng.integers(0x80, 0x100)))
        if rng.random() < 0.5:
            b = b[:int(rng.integers(0, len(b) + 1))]
        strings.append(bytes(b))
    data = b"".join(strings)
    want = truth(data)
    np.testing.assert_array_equal(tok.presplit(data), want)
    assert tok.count(data) == len(want) - 1


def test_corpus_matches_regex(tok):
    corpus = json.loads((ROOT / "benchmark/corpora" / f"{CONFIG['corpus']}.json")
                        .read_text(encoding="utf-8"))
    text = "".join(t for _, t in corpus["documents"])
    assert all(_agrees(c) for c in set(text))
    data = text.encode("utf-8")
    want = truth(data)
    got = tok.presplit(data)
    assert len(np.setxor1d(got, want)) == 0
    assert tok.count(data) == len(want) - 1


def test_agrees_with_the_published_pattern(tok):
    """Where the whitespace departure cannot show (no two whitespace
    characters side by side, none at the end), the port splits as the
    published ``pat_str``."""
    strings = [s.encode() for s in _strings(31, 2000, spaced=True)]
    for s in strings:
        np.testing.assert_array_equal(truth(s, SOURCE_PAT), truth(s))
    data, want = _joined(strings)
    np.testing.assert_array_equal(tok.presplit(data), want)


def test_byte_patterns_build_as_before():
    """UTF-8 mode is off by default: the GPT-2 automaton is unchanged."""
    from regex_fpga_tpu_torch.models import build_tokenizer_dfa

    a, b = build_tokenizer_dfa(), build_tokenizer_dfa(utf8=False)
    np.testing.assert_array_equal(a.table, b.table)
    assert not a.utf8 and a.table.shape == (256, 23)


@pytest.mark.parametrize("pattern", [
    r"a$", r"^a", r"a+?", r"a++", r"a*?", r"\d+", r"\w", r"a(?=b)", r"(?<!a)b",
    r"\bx", r"a{2,1}", r"(a", r"a)", r"[a-", r"\p{Lu}", r"*a",
])
def test_utf8_mode_refuses_what_it_cannot_build(pattern):
    """Syntax outside UTF-8 mode raises: nothing is taken as a literal."""
    with pytest.raises(RegexError):
        api.compile_tokenizer(pattern, device="cpu", utf8=True)
