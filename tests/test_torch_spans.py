"""Span extraction of the torch port (regex_fpga_tpu_torch.api: Match and the
span methods of DfaMatcher) against regex_fpga_tpu.api on the same seeded
inputs, on the CPU (the plain versions of the kernels). Tolerance: none;
every span, group span, lastindex, pos/endpos and returned byte string must
be equal."""

import numpy as np
import pytest

from regex_fpga_tpu import api as japi
from regex_fpga_tpu.utils.config import EngineConfig
from regex_fpga_tpu_torch import api as tapi
from regex_fpga_tpu_torch.models import CompiledDfa, compile_pattern

# a multi-chunk config: 4 KiB chunks of 64 lanes
SMALL = EngineConfig(scan_backend="device", chunk_bytes=4096, num_blocks=64)

# the device-routed patterns of tests/test_pos_endpos.py,
# tests/test_regex_anchors.py and tests/test_captures.py
DFA_PATTERNS = [
    r"[0-9]+", r"ab+", r"^a+", r"a+$", r"abc$", r"^abc", r"^a(b|c)*d$",
    r"^(?:foo|ba+r)$", r"(?i)abc", r"x*", r"a*", r"[a-z]+@[a-z]+",
    r"(\w+)@(\w+)\.(com|org)", r"(?P<year>\d{4})-(?P<mo>\d{2})-(?P<day>\d{2})",
    r"(ab)+c", r"(a)?b", r"((a+)(b+))c", r"(x|y)(z?)", r"(\d+)\.(\d+)",
    r"(a*)(a*)", r"([ab]+)([bc]+)",
]
ALPHABET = b"ab1 cd23.x@yo\n-fbarz"


def both(pattern, config=SMALL, **kw):
    return (japi.compile_regex(pattern, config=config, **kw),
            tapi.compile_regex(pattern, config=config, device="cpu", **kw))


def seeded_text(seed: int, n: int, alphabet: bytes = ALPHABET) -> bytes:
    rng = np.random.default_rng(seed)
    return bytes(rng.choice(list(alphabet), size=n).astype(np.uint8))


def assert_match_equal(got, want):
    """Two Match objects (or None) of the two packages are the same
    result: spans of every group, lastindex/lastgroup, groupdict, the
    search window and the subject."""
    assert (got is None) == (want is None)
    if want is None:
        return
    assert got.regs == want.regs
    assert got.lastindex == want.lastindex
    assert got.lastgroup == want.lastgroup
    assert got.groups() == want.groups()
    assert got.groupdict() == want.groupdict()
    assert (got.pos, got.endpos, got.string) == (want.pos, want.endpos,
                                                  want.string)


@pytest.mark.parametrize("pattern", DFA_PATTERNS)
def test_span_methods_match_jax(pattern):
    """finditer (and its array, Match and limit forms), findall,
    findall_ends, search/match/fullmatch, split, sub and subn over a
    seeded multi-chunk stream and its 1-byte prefix."""
    jm, tm = both(pattern)
    assert type(tm).__name__ == type(jm).__name__ == "DfaMatcher"
    assert tm.num_groups == jm.num_groups
    for text in (seeded_text(1, 9001), b"a", b"abcd"):
        spans = jm.finditer(text)
        assert tm.finditer(text) == spans
        assert tm.finditer(text, limit=3) == jm.finditer(text, limit=3)
        np.testing.assert_array_equal(tm.finditer_arrays(text),
                                      jm.finditer_arrays(text))
        for g, w in zip(tm.finditer_matches(text), jm.finditer_matches(text),
                        strict=True):
            assert_match_equal(g, w)
        assert tm.findall(text) == jm.findall(text)
        np.testing.assert_array_equal(tm.findall_ends(text),
                                      jm.findall_ends(text))
        for name in ("search", "match", "fullmatch"):
            assert_match_equal(getattr(tm, name)(text),
                               getattr(jm, name)(text))
        for maxsplit in (0, 2):
            assert tm.split(text, maxsplit) == jm.split(text, maxsplit)
        assert tm.sub(b"<>", text) == jm.sub(b"<>", text)
        assert tm.subn(b"#", text, 3) == jm.subn(b"#", text, 3)
        assert tm.sub(lambda m: m.group()[::-1] + b"|", text) == \
            jm.sub(lambda m: m.group()[::-1] + b"|", text)


@pytest.mark.parametrize("pattern,text", [
    (r"[0-9]+", b"ab12 cd345 e6"), (r"ab+", b"xabb ab abbb"),
    (r"^ab", b"xab ab"), (r"ab$", b"abx ab"), (r"a*", b"aaaa"),
    (r"x*", b"xx"), (r"(\d+)-(\d*)", b"1- 22-3 -4"),
])
def test_pos_endpos_grid_matches_jax(pattern, text):
    """search/match/fullmatch and finditer over a grid of pos and endpos,
    negative, past the end and pos > endpos included."""
    jm, tm = both(pattern)
    n = len(text)
    for pos in (-3, 0, 1, 2, n // 2, n - 1, n, n + 4):
        for endpos in (None, -1, 0, 1, n // 2, n - 1, n, n + 5):
            for name in ("search", "match", "fullmatch"):
                assert_match_equal(getattr(tm, name)(text, pos, endpos),
                                   getattr(jm, name)(text, pos, endpos))
            assert tm.finditer(text, pos=pos, endpos=endpos) == \
                jm.finditer(text, pos=pos, endpos=endpos)


def test_empty_subjects_match_jax():
    for pattern in (r"a*", r"a+", r"x*$", r"^$", r"(a)?"):
        jm, tm = both(pattern)
        for call in ("finditer", "findall", "split"):
            assert getattr(tm, call)(b"") == getattr(jm, call)(b""), pattern
        np.testing.assert_array_equal(tm.finditer_arrays(b""),
                                      jm.finditer_arrays(b""))
        for name in ("search", "match", "fullmatch"):
            assert_match_equal(getattr(tm, name)(b""), getattr(jm, name)(b""))
        assert tm.sub(b"-", b"") == jm.sub(b"-", b"")


def test_multi_chunk_dense_starts_match_jax():
    r"""``\w+`` starts a match at nearly every byte of the reversed stream,
    so the backward pass's 4 KiB chunks hold more starts than their
    compaction cap (1,024) and take the dense branch; 20,011 bytes are five
    chunks, the last one short."""
    text = seeded_text(2, 20_011, b"abcdefgh_01 ")
    jm, tm = both(r"\w+")
    tm._ensure_anchored()
    rev = tm._reverse_matcher
    pos = rev._scan_match_positions(np.frombuffer(text, np.uint8), reverse=True)
    per_chunk = np.bincount(pos // SMALL.chunk_bytes)
    assert per_chunk.max() > 1024 and len(per_chunk) == 5
    assert tm.finditer(text) == jm.finditer(text)
    np.testing.assert_array_equal(tm.finditer_arrays(text),
                                  jm.finditer_arrays(text))
    assert tm.findall(text[:5000]) == jm.findall(text[:5000])


def test_reverse_scan_equals_reversed_copy():
    """``reverse=True`` (upload as it lies, flip on the device) reports the
    positions of a scan over a reversed copy, chunk tails included."""
    text = np.frombuffer(seeded_text(3, 9001), np.uint8)
    _, tm = both(r"[a-z]+[0-9]")
    tm._ensure_anchored()
    rev = tm._reverse_matcher
    got = rev._scan_match_positions(text, reverse=True)
    final = rev._last_final
    want = rev._scan_match_positions(np.ascontiguousarray(text[::-1]))
    np.testing.assert_array_equal(got, want)
    assert final == rev._last_final


def test_non_converged_reverse_pass_matches_jax(monkeypatch):
    """``(aa)*b`` reversed counts the parity of the run of a's after each
    b: with a Jacobi budget of 2 passes and 1,024 lanes the reverse scan of
    a long run does not converge, and the exact path (blocked over
    1,024-byte blocks, serial over the tail) answers."""
    cfg = EngineConfig(scan_backend="device", num_blocks=1024, max_iters=2,
                       min_block_bytes=1, chunk_bytes=4096)
    jm, tm = both(r"(aa)*b", config=cfg)
    tm._ensure_anchored()
    calls = []
    fallback = tm._reverse_matcher._exact_fallback
    monkeypatch.setattr(tm._reverse_matcher, "_exact_fallback",
                        lambda *a, **k: calls.append(1) or fallback(*a, **k))
    for text in (b"a" * 9000 + b"b" + b"a" * 77 + b"b", b"ba" * 2500):
        assert tm.finditer(text) == jm.finditer(text)
        np.testing.assert_array_equal(tm.finditer_arrays(text),
                                      jm.finditer_arrays(text))
    assert calls


@pytest.mark.parametrize("chunk_bytes", [1 << 26, 2048])
def test_states_path_matches_jax_scan_stream(chunk_bytes):
    """``_scan_match_states`` returns JAX's ``_scan_stream`` states at the
    mask's positions, through K1's full mode and through the exact path
    (the parity automaton, which never converges)."""
    rng = np.random.default_rng(4)
    ptable = np.zeros((256, 2), dtype=np.int32)
    ptable[:, 0] = 1
    cases = [
        (CompiledDfa(table=ptable, accept=np.array([False, True]), start=0,
                     dead=0),
         EngineConfig(scan_backend="device", num_blocks=1024, max_iters=2,
                      min_block_bytes=1, chunk_bytes=chunk_bytes)),
        (tapi.compile_regex(r"[a-c]+[0-9]", device="cpu").dfa,
         EngineConfig(scan_backend="device", num_blocks=64,
                      chunk_bytes=chunk_bytes)),
    ]
    for dfa, cfg in cases:
        jm = japi.DfaMatcher(dfa, cfg)
        tm = tapi.DfaMatcher(dfa, cfg, device="cpu")
        for n in (4160, 6001):
            stream = rng.choice(list(b"abc01 a"), size=n).astype(np.uint8)
            states, mask, _, _ = jm._scan_stream(stream)
            pos, st = tm._scan_match_states(stream)
            np.testing.assert_array_equal(pos, np.nonzero(mask)[0])
            np.testing.assert_array_equal(st, states[mask])
            assert tm._last_final == jm._last_final


def test_unsourced_matchers_raise():
    """Span calls need a pattern-compiled matcher: the tokenizer and a
    DfaMatcher built from a bare automaton raise, as in JAX."""
    tok = tapi.compile_tokenizer(device="cpu")
    bare = tapi.DfaMatcher(compile_pattern("ab"), device="cpu")
    for m in (tok, bare):
        assert m._finditer_source is None
        for call in (lambda: m.finditer(b"ab"), lambda: m.search(b"ab"),
                     lambda: m.finditer_arrays(b"ab"),
                     lambda: m.match(b"ab")):
            with pytest.raises(NotImplementedError, match="pattern-compiled"):
                call()
    assert tok.num_groups == 0


def test_match_object_protocol():
    jm, tm = both(r"(?P<k>\w+)=(?P<v>\d+)")
    for m in (tm.search(b"set x=42;"), jm.search(b"set x=42;")):
        assert m["k"] == m.group(1) == b"x"
        assert m.group(0, 2) == (b"x=42", b"42")
        assert m.start("v") == 6 and m.span() == (4, 8)
        assert m.expand(rb"\g<v>:\1") == b"42:x"
        with pytest.raises(IndexError):
            m.group(3)
    assert "x=42" in repr(tm.search(b"set x=42;"))
