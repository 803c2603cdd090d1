"""The host matchers of the torch port (HostRegexMatcher: the device
envelope prefilter and the Pike VM of models/captures.py;
HostBacktrackMatcher: models/backtrack.py) against regex_fpga_tpu.api on the
same seeded inputs, on the CPU. Tolerance: none; every span, group span,
lastindex and returned byte string must be equal."""

import numpy as np
import pytest

from regex_fpga_tpu import api as japi
from regex_fpga_tpu.models.backtrack import \
    BacktrackLimitExceeded as JaxLimitExceeded
from regex_fpga_tpu.utils.config import EngineConfig
from regex_fpga_tpu_torch import api as tapi
from regex_fpga_tpu_torch.models.backtrack import BacktrackLimitExceeded

from test_torch_spans import SMALL, assert_match_equal, seeded_text

# tests/test_captures.py's boundary cases, tests/test_regex_anchors.py's
# prefilter fuzz patterns and lazy quantifiers
PIKE = [
    r"\bword\b", r"\b\w+\b", r"\Bar\b", r"\bfoo", r"foo\b",
    r"(?P<w>\b[a-z]+\b)", r"\b(\w)(\w*)\b", r"\B", r"\b", r"(?i)\bWORD\b",
    r"\bcat\b", r"ing\b", r"\Bsub\B", r"(?m)^line", r"(?m)end$",
    r"(?m)^(\w+) (\w+)$", r"a+?b", r"<.+?>", r"\b\d{2,4}\b", r"\bcat\b|\B",
    r"(a+?)(b*)", r"x*?",
]
BACKTRACK = [
    r"(\w+) \1", r"(?<=a)b+", r"a(?=b)", r"(?!x)\w", r"(?<!a)b",
    r"(a)?(?(1)b|c)", r"(a)?(?(1)|b??)", r"""(?P<q>['"]).*?(?P=q)""",
    r"(\d)\1{2}", r"^(a)\1",
]
ALPHABET = b"cat catalog word wording line end sub a b <x> 12 1234 \n. 'q\"aab"


def both(pattern, config=SMALL, **kw):
    return (japi.compile_regex(pattern, config=config, **kw),
            tapi.compile_regex(pattern, config=config, device="cpu", **kw))


def assert_spans_equal(tm, jm, text: bytes):
    assert tm.finditer(text) == jm.finditer(text)
    assert tm.finditer(text, limit=2) == jm.finditer(text, limit=2)
    np.testing.assert_array_equal(tm.finditer_arrays(text),
                                  jm.finditer_arrays(text))
    for g, w in zip(tm.finditer_matches(text), jm.finditer_matches(text),
                    strict=True):
        assert_match_equal(g, w)
    assert tm.findall(text) == jm.findall(text)
    assert tm.split(text, 3) == jm.split(text, 3)
    assert tm.subn(b"#", text) == jm.subn(b"#", text)
    assert tm.sub(lambda m: b"[" + m.group() + b"]", text) == \
        jm.sub(lambda m: b"[" + m.group() + b"]", text)
    for name in ("search", "match", "fullmatch"):
        assert_match_equal(getattr(tm, name)(text), getattr(jm, name)(text))


@pytest.mark.parametrize("pattern", PIKE)
def test_host_regex_matcher_matches_jax(pattern):
    """Spans through the envelope prefilter (a multi-chunk backward pass on
    the plain K1) or, for a nullable envelope, the pure host walk."""
    jm, tm = both(pattern)
    assert type(tm).__name__ == type(jm).__name__ == "HostRegexMatcher"
    assert (tm._ensure_envelope() is None) == (jm._ensure_envelope() is None)
    assert tm._first_mode == jm._first_mode
    assert tm.num_groups == jm.num_groups
    for text in (seeded_text(5, 6000, ALPHABET), b"", b"word",
                 b"line one\nend line\nx end"):
        assert_spans_equal(tm, jm, text)
    if tm._envelope is not None:
        stream = np.frombuffer(seeded_text(6, 9001, ALPHABET), np.uint8)
        np.testing.assert_array_equal(tm._candidate_starts(stream),
                                      jm._candidate_starts(stream))


@pytest.mark.parametrize("pattern", BACKTRACK)
def test_host_backtrack_matcher_matches_jax(pattern):
    jm, tm = both(pattern)
    assert type(tm).__name__ == type(jm).__name__ == "HostBacktrackMatcher"
    assert tm.num_groups == jm.num_groups
    for text in (seeded_text(7, 1500, ALPHABET), b"", b"aab b aab",
                 b"ho ho hi hi 111 'x'"):
        assert_spans_equal(tm, jm, text)


@pytest.mark.parametrize("pattern,text", [
    (r"\bcat\b", b"cat concat cat"), (r"(?m)^x$", b"x\nyx\nx"),
    (r"(?<=a)b+", b"ab abb cb"), (r"(\w+) \1", b"ho ho hi hi"),
    (r"(a)?(?(1)b|c)", b"ab c ac"), (r"\bx*", b"xx"),
    (r"(a)?(?(1)b|a??)", b"aa"),
])
def test_host_pos_endpos_grid_matches_jax(pattern, text):
    """``pos`` keeps the context before it (lookbehind, ``\\b``) and never
    lets ``^`` match; ``endpos`` truncates; clamping and pos > endpos."""
    jm, tm = both(pattern)
    n = len(text)
    for pos in (-2, 0, 1, 2, n // 2, n - 1, n, n + 3):
        for endpos in (None, -1, 0, 1, n // 2, n - 1, n, n + 4):
            for name in ("search", "match", "fullmatch"):
                assert_match_equal(getattr(tm, name)(text, pos, endpos),
                                   getattr(jm, name)(text, pos, endpos))
            assert tm.finditer(text, pos=pos, endpos=endpos) == \
                jm.finditer(text, pos=pos, endpos=endpos)


def test_max_steps_bounds_backtracking():
    """``max_steps`` raises the engine's limit error in both packages, and
    leaves a bounded search untouched."""
    jm, tm = both(r"(a+)+b(?=x)", max_steps=2000)
    hostile = b"a" * 25
    with pytest.raises(JaxLimitExceeded):
        jm.search(hostile)
    with pytest.raises(BacktrackLimitExceeded):
        tm.search(hostile)
    assert_match_equal(tm.search(b"aabx"), jm.search(b"aabx"))
    # the linear-time engines take no budget and ignore it
    assert type(tapi.compile_regex(r"a+b", max_steps=1,
                                   device="cpu")).__name__ == "DfaMatcher"


@pytest.mark.parametrize("pattern", [r"\bcat\b", r"a+?b", r"(\w+) \1"])
def test_device_entry_points_raise(pattern):
    """The host matchers' dead 2-state automaton is never scanned: the
    throughput APIs and every internal device entry point of the base class
    raise."""
    tm = tapi.compile_regex(pattern, device="cpu")
    stream = np.frombuffer(b"a cat", np.uint8)
    calls = {
        "scan": lambda: tm.scan(b"a cat"),
        "count": lambda: tm.count(b"a cat"),
        "stream_scanner": lambda: tm.stream_scanner(),
        "findall_ends": lambda: tm.findall_ends(b"a cat"),
        "_kgram": lambda: tm._kgram(),
        "_scan_stream": lambda: tm._scan_stream(stream),
        "_mask_chunk_device": lambda: tm._mask_chunk_device(stream, 0),
        "_scan_match_positions": lambda: tm._scan_match_positions(stream),
        "_scan_match_states": lambda: tm._scan_match_states(stream),
        "_scan_stream_counts": lambda: tm._scan_stream_counts(stream),
        "_scan_batch_counts": lambda: tm._scan_batch_counts(stream[None]),
        "_scan_ragged_counts": lambda: tm._scan_ragged_counts([stream]),
    }
    for name, call in calls.items():
        with pytest.raises(NotImplementedError, match=name):
            call()
    assert tm.num_states == 2
