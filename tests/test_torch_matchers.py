"""The matcher surface of the torch port (LiteralSetMatcher, RuleSetMatcher,
PrefilteredRuleSet and their compile_* entry points) against
regex_fpga_tpu.api on the same seeded inputs, on the CPU (the plain versions
of K1, K2 and K4). Tolerance: none; every occurrence, span, per-pattern,
per-rule and per-state count and every exported byte must be equal."""

import numpy as np
import pytest

from regex_fpga_tpu import api as japi
from regex_fpga_tpu.utils.config import EngineConfig
from regex_fpga_tpu_torch import api as tapi

from chip_smoke import WORDS
from test_torch_spans import assert_match_equal

SMALL = EngineConfig(scan_backend="device", chunk_bytes=4096, num_blocks=64)
LITERALS = [b"he", b"she", b"his", b"hers", b"ab", b"bc", b"abc", b"aaa",
            *WORDS[:40]]
RULES = [  # tests/test_prefilter.py's set: literal-guarded and always-check
    rb"error[0-9]+", rb"GET /[a-z]+ HTTP", rb"(foo)+bar", rb"admin|root",
    rb"x*needle[abc]?", rb"(ab|cd)efgh", rb"se\+rial{2}",
]
ANCHORED = [rb"^ab", rb"^a\d+", rb"^GET /[a-z]+"]
SALT = [b"error42 ", b"GET /abc HTTP ", b"foofoobar ", b"root ", b"needleb ",
        b"cdefgh ", b"se+riall ", b"abc ", b"a7 ", b"ushers ", b"aaaa ",
        *WORDS[:40:7]]


def traffic(seed: int, n: int, salt=SALT) -> bytes:
    """Seeded text: random printable bytes with salt fragments at random
    places, so that every literal and rule matches somewhere."""
    rng = np.random.default_rng(seed)
    parts = []
    while sum(map(len, parts)) < n:
        parts.append(bytes(rng.integers(32, 127, size=int(rng.integers(0, 30)),
                                        dtype=np.int64).astype(np.uint8)))
        parts.append(salt[int(rng.integers(0, len(salt)))])
    return b"".join(parts)[:n]


def literal_matchers():
    return (japi.compile_literals(LITERALS, SMALL),
            tapi.compile_literals(LITERALS, SMALL, device="cpu"))


@pytest.mark.parametrize("n", [0, 1, 700, 9001])
def test_literal_set_matches_jax(n):
    jm, tm = literal_matchers()
    text = traffic(1, n)
    got, want = tm.scan_patterns(text), jm.scan_patterns(text)
    np.testing.assert_array_equal(got.pattern_counts, want.pattern_counts)
    np.testing.assert_array_equal(got.report.counts, want.report.counts)
    assert got.histogram() == want.histogram()
    assert tm.finditer(text) == jm.finditer(text)
    assert tm.finditer(text, limit=5) == jm.finditer(text, limit=5)
    assert tm.findall(text) == jm.findall(text)
    for pos, endpos in ((0, None), (3, None), (n // 2, n - 3), (5, 2),
                        (-4, n + 9)):
        assert tm.finditer(text, pos=pos, endpos=endpos) == \
            jm.finditer(text, pos=pos, endpos=endpos)
        assert_match_equal(tm.search(text, pos, endpos),
                           jm.search(text, pos, endpos))
    for prefix in (b"", b"she sells", b"hers", b"abcd", b"zz"):
        assert_match_equal(tm.match(prefix), jm.match(prefix))
        assert_match_equal(tm.fullmatch(prefix), jm.fullmatch(prefix))
    assert tm.count(text) == jm.count(text) == want.report.total


def test_literal_set_batches_match_jax():
    """scan_patterns over an equal-length batch (K2 per stream) and a
    ragged one (the stall-class path)."""
    jm, tm = literal_matchers()
    equal = [traffic(s, 3000) for s in range(4)]
    ragged = [traffic(10 + s, n) for s, n in enumerate((5000, 0, 17, 2500))]
    for batch in (equal, ragged):
        np.testing.assert_array_equal(tm.scan_patterns(batch).pattern_counts,
                                      jm.scan_patterns(batch).pattern_counts)


def rule_matchers(patterns, strategy, config=SMALL):
    return (japi.compile_regex_set(patterns, config, strategy=strategy),
            tapi.compile_regex_set(patterns, config, strategy, device="cpu"))


@pytest.mark.parametrize("strategy", tapi.NFA_STRATEGIES)
@pytest.mark.parametrize("kind", ["unanchored", "anchored", "mixed"])
def test_rule_set_matches_jax(strategy, kind, tmp_path):
    """Pure sets (one partition, .coe-exportable) and a mixed set (two
    partitions, no per-state report, export raises) under every strategy,
    over ragged streams longer than a chunk."""
    patterns = {"unanchored": RULES, "anchored": ANCHORED,
                "mixed": RULES + ANCHORED}[kind]
    jm, tm = rule_matchers(patterns, strategy)
    streams = [traffic(3, 9001), b"ab12 GET /x HTTP", traffic(4, 300), b""]
    got, want = tm.scan(streams), jm.scan(streams)
    np.testing.assert_array_equal(got.rule_counts, want.rule_counts)
    assert got.rule_counts.sum() > 0
    assert got.histogram(0) == want.histogram(0)
    assert (got.report is None) == (want.report is None) == (kind == "mixed")
    if kind == "mixed":
        for m in (tm, jm):
            with pytest.raises(ValueError, match="two CSR"):
                m.export_coe(str(tmp_path / "x.coe"))
        return
    np.testing.assert_array_equal(got.report.counts, want.report.counts)
    tm.export_coe(str(tmp_path / "port.coe"))
    jm.export_coe(str(tmp_path / "jax.coe"))
    assert (tmp_path / "port.coe").read_bytes() == \
        (tmp_path / "jax.coe").read_bytes()


def test_rule_set_active_set_overflow_raises():
    """A deliberate difference: under "active-set" a list that outgrows
    ``active_bound`` in any chunk makes the port raise; JAX reads the flag
    of the last chunk only and returns truncated counts when an earlier
    chunk overflowed."""
    cfg = EngineConfig(scan_backend="device", chunk_bytes=4096,
                       num_blocks=64, active_bound=2)
    patterns = [rb"a[ab]*b", rb"[ab]+c", rb"b[ab]a"]
    jm, tm = rule_matchers(patterns, "active-set", cfg)
    data = traffic(5, 3000, [b"abababab", b"aabbc"]) + b"z" * 5000
    with pytest.raises(RuntimeError, match="active-set bound exceeded"):
        jm.scan([data[:3000]])
    jm.scan([data])  # the overflow is in the first chunk: no raise
    with pytest.raises(RuntimeError, match="active-set bound exceeded"):
        tm.scan([data])


def prefiltered(patterns, strategy, **kw):
    return (japi.compile_regex_set_prefiltered(patterns, SMALL, strategy, **kw),
            tapi.compile_regex_set_prefiltered(patterns, SMALL, strategy,
                                               device="cpu", **kw))


@pytest.mark.parametrize("strategy", ["lazy", "active-set"])
@pytest.mark.parametrize("cap", [64, 1])
def test_prefiltered_rule_set_matches_jax(strategy, cap):
    """Streams that hold different literals pick different candidate
    subsets; a cache cap of 1 sends all but the first subset to the full
    rule set. Counts equal JAX's and the unfiltered rule set's."""
    jm, tm = prefiltered(RULES + ANCHORED, strategy)
    jm.max_cached_subsets = tm.max_cached_subsets = cap
    assert tm.num_prefiltered == jm.num_prefiltered
    assert tm.always_check == jm.always_check
    streams = [traffic(20 + i, 800, SALT[i: i + 2]) for i in range(6)]
    streams += [b"nothing to see", traffic(30, 1500)]
    got, want = tm.scan(streams), jm.scan(streams)
    np.testing.assert_array_equal(got.rule_counts, want.rule_counts)
    assert got.report.total == want.report.total
    assert got.report.metrics.engine == want.report.metrics.engine
    assert len(tm._subs) == len(jm._subs) <= cap
    assert (tm._full is None) == (jm._full is None) == (cap == 64)
    full = tapi.compile_regex_set(RULES + ANCHORED, SMALL, strategy,
                                  device="cpu")
    np.testing.assert_array_equal(got.rule_counts,
                                  full.scan(streams).rule_counts)
