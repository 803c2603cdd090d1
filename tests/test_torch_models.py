"""The port's copies of the automaton builders (regex_fpga_tpu_torch.models,
.utils) against the JAX package's originals (regex_fpga_tpu.models, .utils)
on the same seeded inputs. Tolerance: none; every array, field and count must
be equal. Also: the port's entry points run on the card by default and raise
when none is visible."""

import dataclasses
import os
import types

import numpy as np
import pytest
import torch

from regex_fpga_tpu.models import coe, csr, export_csr, l7_corpus, lazy_dfa
from regex_fpga_tpu.models import literals, oracle, regex, snort, snort_corpus
from regex_fpga_tpu.models import backtrack, captures, tokenizer_dfa
from regex_fpga_tpu.models import golden, http, l7
from regex_fpga_tpu.utils import config as jconfig
from regex_fpga_tpu.utils import metrics as jmetrics
from regex_fpga_tpu.utils import traces as jtraces
from regex_fpga_tpu_torch import api as tapi
from regex_fpga_tpu_torch import models as tm
from regex_fpga_tpu_torch import re_compat
from regex_fpga_tpu_torch.models import backtrack as tbacktrack
from regex_fpga_tpu_torch.models import captures as tcaptures
from regex_fpga_tpu_torch.ops import lazy_scan
from regex_fpga_tpu_torch.utils import config as tconfig
from regex_fpga_tpu_torch.utils import metrics as tmetrics
from regex_fpga_tpu_torch.utils import traces as ttraces

from chip_smoke import WORDS
from conftest import random_nfa
from test_torch_api import PATTERNS

# the JAX package's originals, under the names the port's models/ exports
jm = types.SimpleNamespace(**{
    name: getattr(module, name) for module in (
        coe, csr, export_csr, l7_corpus, lazy_dfa, literals, oracle, regex,
        snort, snort_corpus, tokenizer_dfa, golden, http, l7)
    for name in tm.__all__ if hasattr(module, name)})


def assert_csr_equal(got, want):
    assert got.num_states == want.num_states
    for field in ("offsets", "trans_char", "trans_target"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)


def assert_dfa_equal(got, want):
    for field in dataclasses.fields(want):
        g, w = getattr(got, field.name), getattr(want, field.name)
        if isinstance(w, np.ndarray) or isinstance(g, np.ndarray):
            assert g.dtype == w.dtype, field.name
            np.testing.assert_array_equal(g, w, err_msg=field.name)
        else:
            assert g == w, field.name


@pytest.mark.parametrize("pattern", PATTERNS + [r"(?i)get /[a-z]+\.php",
                                                r"^abc$", r"x[0-9]{2,4}y"])
@pytest.mark.parametrize("anchored", [False, True])
def test_compile_pattern_matches_jax(pattern, anchored):
    assert_dfa_equal(tm.compile_pattern(pattern, anchored=anchored),
                     jm.compile_pattern(pattern, anchored=anchored))


@pytest.mark.parametrize("pattern", [None, r"[a-z]+|[0-9]+|\s+"])
def test_build_tokenizer_dfa_matches_jax(pattern):
    args = () if pattern is None else (pattern,)
    got, want = tm.build_tokenizer_dfa(*args), jm.build_tokenizer_dfa(*args)
    assert_dfa_equal(got, want)
    assert tm.GPT2_PRESPLIT == jm.GPT2_PRESPLIT


@pytest.mark.parametrize("n_words", [1, 37, 300])
def test_build_aho_corasick_matches_jax(n_words):
    got, want = (tm.build_aho_corasick(WORDS[:n_words]),
                 jm.build_aho_corasick(WORDS[:n_words]))
    assert_dfa_equal(got.dfa, want.dfa)
    assert got.patterns == want.patterns and got.outputs == want.outputs
    np.testing.assert_array_equal(got.out_indptr, want.out_indptr)
    np.testing.assert_array_equal(got.out_indices, want.out_indices)


@pytest.mark.parametrize("patterns", [
    [b"wor", b"l+d"],
    [b"abc", b"b+d", b"x[0-9]y", b"(?i)get /index"],
    [b"[a-f]{3}z", b"q(ab|cd)*r", b"\\x00\\xff."],
])
def test_regexes_to_csr_matches_jax(patterns):
    got, want = tm.regexes_to_csr(patterns), jm.regexes_to_csr(patterns)
    assert_csr_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])  # the owner of each state


def test_l7_corpus_nfa_matches_jax():
    want = jm.regexes_to_csr([("(?i)" + p) if icase else p
                              for _, p, icase, _ in jm.gen_l7_patterns()
                              if not p.startswith("^")])[0]
    assert_csr_equal(tm.l7_corpus_nfa(), want)
    assert tm.gen_l7_patterns() == jm.gen_l7_patterns()
    assert tm.gen_l7_traffic(50, seed=3) == jm.gen_l7_traffic(50, seed=3)


def test_snort_corpus_nfa_matches_jax():
    special = set(rb"\^$.[]()*+?{}|")
    literals = sorted({c.pattern for r in jm.parse_snort_rules(jm.gen_community_rules())
                       for c in r.contents if not c.negated and c.pattern})
    want = jm.regexes_to_csr([
        bytes(b for ch in lit for b in ((0x5C, ch) if ch in special else (ch,)))
        for lit in literals])[0]
    got = tm.snort_corpus_nfa()
    assert got.num_states == 35_259
    assert_csr_equal(got, want)
    assert tm.gen_community_rules() == jm.gen_community_rules()
    assert tm.gen_traffic(40) == jm.gen_traffic(40)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coe_round_trips_across_packages(tmp_path, seed):
    """A .coe written by either package loads in the other to the same
    automaton, and the files are byte for byte equal."""
    aut = random_nfa(np.random.default_rng(seed), n_states=50, n_edges=400,
                     n_accept=6)
    words = aut.to_words()
    np.testing.assert_array_equal(tm.CsrAutomaton.to_words(aut), words)
    t_path, j_path = tmp_path / "port.coe", tmp_path / "jax.coe"
    tm.write_coe(str(t_path), words)
    jm.write_coe(str(j_path), words)
    assert t_path.read_bytes() == j_path.read_bytes()
    assert_csr_equal(tm.load_coe(str(j_path)), jm.load_coe(str(t_path)))
    assert_csr_equal(tm.load_coe(str(t_path)), aut)


@pytest.mark.parametrize("seed", [0, 5])
def test_oracle_and_byte_classes_match_jax(seed):
    rng = np.random.default_rng(seed)
    aut = random_nfa(rng, n_states=40, n_edges=300, n_accept=5)
    stream = rng.integers(0, 256, size=3000).astype(np.uint8)
    np.testing.assert_array_equal(tm.nfa_scan(aut, stream), jm.nfa_scan(aut, stream))
    for g, w in zip(tm.byte_classes(aut), jm.byte_classes(aut)):
        np.testing.assert_array_equal(g, w)
    # a deterministic reference-style automaton: "ab" and "c" from state 0
    dfa = tm.CsrAutomaton(
        offsets=np.array([0, 2, 3, 3, 3], dtype=np.int64),
        trans_char=np.array([ord("a"), ord("c"), ord("b")], dtype=np.uint8),
        trans_target=np.array([1, 3, 2], dtype=np.int32))
    np.testing.assert_array_equal(tm.dfa_step_table(dfa), jm.dfa_step_table(dfa))


@pytest.mark.parametrize("n", [0, 1, 300, 20_000])
def test_lazy_dfa_host_scan_matches_jax(n):
    """The port's LazyDfa walks on the portable native build; its counts,
    finals and subset states equal the JAX package's LazyDfa."""
    aut = tm.l7_corpus_nfa()
    payloads, _ = tm.gen_l7_traffic(400, seed=23)
    stream = np.frombuffer(b"".join(payloads), np.uint8)[:n]
    got, want = tm.LazyDfa(aut), jm.LazyDfa(aut)
    g_counts, g_sid, g_n = got.host_scan(stream)
    w_counts, w_sid, w_n = want.host_scan(stream)
    np.testing.assert_array_equal(g_counts, w_counts)
    assert g_n == w_n == n
    assert got._sets[g_sid] == want._sets[w_sid]
    assert got.num_states == want.num_states
    flows = [stream[i::3] for i in range(3)]
    for g, w in zip(got.host_scan_batch(flows)[0], want.host_scan_batch(flows)[0]):
        np.testing.assert_array_equal(g, w)


def seeded_subject(seed: int, n: int) -> bytes:
    rng = np.random.default_rng(seed)
    return bytes(rng.choice(list(b"ab ab1_x.\n=c"), size=n).astype(np.uint8))


@pytest.mark.parametrize("pattern", [
    r"(\w+)=(\d+)", r"((a+)(b+))c?", r"(a|ab)(c|bcd)?", r"\b(\w)(\w*)\b",
    r"(?m)^(a+)$", r"(a+?)(b*)", r"(?P<x>[ab])+(?P<y>1)?", r"x*",
])
@pytest.mark.parametrize("seed", [0, 1])
def test_capture_program_matches_jax(pattern, seed):
    """The port's copy of models/captures.py: group spans and lastindex
    inside given spans, longest and first ends, and both finditer walks."""
    got = tcaptures.CaptureProgram(pattern)
    want = captures.CaptureProgram(pattern)
    assert (got.num_groups, got.group_names) == (want.num_groups,
                                                 want.group_names)
    data = seeded_subject(seed, 400)
    for s0 in range(0, len(data), 7):
        assert got.longest_end_at(data, s0) == want.longest_end_at(data, s0)
        assert got.first_end_at(data, s0) == want.first_end_at(data, s0)
        end = want.longest_end_at(data, s0)
        if end >= 0:
            assert got.extract(data, s0, end) == want.extract(data, s0, end)
    for start_at in (0, 5):
        assert got.finditer_spans(data, None, start_at=start_at) == \
            want.finditer_spans(data, None, start_at=start_at)
        assert got.finditer_spans_first(data, 3, start_at=start_at) == \
            want.finditer_spans_first(data, 3, start_at=start_at)


@pytest.mark.parametrize("pattern", [
    r"(\w)\1", r"(?<=a)b+", r"a(?=b)", r"(?!x)(\w)", r"(a)?(?(1)b|c)",
    r"(?P<q>[ab])\w*?(?P=q)", r"(a|ab)(c|bcd)?", r"^(a+)\1",
])
@pytest.mark.parametrize("seed", [0, 1])
def test_backtrack_program_matches_jax(pattern, seed):
    """The port's copy of models/backtrack.py: anchored matches with groups
    and lastindex, searches, the empty-match iteration rule, and the step
    budget."""
    got = tbacktrack.BacktrackProgram(pattern)
    want = backtrack.BacktrackProgram(pattern)
    assert (got.num_groups, got.group_names) == (want.num_groups,
                                                 want.group_names)
    data = seeded_subject(seed, 300)
    for s0 in range(0, len(data), 11):
        for kw in ({}, {"full": True}, {"ban_empty": True}):
            assert got.match_at(data, s0, **kw) == want.match_at(data, s0, **kw)
        assert got.search_spans(data, s0) == want.search_spans(data, s0)
    assert got.finditer_spans(data) == want.finditer_spans(data)
    hostile = b"a" * 30
    for prog, err in ((tbacktrack.BacktrackProgram(r"(a+)+b(?=x)", 500),
                       tbacktrack.BacktrackLimitExceeded),
                      (backtrack.BacktrackProgram(r"(a+)+b(?=x)", 500),
                       backtrack.BacktrackLimitExceeded)):
        with pytest.raises(err):
            prog.search_spans(hostile)


def test_engine_config_and_metrics_match_jax():
    assert dataclasses.asdict(tconfig.EngineConfig()) == \
        dataclasses.asdict(jconfig.EngineConfig())
    for args in ((1 << 20, 65536, 64), (4160, 1024, 1), (100, 7, 3, False)):
        assert tconfig.shrink_blocks(*args) == jconfig.shrink_blocks(*args)
    fields = dict(engine="x", bytes_scanned=10, wall_seconds=2.0)
    assert tmetrics.RunMetrics(**fields).to_json() == \
        jmetrics.RunMetrics(**fields).to_json()


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_the_card(no_card, tmp_path):
    """Without ``device`` the entry points ask for a CUDA card and raise when
    none is visible; ``device="cpu"`` is the explicit way to the plain path."""
    aut = tm.regexes_to_csr([b"wor", b"l+d"])[0]
    pat_dir = tmp_path / "pats"
    pat_dir.mkdir()
    tm.write_pat_dir(str(pat_dir), 4)
    calls = [
        lambda: tapi.compile_tokenizer(),
        lambda: tapi.compile_regex(PATTERNS[0]),
        lambda: tapi.compile_regex(r"\bfoo\b"),
        lambda: tapi.compile_regex(r"(a)\1"),
        lambda: tapi.compile_literals([b"ab"]),
        lambda: tapi.compile_regex_set([b"ab", b"^c"]),
        lambda: tapi.compile_regex_set_prefiltered([b"abc", b"d+"]),
        lambda: re_compat.compile(rb"x\d"),
        lambda: re_compat.findall(rb"y\d", b"y1"),
        lambda: tapi.compile_ruleset(aut),
        lambda: tapi.compile_ruleset(aut, strategy="active-set"),
        lambda: lazy_scan.lazy_nfa_scan(tm.LazyDfa(aut), np.zeros(10, np.uint8)),
        lambda: tapi.compile_snort(
            'alert tcp any any -> any any (msg:"a"; content:"ab"; sid:1;)'),
        lambda: tapi.compile_l7(str(pat_dir)),
        lambda: tapi.compile_l7(str(pat_dir), prefilter=True),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()
    assert tapi.compile_ruleset(aut, device="cpu").device.type == "cpu"
    assert tapi.compile_tokenizer(device="cpu").device.type == "cpu"


HTTP_PAYLOADS = [
    b"GET /a?q=1 HTTP/1.1\r\nHost: h\r\nCookie: k=v\r\n\r\nBODY",
    b"NOTAMETHOD /x HTTP/1.1\r\n", b"", b"GET  HTTP/1.1\r\n",
    b"POST /p HTTP/1.0\nA: 1\n", b"GET /%61dmin/./x/../login HTTP/1.1\r\n\r\n",
    b"GET /p?a=%41&b=..//x HTTP/1.1\r\nCookie: SESSID=1\r\n\r\nbody",
    b"PROPFIND * HTTP/1.1\r\n\r\n", b"GET http://h//x HTTP/1.0\r\n\r\n",
]


def seeded_request(seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"/.%2e41a-z?&=", np.uint8)
    uri = bytes(rng.choice(alphabet, size=int(rng.integers(1, 40))).tolist())
    return b"GET /" + uri + b" HTTP/1.1\r\nX: y\r\n\r\n" + uri


@pytest.mark.parametrize("payload", HTTP_PAYLOADS + [seeded_request(s)
                                                     for s in range(8)])
def test_http_carve_matches_jax(payload):
    assert tm.parse_http_request(payload) == jm.parse_http_request(payload)
    for uri in (payload, payload[4:30], b"/a/b/../../../c", b"/a%zz%4", b"*"):
        assert tm.normalize_uri(uri) == jm.normalize_uri(uri)


def test_l7_loader_matches_jax(tmp_path):
    texts = ["name\nkernelpat\nuserspace pattern=userpat\n",
             "# c\nhttp\nhttp/(0\\.9|1\\.0)\nuserspace flags=REG_ICASE\n"]
    for text in texts:
        assert dataclasses.astuple(tm.parse_l7_pattern(text)) == \
            dataclasses.astuple(jm.parse_l7_pattern(text))
    for bad in ("# only comments\n", "name-only\n"):
        with pytest.raises(ValueError):
            tm.parse_l7_pattern(bad)
    tm.write_pat_dir(str(tmp_path), 20)
    got, want = tm.load_l7_dir(str(tmp_path)), jm.load_l7_dir(str(tmp_path))
    assert [dataclasses.astuple(p) for p in got] == \
        [dataclasses.astuple(p) for p in want]
    assert [p.compile_pattern for p in got] == [p.compile_pattern for p in want]
    one = str(tmp_path / sorted(tmp_path.iterdir())[0].name)
    assert dataclasses.astuple(tm.load_l7_pattern(one)) == \
        dataclasses.astuple(jm.load_l7_pattern(one))


def test_golden_histograms_copy_matches_jax():
    """The port keeps its own byte-for-byte copy of the golden tables."""

    from regex_fpga_tpu_torch.models import golden as tgolden

    with open(golden._PATH, "rb") as a, open(tgolden._PATH, "rb") as b:
        assert a.read() == b.read()
    assert os.path.dirname(tgolden._PATH) != os.path.dirname(golden._PATH)
    assert tm.GOLDEN_KEYS == jm.GOLDEN_KEYS
    assert tm.load_golden_histograms() == jm.load_golden_histograms()


def test_traces_match_jax(tmp_path, monkeypatch):
    assert ttraces.RULESETS == jtraces.RULESETS
    assert ttraces.REFERENCE_RUN_LENGTH == jtraces.REFERENCE_RUN_LENGTH
    data = np.random.default_rng(4).integers(0, 256, size=300).tolist()
    path = tmp_path / "t.mem"
    path.write_text("".join(f"{b:02x}\n" for b in data) + "\n")
    for limit in (None, 0, 17, 1000):
        np.testing.assert_array_equal(ttraces.read_mem_trace(str(path), limit),
                                      jtraces.read_mem_trace(str(path), limit))
    monkeypatch.setenv("REGEX_FPGA_REFERENCE", str(tmp_path))
    assert ttraces.reference_root() == jtraces.reference_root() == str(tmp_path)
    monkeypatch.delenv("REGEX_FPGA_REFERENCE")
    # without the variable the fixtures are looked for inside the checkout
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    root = ttraces.reference_root()
    assert root == os.path.join(repo, "reference")
    assert os.path.commonpath([root, repo]) == repo
