"""Automaton builders of the port: its own copies of the JAX package's
numpy-only ``regex_fpga_tpu/models`` modules.

The port imports nothing of the JAX package. The modules here are copies of
the ones the port and ``chip_smoke.py`` use (``coe``, ``csr``,
``export_csr``, ``regex``, ``lazy_dfa``, ``literals``, ``oracle``,
``snort``, ``snort_corpus``, ``l7_corpus``, ``tokenizer_dfa``, and
``captures`` and ``backtrack`` for the span API's host matchers; ``http``
for the Snort verify's HTTP buffers, ``l7`` for ``compile_l7`` and
``golden`` for the CLI's conformance gate), with their
relative imports; ``tests/test_torch_models.py`` holds each to its original
on seeded inputs. ``LazyDfa`` differs in one point: its host walks run on the
portable native build (``regex_fpga_tpu_torch.native``) and never on a
Python loop.

Also the two IDS automata built from the repository's generated corpora,
which ``chip_smoke.py`` and the tests scan.
"""

from .coe import read_coe, write_coe
from .csr import (CsrAutomaton, byte_classes, from_words, load_coe,
                  prefix_automaton, split_words)
from .export_csr import regexes_to_csr
from .golden import GOLDEN_KEYS, load_golden_histograms
from .http import HttpBuffers, normalize_uri, parse_http_request
from .l7 import L7Pattern, load_l7_dir, load_l7_pattern, parse_l7_pattern
from .l7_corpus import gen_l7_patterns, gen_l7_traffic, write_pat_dir
from .lazy_dfa import LazyDfa
from .literals import AhoCorasick, build_aho_corasick
from .oracle import dfa_scan_counts, dfa_step_table, nfa_scan, nfa_scan_trace
from .snort import (
    ByteExtract,
    ByteJump,
    ByteTest,
    IsDataAt,
    SnortContent,
    SnortRule,
    load_snort_rules,
    parse_snort_rules,
    pcre_to_pattern,
)
from .snort_corpus import gen_community_rules, gen_traffic
from .regex import (
    CompiledDfa,
    DfaBlowupError,
    RegexError,
    compile_pattern,
    contains_backtrack,
    contains_bound,
    contains_lazy,
    parse_pattern,
)
from .tokenizer_dfa import (
    GPT2_PRESPLIT,
    TokenizerDfa,
    boundaries_from_flags,
    build_tokenizer_dfa,
)

__all__ = [
    "AhoCorasick",
    "ByteExtract",
    "ByteJump",
    "ByteTest",
    "CompiledDfa",
    "CsrAutomaton",
    "DfaBlowupError",
    "GOLDEN_KEYS",
    "GPT2_PRESPLIT",
    "HttpBuffers",
    "IsDataAt",
    "L7Pattern",
    "LazyDfa",
    "RegexError",
    "SnortContent",
    "SnortRule",
    "TokenizerDfa",
    "boundaries_from_flags",
    "build_aho_corasick",
    "build_tokenizer_dfa",
    "byte_classes",
    "compile_pattern",
    "contains_backtrack",
    "contains_bound",
    "contains_lazy",
    "dfa_scan_counts",
    "dfa_step_table",
    "from_words",
    "gen_community_rules",
    "gen_l7_patterns",
    "gen_l7_traffic",
    "gen_traffic",
    "load_coe",
    "load_golden_histograms",
    "load_l7_dir",
    "load_l7_pattern",
    "load_snort_rules",
    "nfa_scan",
    "nfa_scan_trace",
    "normalize_uri",
    "parse_http_request",
    "parse_l7_pattern",
    "parse_pattern",
    "parse_snort_rules",
    "pcre_to_pattern",
    "l7_corpus_nfa",
    "prefix_automaton",
    "read_coe",
    "regexes_to_csr",
    "snort_corpus_nfa",
    "split_words",
    "write_coe",
    "write_pat_dir",
]


def snort_corpus_nfa() -> CsrAutomaton:
    """The Snort-corpus content NFA (35,259 states, 83 byte classes): every
    non-negated content literal of ``gen_community_rules()`` in one
    unanchored CSR, as the JAX package's ``SnortMatcher.export_coe`` builds
    it."""
    special = set(rb"\^$.[]()*+?{}|")
    literals = sorted({c.pattern for r in parse_snort_rules(gen_community_rules())
                       for c in r.contents if not c.negated and c.pattern})
    return regexes_to_csr([
        bytes(b for ch in lit for b in ((0x5C, ch) if ch in special else (ch,)))
        for lit in literals
    ])[0]


def l7_corpus_nfa() -> CsrAutomaton:
    """The l7-corpus NFA (722 states, 62 byte classes): the 44 unanchored
    ``gen_l7_patterns()`` in one CSR, case-insensitive where the pattern
    file says so."""
    return regexes_to_csr([("(?i)" + p) if icase else p
                           for _, p, icase, _ in gen_l7_patterns()
                           if not p.startswith("^")])[0]
