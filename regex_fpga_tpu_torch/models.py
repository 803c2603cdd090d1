"""Automaton builders: the JAX package's numpy-only ``models`` layer.

The port shares these with the JAX package instead of copying them: they
import numpy and nothing of JAX. Every part of the port, and every script
that drives it, takes them from here, so the port reaches the JAX package
at this one place (and at ``regex_fpga_tpu.utils`` in ``api`` and
``native``).

Also the two IDS automata built from the repository's generated corpora,
which ``chip_smoke.py`` and the tests scan.
"""

from regex_fpga_tpu.models.coe import write_coe
from regex_fpga_tpu.models.csr import CsrAutomaton, byte_classes, load_coe
from regex_fpga_tpu.models.export_csr import regexes_to_csr
from regex_fpga_tpu.models.l7_corpus import gen_l7_patterns, gen_l7_traffic
from regex_fpga_tpu.models.lazy_dfa import LazyDfa
from regex_fpga_tpu.models.literals import AhoCorasick, build_aho_corasick
from regex_fpga_tpu.models.oracle import dfa_step_table, nfa_scan
from regex_fpga_tpu.models.snort import parse_snort_rules
from regex_fpga_tpu.models.snort_corpus import gen_community_rules, gen_traffic
from regex_fpga_tpu.models.regex import (
    CompiledDfa,
    compile_pattern,
    contains_backtrack,
    contains_bound,
    contains_lazy,
    parse_pattern,
)
from regex_fpga_tpu.models.tokenizer_dfa import (
    GPT2_PRESPLIT,
    TokenizerDfa,
    build_tokenizer_dfa,
)

__all__ = [
    "AhoCorasick",
    "CompiledDfa",
    "CsrAutomaton",
    "GPT2_PRESPLIT",
    "LazyDfa",
    "TokenizerDfa",
    "build_aho_corasick",
    "build_tokenizer_dfa",
    "byte_classes",
    "compile_pattern",
    "contains_backtrack",
    "contains_bound",
    "contains_lazy",
    "dfa_step_table",
    "gen_community_rules",
    "gen_l7_patterns",
    "gen_l7_traffic",
    "gen_traffic",
    "load_coe",
    "nfa_scan",
    "parse_pattern",
    "parse_snort_rules",
    "l7_corpus_nfa",
    "regexes_to_csr",
    "snort_corpus_nfa",
    "write_coe",
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
