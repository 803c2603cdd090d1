"""Automaton builders of the port: its own copies of the JAX package's
numpy-only ``regex_fpga_tpu/models`` modules.

The port imports nothing of the JAX package. The modules here are copies of
the ones the port and ``chip_smoke.py`` use (``coe``, ``csr``,
``export_csr``, ``regex``, ``lazy_dfa``, ``literals``, ``oracle``,
``snort``, ``snort_corpus``, ``l7_corpus``, ``tokenizer_dfa``), with their
relative imports; ``tests/test_torch_models.py`` holds each to its original
on seeded inputs. ``LazyDfa`` differs in one point: its host walks run on the
portable native build (``regex_fpga_tpu_torch.native``) and never on a
Python loop.

Also the two IDS automata built from the repository's generated corpora,
which ``chip_smoke.py`` and the tests scan.
"""

from .coe import write_coe
from .csr import CsrAutomaton, byte_classes, load_coe
from .export_csr import regexes_to_csr
from .l7_corpus import gen_l7_patterns, gen_l7_traffic
from .lazy_dfa import LazyDfa
from .literals import AhoCorasick, build_aho_corasick
from .oracle import dfa_step_table, nfa_scan
from .snort import parse_snort_rules
from .snort_corpus import gen_community_rules, gen_traffic
from .regex import (
    CompiledDfa,
    compile_pattern,
    contains_backtrack,
    contains_bound,
    contains_lazy,
    parse_pattern,
)
from .tokenizer_dfa import (
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
