"""Automaton builders: the JAX package's numpy-only ``models`` layer.

The port shares these with the JAX package instead of copying them: they
import numpy and nothing of JAX. Every part of the port, and every script
that drives it, takes them from here, so the port reaches the JAX package
at this one place (and at ``regex_fpga_tpu.utils`` in ``api``).
"""

from regex_fpga_tpu.models.csr import CsrAutomaton
from regex_fpga_tpu.models.literals import AhoCorasick, build_aho_corasick
from regex_fpga_tpu.models.oracle import dfa_step_table
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
    "TokenizerDfa",
    "build_aho_corasick",
    "build_tokenizer_dfa",
    "compile_pattern",
    "contains_backtrack",
    "contains_bound",
    "contains_lazy",
    "dfa_step_table",
    "parse_pattern",
]
