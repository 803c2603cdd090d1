"""Torch port tables (regex_fpga_tpu_torch.ops.tables) against the JAX
package's table constructors, element by element, on the same numpy automata."""

import numpy as np
import pytest
import torch

from regex_fpga_tpu.models import build_aho_corasick, build_tokenizer_dfa
from regex_fpga_tpu.models.regex import compile_pattern
from regex_fpga_tpu.ops import tables as jt
from regex_fpga_tpu_torch.ops import tables as tt

from conftest import random_dfa_table


def _automaton(name):
    if name == "tokenizer":
        tok = build_tokenizer_dfa()
        return tok.table, tok.accept
    if name == "regex":
        dfa = compile_pattern(rb"[a-z]+@[a-z]+\.(com|org)|\d{3}-\d{4}")
        return dfa.table, dfa.accept
    if name == "aho_corasick":
        ac = build_aho_corasick([b"error%04d" % i for i in range(40)])
        return ac.dfa.table, ac.dfa.accept
    seed, s = {"random_small": (0, 7), "random_large": (1, 300)}[name]
    return random_dfa_table(np.random.default_rng(seed), s, max(1, s // 10))


def assert_tables_equal(port, ref):
    np.testing.assert_array_equal(port.table.cpu().numpy(), np.asarray(ref.table))
    np.testing.assert_array_equal(port.class_of.cpu().numpy(),
                                  np.asarray(ref.class_of))
    np.testing.assert_array_equal(port.accept.cpu().numpy(), np.asarray(ref.accept))
    assert port.num_states == ref.num_states
    assert port.num_classes == ref.num_classes
    assert port.table.dtype == torch.int32
    assert port.class_of.dtype == torch.int32
    assert port.accept.dtype == torch.bool


@pytest.mark.parametrize("name", ["tokenizer", "regex", "aho_corasick",
                                  "random_small", "random_large"])
def test_build_dfa_tables_matches_jax(name):
    table, accept = _automaton(name)
    assert_tables_equal(tt.build_dfa_tables(table, accept),
                        jt.build_dfa_tables(table, accept))


@pytest.mark.parametrize("name", ["tokenizer", "random_small"])
def test_stall_extend_matches_jax(name):
    table, accept = _automaton(name)
    port = tt.stall_extend(tt.build_dfa_tables(table, accept))
    ref = jt.stall_extend(jt.build_dfa_tables(table, accept))
    assert_tables_equal(port, ref)
    # the stall row is the identity and no byte maps to it
    np.testing.assert_array_equal(port.table[-1].numpy(),
                                  np.arange(port.num_states))
    assert int(port.class_of.max()) < port.num_classes - 1


def test_build_from_csr_matches_jax():
    from regex_fpga_tpu.models.csr import CsrAutomaton

    # a deterministic reference-style automaton: "ab" and "c" from state 0,
    # accepting states have out-degree 0
    aut = CsrAutomaton(
        offsets=np.array([0, 2, 3, 3, 3], dtype=np.int64),
        trans_char=np.array([ord("a"), ord("c"), ord("b")], dtype=np.uint8),
        trans_target=np.array([1, 3, 2], dtype=np.int32),
    )
    assert_tables_equal(tt.build_dfa_tables_from_csr(aut),
                        jt.build_dfa_tables_from_csr(aut))


@pytest.mark.parametrize("name", ["tokenizer", "random_large"])
def test_tables_from_numpy_round_trip(name):
    table, accept = _automaton(name)
    ref = jt.build_dfa_tables(table, accept)
    port = tt.tables_from_numpy(np.asarray(ref.table), np.asarray(ref.class_of),
                                np.asarray(ref.accept), ref.num_states)
    assert_tables_equal(port, ref)
    again = tt.tables_from_numpy(port.table.numpy(), port.class_of.numpy(),
                                 port.accept.numpy(), port.num_states)
    assert_tables_equal(again, ref)
    moved = port.to("cpu")
    assert moved.device == torch.device("cpu")
    assert_tables_equal(moved, ref)


def test_build_rejects_out_of_range_targets():
    table, accept = _automaton("random_small")
    bad = table.copy()
    bad[3, 2] = table.shape[1]
    with pytest.raises(ValueError, match="transition targets"):
        tt.build_dfa_tables(bad, accept)
    with pytest.raises(ValueError, match="transition targets"):
        jt.build_dfa_tables(bad, accept)


def _benchmark_automaton(name):
    """The (256, S) table of a benchmark configuration's automaton, built
    with the port's own functions, as the configuration's entry builds it."""
    import json
    from pathlib import Path

    from regex_fpga_tpu_torch.models import build_aho_corasick as port_ac
    from regex_fpga_tpu_torch.models import build_tokenizer_dfa as port_tokenizer

    conf = json.loads((Path(__file__).resolve().parents[1] / "benchmark" / "configs"
                       / f"{name}.json").read_text(encoding="utf-8"))
    if name == "jieba-dict-349k":  # every 40th word: 8,727 words, not the whole
        return port_ac(conf["words"][::40]).dfa.table
    return port_tokenizer(conf["pat"], **conf["port"]["kwargs"]).table


@pytest.mark.parametrize("name", [
    "random_small", "random_large", "random_few_rows", "tokenizer", "aho_corasick",
    "gpt2-pretok-bytes", "cl100k-pretok-utf8", "csv-records-rfc4180", "jieba-dict-349k"])
def test_byte_classes_are_np_unique_s(name):
    """The linear grouping numbers the classes as ``np.unique(axis=0)``
    does (ascending rows), and the table built on it is ``np.unique``'s rows."""
    if name.startswith("random"):
        rng = np.random.default_rng(len(name))
        table = (random_dfa_table(rng, 40, 3)[0] if name == "random_few_rows"
                 else rng.integers(0, 3, (256, 60 if name == "random_large" else 3)))
        if name == "random_large":  # equal rows that differ only in late columns
            table[:, :50] = 0
    elif name in ("tokenizer", "aho_corasick"):
        table = _automaton(name)[0]
    else:
        table = _benchmark_automaton(name)
    rows, inverse = np.unique(table, axis=0, return_inverse=True)
    class_of, reps = tt._byte_classes(table)
    np.testing.assert_array_equal(class_of, inverse.reshape(-1))
    np.testing.assert_array_equal(table[reps], rows)
    built = tt.build_dfa_tables(table, np.zeros(table.shape[1], bool))
    np.testing.assert_array_equal(built.table.numpy(), rows)
    np.testing.assert_array_equal(built.class_of.numpy(), inverse.reshape(-1))
