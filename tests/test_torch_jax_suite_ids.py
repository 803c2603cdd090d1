"""The JAX package's IDS and automaton tests, run unchanged against the
port on the CPU (``torch_jax_alias``): Snort and l7 (with their scale
tests), the lazy subset DFA, the COE/CSR loaders, the oracle and the CSR
export. Every collected test must pass, except the entries of
``EXPECTED``."""

import pytest

from torch_jax_alias import check_suite

FILES = ["test_snort.py", "test_snort_scale.py", "test_l7.py",
         "test_l7_scale.py", "test_lazy_dfa.py", "test_coe_csr.py",
         "test_oracle.py", "test_export_csr.py"]

_BLOCK_RULE = ("a wall-clock limit met by JAX; the port's plain K2 walks an "
               "odd-length payload on one or two chain lanes (ROADMAP.md "
               "section 2 item 1, the block-count rule)")

#: {test id: (class, reason)}: the classes are torch_jax_alias.CLASSES
EXPECTED = {
    "test_snort.py::test_large_stream_payload": ("cpu-speed", _BLOCK_RULE),
    "test_snort.py::test_verify_linear_without_relative_modifiers": (
        "cpu-speed", _BLOCK_RULE),
    "test_snort.py::test_verify_linear_with_window_backtracking": (
        "cpu-speed", _BLOCK_RULE),
    "test_lazy_dfa.py::test_api_scan_batch_conformance": (
        "fixture", "F1: opens reference/Block_Mem/CSR_BlockMem.coe without "
                   "the reference_available guard; fails under JAX too"),
}


@pytest.mark.parametrize("group", ["ids"])
def test_jax_suite_against_port(group, tmp_path):
    check_suite(FILES, EXPECTED, str(tmp_path / f"{group}.xml"))
