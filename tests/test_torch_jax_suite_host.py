"""The JAX package's host-side tests, run unchanged against the port on
the CPU (``torch_jax_alias``): the native walker's bindings
(``utils.native``), profiling, ingest and the CLI (in process and as
``python -m`` subprocesses), the tokenizer and the regressions of earlier
review rounds. Every collected test must pass, except the entries of
``EXPECTED``."""

import pytest

from torch_jax_alias import check_suite

FILES = ["test_native.py", "test_profiling.py", "test_ingest_cli.py",
         "test_tokenizer.py", "test_review_regressions.py"]

_JAX_ARRAYS = ("passes jnp arrays to a port function that takes tensors (the "
               "port reads their .device as a torch device)")

#: {test id: (class, reason)}: the classes are torch_jax_alias.CLASSES
EXPECTED = {
    "test_review_regressions.py::test_counts_mode_exact_beyond_f32_limit": (
        "jax-input", _JAX_ARRAYS),
    "test_review_regressions.py::test_counts_mode_matches_full_mode": (
        "jax-input", _JAX_ARRAYS),
    "test_review_regressions.py::test_fast_engine_exact_above_256_states": (
        "jax-input", _JAX_ARRAYS),
    "test_review_regressions.py::test_take_counts_final_byte_frontier_escape": (
        "jax-input", _JAX_ARRAYS),
    "test_tokenizer.py::test_presplit_through_fast_engine": (
        "jax-input", _JAX_ARRAYS),
}


@pytest.mark.parametrize("group", ["host"])
def test_jax_suite_against_port(group, tmp_path):
    check_suite(FILES, EXPECTED, str(tmp_path / f"{group}.xml"))
