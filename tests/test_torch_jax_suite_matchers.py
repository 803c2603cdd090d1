"""The JAX package's matcher tests, run unchanged against the port on the
CPU (``torch_jax_alias``): the API, ``re_compat``, literal sets,
prefilters, ``pos``/``endpos``, anchors, the regex compiler, captures and
the backtracking matcher. Every collected test must pass, except the
entries of ``EXPECTED``."""

import pytest

from torch_jax_alias import check_suite

FILES = ["test_api.py", "test_re_compat.py", "test_literals.py",
         "test_prefilter.py", "test_pos_endpos.py", "test_regex_anchors.py",
         "test_regex.py", "test_captures.py", "test_backtrack.py"]

_SCAN_STREAM = ("unpacks DfaMatcher._scan_stream as JAX's (states, mask, "
                "iterations, converged) of numpy arrays; the port's is (counts, "
                "mask, iterations, converged) of tensors, and its positions "
                "equal the mask's nonzero (test_torch_spans.py)")

#: {test id: (class, reason)}: the classes are torch_jax_alias.CLASSES
EXPECTED = {
    "test_api.py::test_regex_matcher_counts_and_chunking": (
        "deliberate", "scan_backend='auto' routes on the H100's priors, so a "
                      "small call on the CPU reports 'dfa-host-native' where "
                      "JAX reports 'dfa-fast'; the counts are equal"),
    "test_api.py::test_scan_mask_equals_scan_stream_mask": (
        "private", "calls DfaMatcher._scan_mask, which the port does not have"),
    "test_api.py::test_scan_match_positions_equals_mask_nonzero": (
        "private", _SCAN_STREAM),
    "test_api.py::test_scan_match_positions_chunked_odd_tail": (
        "private", _SCAN_STREAM),
}


@pytest.mark.parametrize("group", ["matchers"])
def test_jax_suite_against_port(group, tmp_path):
    check_suite(FILES, EXPECTED, str(tmp_path / f"{group}.xml"))
