"""The port's compile_l7 (regex_fpga_tpu_torch.api) against
regex_fpga_tpu.api.compile_l7 on the CPU: one .pat file and a directory,
plain and prefiltered, under every NFA strategy, on the cases of
tests/test_l7.py and on a directory written by models/l7_corpus.py.
Tolerance: none; rule names and per-rule counts must be equal."""

import numpy as np
import pytest

from regex_fpga_tpu import api as japi
from regex_fpga_tpu.models.l7_corpus import gen_l7_traffic, write_pat_dir
from regex_fpga_tpu_torch import api as tapi

from test_l7 import HTTP_PAT, SSH_PAT

STREAMS = [b"xx HTTP/1.1 200 OK yy http/1.0 404 zz", b"ssh-2.0-OpenSSH hello\n",
           b"x ssh-2.0 not at start\n", b"GET / http/1.1\r\n", b"plain noise", b""]
STRATEGIES = ["lazy", "lazy-device", "active-set"]


def compile_both(path, **kw):
    return (japi.compile_l7(str(path), **kw),
            tapi.compile_l7(str(path), device="cpu", **kw))


def assert_l7_equal(got, want, streams):
    assert got.rule_names == want.rule_names
    assert got.num_rules == want.num_rules
    np.testing.assert_array_equal(got.scan(streams).rule_counts,
                                  want.scan(streams).rule_counts)
    for s in streams:
        np.testing.assert_array_equal(got.scan(s).rule_counts,
                                      want.scan(s).rule_counts)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("prefilter", [False, True])
def test_compile_l7_file_and_dir_match_jax(tmp_path, strategy, prefilter):
    """tests/test_l7.py::test_compile_l7_file_and_dir and
    ::test_compile_l7_prefiltered_equal_counts."""
    (tmp_path / "http.pat").write_text(HTTP_PAT)
    jm, tm = compile_both(tmp_path / "http.pat", strategy=strategy,
                          prefilter=prefilter)
    assert tm.rule_names == ["http"]
    assert_l7_equal(tm, jm, STREAMS)
    assert tm.scan(STREAMS[0]).rule_counts[0, 0] == 2
    (tmp_path / "ssh.pat").write_text(SSH_PAT)
    jm, tm = compile_both(tmp_path, strategy=strategy, prefilter=prefilter)
    assert sorted(tm.rule_names) == ["http", "ssh"]
    assert type(tm).__name__ == type(jm).__name__
    assert_l7_equal(tm, jm, STREAMS)
    (tmp_path / "ssh.pat").write_text("ssh\nssh-[12]\\.[0-9]\n")
    jm, tm = compile_both(tmp_path, strategy=strategy, prefilter=prefilter)
    assert_l7_equal(tm, jm, STREAMS)


@pytest.mark.parametrize("prefilter", [False, True])
def test_compile_l7_corpus_dir_matches_jax(tmp_path, prefilter):
    """A directory of 24 generated protocols (anchored and unanchored,
    case-insensitive where the file says so) over their own traffic."""
    write_pat_dir(str(tmp_path), 24)
    payloads, _ = gen_l7_traffic(40)
    jm, tm = compile_both(tmp_path, strategy="lazy-device", prefilter=prefilter)
    assert len(tm.rule_names) == 24
    got = tm.scan(payloads).rule_counts
    np.testing.assert_array_equal(got, jm.scan(payloads).rule_counts)
    assert got.sum() > 0


def test_compile_l7_errors(tmp_path):
    with pytest.raises(ValueError, match="no .pat files"):
        tapi.compile_l7(str(tmp_path), device="cpu")
    (tmp_path / "bad.pat").write_text("# only comments\n")
    with pytest.raises(ValueError, match="not an l7-filter pattern file"):
        tapi.compile_l7(str(tmp_path / "bad.pat"), device="cpu")
