"""Torch port of the lazy-DFA host/device loop
(regex_fpga_tpu_torch.ops.lazy_scan) against regex_fpga_tpu.ops.lazy_scan
and the golden NFA oracle, on the same seeded inputs. Tolerance: none. On
the CPU the chain passes run K1/K2's plain versions, and the host walks run
on the portable native build."""

import numpy as np
import pytest
import torch

from regex_fpga_tpu.models import nfa_scan as oracle
from regex_fpga_tpu.models.lazy_dfa import LazyDfa
from regex_fpga_tpu.ops.lazy_scan import lazy_nfa_scan as jax_lazy_nfa_scan
from regex_fpga_tpu_torch import models as tmodels
from regex_fpga_tpu_torch.models import gen_l7_traffic, l7_corpus_nfa
from regex_fpga_tpu_torch.ops import lazy_scan

from conftest import random_nfa

# small chunks, so that the optimistic batch, its retry and the exact
# recovery all run at test size
SMALL = dict(warm_bytes=256, host_step=256, num_blocks=16, min_block_bytes=16,
             device_chunk=2048)


def l7_stream(n):
    payloads, _ = gen_l7_traffic(400, seed=23)
    return np.frombuffer(b"".join(payloads), np.uint8)[:n]


def both(aut, stream, **kw):
    got = lazy_scan.lazy_nfa_scan(tmodels.LazyDfa(aut), stream, device="cpu", **kw)
    want = jax_lazy_nfa_scan(LazyDfa(aut), stream, **kw)
    return got, want


@pytest.mark.parametrize("seed", [0, 3])
def test_random_nfa_matches_jax_and_oracle(seed):
    rng = np.random.default_rng(seed)
    aut = random_nfa(rng, n_states=40, n_edges=300, n_accept=5)
    stream = rng.integers(0, 256, size=20_000).astype(np.uint8)
    got, want = both(aut, stream, **SMALL)
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.counts, oracle(aut, stream))
    assert got.offset == want.offset == len(stream)


@pytest.mark.parametrize("kw", [SMALL, dict(SMALL, device_chunk=8192),
                                dict(num_blocks=64)])
def test_l7_matches_jax_and_oracle(kw):
    aut = l7_corpus_nfa()
    stream = l7_stream(16_000)
    got, want = both(aut, stream, **kw)
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.counts, oracle(aut, stream))
    assert got.counts.sum() > 0


def test_resume_matches_jax_and_one_shot():
    aut = l7_corpus_nfa()
    stream = l7_stream(14_000)
    ld = tmodels.LazyDfa(aut)
    s1 = lazy_scan.lazy_nfa_scan(ld, stream[:5_000], device="cpu", **SMALL)
    s2 = lazy_scan.lazy_nfa_scan(ld, stream[5_000:], carry=s1, device="cpu",
                                 **SMALL)
    jld = LazyDfa(aut)
    j1 = jax_lazy_nfa_scan(jld, stream[:5_000], **SMALL)
    j2 = jax_lazy_nfa_scan(jld, stream[5_000:], carry=j1, **SMALL)
    np.testing.assert_array_equal(s2.counts, j2.counts)
    np.testing.assert_array_equal(s2.counts, oracle(aut, stream))
    assert s2.offset == 14_000
    # the carry's subset state is the same set of NFA states in both
    assert ld._sets[s2.state_id] == jld._sets[j2.state_id]


def test_table_uploads_only_when_the_automaton_changes():
    aut = l7_corpus_nfa()
    stream = l7_stream(8_000)
    ld = tmodels.LazyDfa(aut)
    lazy_scan.lazy_nfa_scan(ld, stream, device="cpu", **SMALL)
    cache = ld._torch_device_caches[torch.device("cpu")]
    cache.ensure(ld)
    table, version = cache.table, cache.version
    assert version == ld.version
    cache.ensure(ld)  # nothing grew: the snapshot stays
    assert cache.table is table
    ld._intern(tuple(range(0, aut.num_states, 7)))  # a subset never met
    cache.ensure(ld)
    assert cache.version == ld.version and cache.table is not table


def test_empty_and_short_streams():
    aut = l7_corpus_nfa()
    for n in (0, 1, 15, 300):
        stream = l7_stream(n)
        got, want = both(aut, stream, **SMALL)
        np.testing.assert_array_equal(got.counts, want.counts)
        assert got.offset == n
