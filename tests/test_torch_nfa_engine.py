"""Torch port of the NFA tables and the active-set engine
(regex_fpga_tpu_torch.ops.tables / nfa_engine) against the JAX package on
the same seeded inputs. Tolerance: none; every count, list and flag must be
equal. On the CPU the engine runs K4's plain version."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from regex_fpga_tpu.models import CsrAutomaton, nfa_scan as oracle
from regex_fpga_tpu.ops import build_nfa_tables as jax_build_nfa_tables
from regex_fpga_tpu.ops import nfa_scan_batch as jax_nfa_scan_batch
from regex_fpga_tpu.ops import nfa_scan_jax
from regex_fpga_tpu_torch.models import gen_l7_traffic, l7_corpus_nfa
from regex_fpga_tpu_torch.ops import nfa_engine
from regex_fpga_tpu_torch.ops.tables import build_nfa_csr, build_nfa_tables

from conftest import random_nfa


def l7_bytes(n):
    payloads, _ = gen_l7_traffic()
    return np.frombuffer(b"".join(payloads), np.uint8)[:n]


def dense_nfa(rng, n=40, per_state=6):
    """All edges on a 2-byte alphabet: the active set grows fast."""
    return CsrAutomaton(
        offsets=np.arange(n + 1, dtype=np.int64) * per_state,
        trans_char=rng.integers(0, 2, size=n * per_state).astype(np.uint8),
        trans_target=rng.integers(0, n, size=n * per_state).astype(np.int32),
    )


def assert_same(got, want):
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    np.testing.assert_array_equal(got.final_active.numpy(),
                                  np.asarray(want.final_active))
    np.testing.assert_array_equal(got.overflowed.numpy(),
                                  np.asarray(want.overflowed))


@pytest.mark.parametrize("seed", [0, 1, 2, 3, "l7"])
def test_build_nfa_tables_field_by_field(seed):
    aut = l7_corpus_nfa() if seed == "l7" else random_nfa(
        np.random.default_rng(seed), n_states=50, n_edges=400, n_accept=5)
    want = jax_build_nfa_tables(aut)
    got = build_nfa_tables(aut)
    for field in ("delta", "class_of", "accept"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)))
    assert got.delta.dtype == torch.int32 and got.class_of.dtype == torch.int32
    assert (got.num_states, got.max_fanout, got.num_classes) == (
        want.num_states, want.max_fanout, want.num_classes)
    # K4's CSR holds the same successor set in every (class, state) cell
    csr = build_nfa_csr(aut)
    s = aut.num_states
    assert csr.offsets.shape == (got.num_classes, s + 2)
    np.testing.assert_array_equal(csr.accept.numpy(), got.accept.numpy())
    off, tg, delta = csr.offsets.numpy(), csr.targets.numpy(), got.delta.numpy()
    assert (off[:, s] == off[:, s + 1]).all()  # the sentinel has no successors
    for c in range(got.num_classes):
        for st in range(s):
            cell = tg[off[c, st]:off[c, st + 1]]
            assert (np.diff(cell) > 0).all()
            want_cell = np.unique(delta[c, st][delta[c, st] != s])
            np.testing.assert_array_equal(cell, want_cell)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_nfa_matches_jax_and_oracle(seed):
    rng = np.random.default_rng(seed)
    aut = random_nfa(rng, n_states=50, n_edges=400, n_accept=5)
    stream = rng.integers(0, 256, size=2000).astype(np.uint8)
    got = nfa_engine.nfa_scan(build_nfa_csr(aut), stream, active_bound=64)
    want = nfa_scan_jax(jax_build_nfa_tables(aut), jnp.asarray(stream),
                        active_bound=64)
    assert not bool(got.overflowed)
    assert_same(got, want)
    np.testing.assert_array_equal(got.counts.numpy(), oracle(aut, stream))


@pytest.mark.parametrize("seed", [4, 5])
def test_dense_tables_in_as_in_jax(seed):
    """A call written for JAX passes ``build_nfa_tables``' dense tables:
    ``nfa_scan`` and ``nfa_scan_batch`` take them as well as K4's CSR."""
    rng = np.random.default_rng(seed)
    aut = random_nfa(rng, n_states=50, n_edges=400, n_accept=5)
    streams = rng.integers(0, 256, size=(3, 700)).astype(np.uint8)
    want = nfa_scan_jax(jax_build_nfa_tables(aut), jnp.asarray(streams[0]),
                        active_bound=64)
    for tables in (build_nfa_tables(aut), build_nfa_csr(aut)):
        assert_same(nfa_engine.nfa_scan(tables, streams[0], active_bound=64), want)
        assert_same(nfa_engine.nfa_scan_batch(tables, streams, active_bound=64),
                    jax_nfa_scan_batch(jax_build_nfa_tables(aut),
                                       jnp.asarray(streams), active_bound=64))


def test_l7_prefix_matches_jax_and_oracle():
    aut = l7_corpus_nfa()
    stream = l7_bytes(3000)
    got = nfa_engine.nfa_scan(build_nfa_csr(aut), stream)
    want = nfa_scan_jax(jax_build_nfa_tables(aut), jnp.asarray(stream))
    assert_same(got, want)
    np.testing.assert_array_equal(got.counts.numpy(), oracle(aut, stream))
    assert got.counts.sum() > 0


@pytest.mark.parametrize("bound", [1, 2, 4, 7])
def test_overflow_keeps_smallest_states_like_jax(bound):
    """On overflow the list keeps the A smallest distinct states and the scan
    goes on; counts, lists and the flag all equal JAX's."""
    rng = np.random.default_rng(bound)
    aut = dense_nfa(rng)
    stream = rng.integers(0, 2, size=60).astype(np.uint8)
    got = nfa_engine.nfa_scan(build_nfa_csr(aut), stream, active_bound=bound)
    want = nfa_scan_jax(jax_build_nfa_tables(aut), jnp.asarray(stream),
                        active_bound=bound)
    assert bool(want.overflowed)
    assert_same(got, want)


def test_chunked_resume_equals_single_scan():
    """The carry (list, counts with the sentinel slot) is exact across cuts,
    and each chunk equals JAX's resumed chunk."""
    aut = l7_corpus_nfa()
    csr, jt = build_nfa_csr(aut), jax_build_nfa_tables(aut)
    stream = l7_bytes(2400)
    whole = nfa_engine.nfa_scan(csr, stream)
    act = jact = None
    cnt = jcnt = None
    for a, b in ((0, 700), (700, 701), (701, 2400)):
        r = nfa_engine.nfa_scan(csr, stream[a:b], start_active=act,
                                counts_init=cnt)
        jr = nfa_scan_jax(jt, jnp.asarray(stream[a:b]), start_active=jact,
                          counts_init=jcnt)
        assert_same(r, jr)
        act, cnt = r.final_active, torch.cat([r.counts, torch.zeros(1, dtype=torch.int32)])
        jact = jr.final_active
        jcnt = jnp.concatenate([jr.counts, jnp.zeros(1, jnp.int32)])
    np.testing.assert_array_equal(r.counts.numpy(), whole.counts.numpy())
    np.testing.assert_array_equal(r.final_active.numpy(), whole.final_active.numpy())


def test_unsorted_start_list_with_duplicates_matches_jax():
    """A start list is taken as given for the first byte: duplicates count
    once per slot, sentinels may sit anywhere."""
    rng = np.random.default_rng(5)
    aut = random_nfa(rng, n_states=30, n_edges=300, n_accept=6)
    s = aut.num_states
    acc = np.nonzero(aut.accept_mask)[0]
    start = np.array([s, acc[0], 3, acc[0], s, 0, 17, acc[1]], dtype=np.int32)
    stream = rng.integers(0, 256, size=50).astype(np.uint8)
    got = nfa_engine.nfa_scan(build_nfa_csr(aut), stream, active_bound=8,
                              start_active=torch.as_tensor(start))
    want = nfa_scan_jax(jax_build_nfa_tables(aut), jnp.asarray(stream),
                        active_bound=8, start_active=jnp.asarray(start))
    assert_same(got, want)
    empty = nfa_engine.nfa_scan(build_nfa_csr(aut), stream[:0], active_bound=8,
                                start_active=torch.as_tensor(start))
    np.testing.assert_array_equal(empty.final_active.numpy(), start)


def test_batch_matches_jax():
    rng = np.random.default_rng(7)
    aut = random_nfa(rng, n_states=40, n_edges=300, n_accept=5)
    streams = rng.integers(0, 256, size=(3, 700)).astype(np.uint8)
    got = nfa_engine.nfa_scan_batch(build_nfa_csr(aut), streams, active_bound=32)
    want = jax_nfa_scan_batch(jax_build_nfa_tables(aut), jnp.asarray(streams),
                              active_bound=32)
    assert_same(got, want)


def test_ragged_streams_match_per_stream_jax():
    rng = np.random.default_rng(8)
    aut = random_nfa(rng, n_states=40, n_edges=300, n_accept=5)
    jt = jax_build_nfa_tables(aut)
    lens = [300, 0, 1, 517]
    data = rng.integers(0, 256, size=sum(lens)).astype(np.uint8)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    got = nfa_engine.nfa_scan_streams(build_nfa_csr(aut), torch.as_tensor(data),
                                      starts, lens, active_bound=32)
    for i, (a, n) in enumerate(zip(starts, lens)):
        want = nfa_scan_jax(jt, jnp.asarray(data[a:a + n]), active_bound=32)
        np.testing.assert_array_equal(got.counts[i, :-1].numpy(),
                                      np.asarray(want.counts))
        np.testing.assert_array_equal(got.final_active[i].numpy(),
                                      np.asarray(want.final_active))


def test_bad_inputs_raise():
    aut = random_nfa(np.random.default_rng(9), n_states=20, n_edges=100,
                     n_accept=3)
    csr = build_nfa_csr(aut)
    with pytest.raises(ValueError, match="active states"):
        nfa_engine.nfa_scan(csr, b"abc", active_bound=4,
                            start_active=torch.tensor([0, 21, 20, 20],
                                                      dtype=torch.int32))
    with pytest.raises(ValueError, match="outside data"):
        nfa_engine.nfa_scan_streams(csr, torch.zeros(10, dtype=torch.uint8),
                                    [5], [6])
