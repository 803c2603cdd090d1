"""``regex_fpga_tpu_torch.utils.native``, the JAX package's names for the
native host walker, against ``regex_fpga_tpu.utils.native`` on the same
seeded inputs: the same names, the same signatures, equal results (counts,
masks, finals, active lists, spans and offsets; tolerance: none)."""

import inspect

import numpy as np
import pytest

from regex_fpga_tpu.ops import build_dfa_tables, build_nfa_tables
from regex_fpga_tpu.utils import native as jn
from regex_fpga_tpu_torch.models import gen_l7_traffic, l7_corpus_nfa
from regex_fpga_tpu_torch.utils import native as un

from conftest import random_dfa_table, random_nfa


def nfa_arrays(rng, n_states, n_edges, n_accept):
    t = build_nfa_tables(random_nfa(rng, n_states, n_edges, n_accept))
    return np.asarray(t.delta), np.asarray(t.class_of), np.asarray(t.accept)


def dfa_arrays(rng, n_states, n_accept):
    t = build_dfa_tables(*random_dfa_table(rng, n_states, n_accept))
    return np.asarray(t.table), np.asarray(t.class_of), np.asarray(t.accept)


def assert_same(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)
    elif want is None or np.isscalar(want) or isinstance(want, int):
        assert got == want
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", jn.__all__)
def test_same_names_and_signatures(name):
    assert un.__all__ == jn.__all__
    jp = inspect.signature(getattr(jn, name)).parameters
    up = inspect.signature(getattr(un, name)).parameters
    assert [(p.name, p.kind, p.default) for p in up.values()] == \
        [(p.name, p.kind, p.default) for p in jp.values()]


def test_native_available():
    assert un.native_available() is True is jn.native_available()


@pytest.mark.parametrize("seed,cap", [(0, 1024), (1, 64)])
def test_nfa_scan_native(seed, cap):
    rng = np.random.default_rng(seed)
    d, c, a = nfa_arrays(rng, 40, 320, 4)
    stream = rng.integers(0, 256, size=5000).astype(np.uint8)
    want = jn.nfa_scan_native(d, c, a, stream, active_cap=cap)
    assert_same(un.nfa_scan_native(d, c, a, stream, active_cap=cap), want)
    counts, act = un.nfa_scan_native(d, c, a, stream[:2222], active_cap=cap)
    jcounts, jact = jn.nfa_scan_native(d, c, a, stream[:2222], active_cap=cap)
    assert_same(un.nfa_scan_native(d, c, a, stream[2222:], act, counts),
                jn.nfa_scan_native(d, c, a, stream[2222:], jact, jcounts))


@pytest.mark.parametrize("start,want_mask", [(0, True), (5, False)])
def test_dfa_scan_native(start, want_mask):
    rng = np.random.default_rng(2)
    t, c, a = dfa_arrays(rng, 30, 4)
    stream = rng.integers(0, 256, size=3000).astype(np.uint8)
    assert_same(un.dfa_scan_native(t, c, a, stream, start, want_mask),
                jn.dfa_scan_native(t, c, a, stream, start, want_mask))


def test_dfa_scan_multi_native():
    rng = np.random.default_rng(3)
    t, c, a = dfa_arrays(rng, 50, 6)
    streams = [rng.integers(0, 256, size=n).astype(np.uint8)
               for n in (0, 1, 700, 4096, 333)]
    streams.append(bytes(streams[2]))
    starts = rng.integers(0, 50, size=len(streams)).astype(np.int32)
    for st in (0, 7, starts):
        assert_same(un.dfa_scan_multi_native(t, c, a, streams, st),
                    jn.dfa_scan_multi_native(t, c, a, streams, st))


@pytest.mark.parametrize("segments,overlap", [(32, 64), (8, 4), (1, 64)])
def test_dfa_scan_speculative_native(segments, overlap):
    rng = np.random.default_rng(4)
    t, c, a = dfa_arrays(rng, 40, 5)
    parity = build_dfa_tables(np.tile(np.array([[1, 0]], np.int32), (256, 1)),
                              np.array([False, True]))
    stream = rng.integers(0, 256, size=50_000).astype(np.uint8)
    for tables in ((t, c, a), (np.asarray(parity.table),
                               np.asarray(parity.class_of),
                               np.asarray(parity.accept))):
        args = (*tables, stream, 1 if tables[0].shape[1] > 1 else 0,
                segments, overlap)
        assert_same(un.dfa_scan_speculative_native(*args),
                    jn.dfa_scan_speculative_native(*args))


def test_anchored_spans_native():
    rng = np.random.default_rng(5)
    s = 12
    table, accept = random_dfa_table(rng, s, 3)
    accept_eof = rng.random(s) < 0.3
    stream = rng.integers(0, 256, size=4000).astype(np.uint8)
    starts = np.sort(rng.choice(len(stream), size=300, replace=False))
    args = (table, accept, accept_eof, 0, s - 1, stream, starts)
    got = un.anchored_spans_native(*args)
    assert_same(got, jn.anchored_spans_native(*args))
    assert got.shape[1] == 2


@pytest.mark.parametrize("cap", [1024, 48])
def test_nfa_match_positions_native(cap):
    """From the default start list of ``active_cap`` and from a list that a
    scan of the bytes before returned; an overflowing cap raises in both."""
    t = build_nfa_tables(l7_corpus_nfa())
    d, c, a = np.asarray(t.delta), np.asarray(t.class_of), np.asarray(t.accept)
    stream = np.frombuffer(b"".join(gen_l7_traffic(40, seed=9)[0]),
                           np.uint8)[:30_000]
    got = un.nfa_match_positions_native(d, c, a, stream, active_cap=cap)
    assert_same(got, jn.nfa_match_positions_native(d, c, a, stream,
                                                   active_cap=cap))
    assert len(got)
    _, act = jn.nfa_scan_native(d, c, a, stream[:10_000], active_cap=cap)
    assert_same(un.nfa_match_positions_native(d, c, a, stream[10_000:], act),
                jn.nfa_match_positions_native(d, c, a, stream[10_000:], act))
    for fn in (un.nfa_match_positions_native, jn.nfa_match_positions_native):
        with pytest.raises(RuntimeError, match="capacity"):
            fn(d, c, a, stream, active_cap=4)
