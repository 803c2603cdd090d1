"""The port's native bindings (regex_fpga_tpu_torch.native: nfa_scan,
dfa_scan_multi, dfa_scan_speculative, available) against the JAX package's
(regex_fpga_tpu.utils.native) on the same seeded inputs. The port's walker is
its own portable build of the same source. Tolerance: none; counts, finals
and active lists must be equal."""

import numpy as np
import pytest

from regex_fpga_tpu.ops import build_dfa_tables, build_nfa_tables
from regex_fpga_tpu.utils import native as jn
from regex_fpga_tpu_torch import native as tn
from regex_fpga_tpu_torch.models import gen_l7_traffic, l7_corpus_nfa

from conftest import random_dfa_table, random_nfa


def nfa_arrays(rng, n_states, n_edges, n_accept):
    t = build_nfa_tables(random_nfa(rng, n_states, n_edges, n_accept))
    return np.asarray(t.delta), np.asarray(t.class_of), np.asarray(t.accept)


def dfa_arrays(rng, n_states, n_accept):
    t = build_dfa_tables(*random_dfa_table(rng, n_states, n_accept))
    return np.asarray(t.table), np.asarray(t.class_of), np.asarray(t.accept)


def test_available():
    assert tn.available() is True
    assert jn.native_available()


@pytest.mark.parametrize("seed", [0, 1])
def test_nfa_scan_matches_jax_with_resume(seed):
    rng = np.random.default_rng(seed)
    d, c, a = nfa_arrays(rng, 40, 320, 4)
    stream = rng.integers(0, 256, size=5000).astype(np.uint8)
    got, got_act = tn.nfa_scan(d, c, a, stream)
    want, want_act = jn.nfa_scan_native(d, c, a, stream)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_act, want_act)
    c1, act = tn.nfa_scan(d, c, a, stream[:1777])
    c2, act2 = tn.nfa_scan(d, c, a, stream[1777:], active=act, counts=c1)
    np.testing.assert_array_equal(c2, want)
    np.testing.assert_array_equal(act2, want_act)


def test_nfa_scan_overflow_raises():
    """The l7-corpus NFA keeps more than 8 states active on its traffic."""
    t = build_nfa_tables(l7_corpus_nfa())
    d, c, a = np.asarray(t.delta), np.asarray(t.class_of), np.asarray(t.accept)
    stream = np.frombuffer(b"".join(gen_l7_traffic(50, seed=3)[0]),
                           np.uint8)[:20_000]
    with pytest.raises(RuntimeError, match="capacity"):
        jn.nfa_scan_native(d, c, a, stream, active_cap=8)
    with pytest.raises(RuntimeError, match="capacity"):
        tn.nfa_scan(d, c, a, stream, active_cap=8)
    got, want = (tn.nfa_scan(d, c, a, stream, active_cap=64),
                 jn.nfa_scan_native(d, c, a, stream, active_cap=64))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("s", [24, 40_000])  # int16 table, int32 table
@pytest.mark.parametrize("split", ["one call", "threads"])
def test_dfa_scan_multi_matches_jax(s, split, monkeypatch):
    rng = np.random.default_rng(s)
    table, cls, acc = dfa_arrays(rng, s, 3) if s < 1000 else (
        rng.integers(0, s, size=(3, s)).astype(np.int32),
        rng.integers(0, 3, size=256).astype(np.int32),
        rng.random(s) < 0.3)
    lens = rng.integers(0, 3000, size=13)
    streams = [rng.integers(0, 256, size=n).astype(np.uint8) for n in lens]
    streams.append(b"\x01\x02" * 50)
    starts = rng.integers(0, s, size=len(streams)).astype(np.int32)
    if split == "threads":  # the byte-balanced thread split, on small inputs
        monkeypatch.setattr(tn, "THREAD_MIN_BYTES", 0)
        monkeypatch.setattr(tn.os, "cpu_count", lambda: 4)
    got = tn.dfa_scan_multi(table, cls, acc, streams, starts=starts)
    want = jn.dfa_scan_multi_native(table, cls, acc, streams, starts=starts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # a scalar start, and no streams
    for g, w in zip(tn.dfa_scan_multi(table, cls, acc, streams[:3], starts=1),
                    jn.dfa_scan_multi_native(table, cls, acc, streams[:3], starts=1)):
        np.testing.assert_array_equal(g, w)
    counts, finals = tn.dfa_scan_multi(table, cls, acc, [])
    assert counts.shape == (0, s) and finals.shape == (0,)


@pytest.mark.parametrize("kind", ["synchronizing", "parity"])
@pytest.mark.parametrize("n", [10, 9_000, 65_537])
def test_dfa_scan_speculative_matches_jax(kind, n):
    """A random automaton resynchronizes within the overlap; the parity
    automaton never does, so its seams only close by re-walking."""
    rng = np.random.default_rng(n)
    if kind == "parity":
        table = np.zeros((2, 2), np.int32)
        table[1] = [1, 0]
        cls = np.zeros(256, np.int32)
        cls[ord("a")] = 1
        acc = np.array([False, True])
        stream = np.where(rng.random(n) < 0.5, ord("a"), ord("b")).astype(np.uint8)
    else:
        table, cls, acc = dfa_arrays(rng, 30, 4)
        stream = rng.integers(0, 256, size=n).astype(np.uint8)
    for start in (0, 1):
        got = tn.dfa_scan_speculative(table, cls, acc, stream, start=start)
        want = jn.dfa_scan_speculative_native(table, cls, acc, stream, start=start)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
        serial = tn.dfa_scan(table, cls, acc, stream, start=start, want_mask=False)
        np.testing.assert_array_equal(got[0], serial[0])
        assert got[1] == serial[2]


def test_out_of_domain_table_raises():
    s = 8
    table = np.zeros((4, s), dtype=np.int32)
    table[2, 3] = s + 5
    cls = np.zeros(256, dtype=np.int32)
    acc = np.zeros(s, dtype=np.uint8)
    data = np.zeros(4096, dtype=np.uint8)
    for call in (lambda: tn.dfa_scan(table, cls, acc, data),
                 lambda: tn.dfa_scan_multi(table, cls, acc, [data]),
                 lambda: tn.dfa_scan_speculative(table, cls, acc, data,
                                                 segments=4, overlap=16)):
        with pytest.raises(RuntimeError, match="out-of-domain"):
            call()
    with pytest.raises(RuntimeError, match="out-of-domain"):
        jn.dfa_scan_multi_native(table, cls, acc, [data])


def test_available_without_a_compiler(monkeypatch):
    """Without g++ and without a build the walker is not available; a
    missing compiler never raises from the check itself."""
    tn.library.cache_clear()
    monkeypatch.setattr(tn, "_built_path", lambda: tn.BUILD_DIR / "absent.so")
    monkeypatch.setattr(tn.shutil, "which", lambda name: None)
    assert tn.available() is False
