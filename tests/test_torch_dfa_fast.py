"""Torch port k=1 engine (regex_fpga_tpu_torch.ops.dfa_fast and the plain
versions of its kernels K1/K2 in ops.hopper_dfa) against the JAX engine and
the Pallas kernels in interpret mode, on the same seeded numpy inputs. All
integer results must be exactly equal."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regex_fpga_tpu import api as japi
from regex_fpga_tpu.models.regex import CompiledDfa
from regex_fpga_tpu.ops import build_dfa_tables as jax_build_dfa_tables
from regex_fpga_tpu.ops import dfa_fast as jf
from regex_fpga_tpu.ops.pallas_dfa import (
    LANE_TILE,
    chain_pass_counts_pallas,
    chain_pass_finals_pallas,
    chain_pass_full_pallas,
)
from regex_fpga_tpu.utils.config import EngineConfig
from regex_fpga_tpu_torch import api as tapi
from regex_fpga_tpu_torch.ops import dfa_fast as tf
from regex_fpga_tpu_torch.ops import hopper_dfa
from regex_fpga_tpu_torch.ops import kgram as tk
from regex_fpga_tpu_torch.ops.tables import tables_from_numpy

from conftest import random_dfa_table
from test_torch_kgram import reset_counter_tables, reset_counter_text


def both_tables(table, accept):
    j = jax_build_dfa_tables(table, accept)
    return j, port_tables(j)


def port_tables(j):
    return tables_from_numpy(np.asarray(j.table), np.asarray(j.class_of),
                             np.asarray(j.accept), j.num_states)


def to_np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_eq(port, ref):
    np.testing.assert_array_equal(to_np(port), to_np(ref))


def chain_inputs(rng, num_classes, num_states, b, nb, block_major, dtype):
    """(B, NB) class columns and entries as numpy, and as torch tensors whose
    storage is time-major or block-major (a ``.T`` view)."""
    cls = rng.integers(0, num_classes, size=(b, nb)).astype(np.int32)
    ent = rng.integers(0, num_states, size=nb).astype(np.int32)
    if block_major:
        cls_t = torch.as_tensor(np.ascontiguousarray(cls.T)).to(dtype).T
    else:
        cls_t = torch.as_tensor(cls).to(dtype)
    return cls, ent, cls_t, torch.as_tensor(ent)


@pytest.mark.parametrize("seed,s,block_major,dtype", [
    (0, 48, False, torch.uint8),
    (1, 23, True, torch.int32),
    (2, 200, True, torch.int16),
    (3, 5, False, torch.int32),
])
def test_chain_passes_match_jax(seed, s, block_major, dtype):
    rng = np.random.default_rng(seed)
    jt, pt = both_tables(*random_dfa_table(rng, s, max(1, s // 8)))
    b, nb, n = 40, 96, 4
    cls, ent, cls_t, ent_t = chain_inputs(rng, jt.num_classes, s, b, nb,
                                          block_major, dtype)
    cj, ej = jnp.asarray(cls), jnp.asarray(ent)

    assert_eq(tf.chain_pass_finals(pt, cls_t, ent_t),
              jf.chain_pass_finals(jt, cj, ej))
    for got, want in zip(tf.chain_pass_full(pt, cls_t, ent_t),
                         jf.chain_pass_full(jt, cj, ej)):
        assert_eq(got, want)
    for got, want in zip(tf.chain_pass_mask(pt, cls_t, ent_t),
                         jf.chain_pass_mask(jt, cj, ej)):
        assert_eq(got, want)
    for got, want in zip(tf.chain_pass_counts(pt, cls_t, ent_t),
                         jf.chain_pass_counts(jt, cj, ej)):
        assert_eq(got, want)
    got = hopper_dfa.dfa_chain_counts(pt.table, pt.accept, cls_t, ent_t,
                                      num_streams=n)
    want = jf._chain_pass_counts_multi(jt, cj, ej, n)
    assert got[1].shape == (n, s)
    for g, w in zip(got, want):
        assert_eq(g, w)


@pytest.mark.parametrize("seed,s", [(0, 48), (1, 23)])
def test_chain_passes_match_pallas_interpret(seed, s):
    """The plain K1/K2 against the Pallas kernels they replace, run as
    tests/test_pallas_dfa.py runs them (interpret mode, NB=2*1024, B=128)."""
    rng = np.random.default_rng(seed)
    jt, pt = both_tables(*random_dfa_table(rng, s, max(2, s // 10)))
    b, nb = 128, 2 * LANE_TILE
    cls, ent, cls_t, ent_t = chain_inputs(rng, jt.num_classes, s, b, nb,
                                          False, torch.uint8)
    cj, ej = jnp.asarray(cls), jnp.asarray(ent)
    for got, want in zip(hopper_dfa.dfa_chain(pt.table, pt.accept, cls_t,
                                              ent_t, "full"),
                         chain_pass_full_pallas(jt, cj, ej)):
        assert_eq(got, want)
    assert_eq(hopper_dfa.dfa_chain(pt.table, pt.accept, cls_t, ent_t)[0],
              chain_pass_finals_pallas(jt, cj, ej))
    for got, want in zip(hopper_dfa.dfa_chain_counts(pt.table, pt.accept,
                                                     cls_t, ent_t),
                         chain_pass_counts_pallas(jt, cj, ej)):
        assert_eq(got, want)


def assert_fast_equal(got, want):
    assert_eq(got.final_state, want.final_state)
    assert got.converged == bool(want.converged)
    assert got.iterations == int(want.iterations)
    assert bool(got.domain_ok) == bool(want.domain_ok)
    for field in ("match_mask", "states", "counts"):
        g, w = getattr(got, field), getattr(want, field)
        assert (g is None) == (w is None), field
        if g is not None:
            assert_eq(g, w)


@pytest.mark.parametrize("emit", ["full", "mask", "counts"])
@pytest.mark.parametrize("seed,s,length,nb,start,overlap", [
    (0, 48, 4096, 8, 0, 64),
    (1, 32, 2048, 16, 5, 64),
    (2, 48, 8192, 32, 0, 64),
    (3, 32, 2048, 16, 0, 0),
    (4, 12, 1024, 1, 3, 64),
])
def test_scan_fast_matches_jax(emit, seed, s, length, nb, start, overlap):
    rng = np.random.default_rng(seed)
    jt, pt = both_tables(*random_dfa_table(rng, s, max(1, s // 8)))
    stream = rng.integers(0, 256, size=length).astype(np.uint8)
    classes = np.asarray(jt.class_of)[stream].astype(np.uint8)
    want = jf.dfa_scan_fast(jt, jnp.asarray(classes), num_blocks=nb,
                            start=start, emit=emit, overlap=overlap)
    got = tf.dfa_scan_fast(pt, torch.as_tensor(classes), num_blocks=nb,
                           start=start, emit=emit, overlap=overlap)
    assert_fast_equal(got, want)


@pytest.mark.parametrize("max_iters", [4, 16])
@pytest.mark.parametrize("emit", ["full", "counts"])
def test_scan_fast_parity_automaton(max_iters, emit):
    """Parity counter with odd blocks never synchronizes: speculation fails,
    the Jacobi loop needs NB iterations, and a low budget is reported as
    not converged; both engines count iterations the same way."""
    ptable = np.zeros((256, 2), dtype=np.int32)
    ptable[:, 0] = 1
    jt, pt = both_tables(ptable, np.array([False, True]))
    stream = np.zeros(127 * 8, np.uint8)
    want = jf.dfa_scan_fast(jt, jnp.asarray(stream), num_blocks=8,
                            max_iters=max_iters, emit=emit)
    got = tf.dfa_scan_fast(pt, torch.as_tensor(stream), num_blocks=8,
                           max_iters=max_iters, emit=emit)
    assert got.converged == (max_iters == 16)
    assert_fast_equal(got, want)


@pytest.mark.parametrize("emit", ["counts", "full"])
@pytest.mark.parametrize("seed,n,length,nb,per_stream_starts", [
    (0, 2, 64, 4, False),
    (1, 3, 256, 8, True),
    (2, 5, 128, 1, False),
    (3, 4, 512, 16, True),
])
def test_scan_fast_multi_matches_jax(emit, seed, n, length, nb,
                                     per_stream_starts):
    rng = np.random.default_rng(seed)
    jt, pt = both_tables(*random_dfa_table(rng, 13, 2))
    data = rng.integers(0, 256, size=(n, length)).astype(np.uint8)
    classes = np.asarray(jt.class_of)[data].astype(np.uint8)
    starts = (rng.integers(0, 13, size=n).astype(np.int32)
              if per_stream_starts else 0)
    want = jf.dfa_scan_fast_multi(jt, jnp.asarray(classes), num_blocks=nb,
                                  starts=jnp.asarray(starts), emit=emit)
    got = tf.dfa_scan_fast_multi(pt, torch.as_tensor(classes), num_blocks=nb,
                                 starts=torch.as_tensor(starts), emit=emit)
    assert got.converged == bool(want.converged)
    assert got.iterations == int(want.iterations)
    assert bool(got.domain_ok) == bool(want.domain_ok)
    assert_eq(got.final_states, want.final_states)
    for field in ("counts", "match_mask", "states"):
        g, w = getattr(got, field), getattr(want, field)
        assert (g is None) == (w is None), field
        if g is not None:
            assert_eq(g, w)


@pytest.mark.parametrize("cell,value", [((0, 0), 999), ((1, 2), -3)])
@pytest.mark.parametrize("emit", ["full", "counts"])
def test_corrupt_table_flagged_like_jax(cell, value, emit):
    """A corrupt table (out-of-range target) is flagged by domain_ok in both
    engines, and the out-of-range ids step exactly as the JAX one-hot
    lookup steps them, so even the discarded results agree."""
    rng = np.random.default_rng(0)
    jt, _ = both_tables(*random_dfa_table(rng, 16, 3))
    bad_j = dataclasses.replace(jt, table=jt.table.at[cell].set(value))
    bad_t = port_tables(bad_j)
    assert not bool(jf.table_domain_ok(bad_j))
    assert not bool(tf.table_domain_ok(bad_t))
    stream = rng.integers(0, 256, size=4096).astype(np.uint8)
    classes = np.asarray(jt.class_of)[stream].astype(np.int32)
    want = jf.dfa_scan_fast(bad_j, jnp.asarray(classes), num_blocks=32,
                            emit=emit)
    got = tf.dfa_scan_fast(bad_t, torch.as_tensor(classes), num_blocks=32,
                           emit=emit)
    assert not bool(got.domain_ok)
    assert_fast_equal(got, want)
    want_m = jf.dfa_scan_fast_multi(bad_j, jnp.asarray(classes)[None, :],
                                    num_blocks=32, emit="counts")
    got_m = tf.dfa_scan_fast_multi(bad_t, torch.as_tensor(classes)[None, :],
                                   num_blocks=32, emit="counts")
    assert not bool(got_m.domain_ok) and not bool(want_m.domain_ok)
    assert_eq(got_m.counts, want_m.counts)


def unsynced_tables(which):
    """(256, S) tables whose seam guesses fail: the reset counter, a mod-3
    counter (its reset byte counts like the others) or a parity counter;
    the last two never synchronize."""
    if which == "parity":
        table = np.zeros((256, 2), dtype=np.int32)
        table[:, 0] = 1
        return table, np.array([False, True])
    table, accept = reset_counter_tables()
    if which == "mod 3":
        table[ord("b"), :] = table[ord("a"), :]
    return table, accept


def serial_walk(table, accept, stream, start=0):
    """A serial walk over the bytes with a (256, S) table: (the accept
    visits before each byte per state, the final state, the accept bit and
    the state before each byte)."""
    counts = np.zeros(table.shape[1], np.int64)
    mask = np.zeros(len(stream), bool)
    states = np.zeros(len(stream), np.int32)
    s = start
    for i, byte in enumerate(stream):
        states[i], mask[i] = s, accept[s]
        counts[s] += accept[s]
        s = table[byte, s]
    return counts, int(s), mask, states


def serial_counts(table, accept, stream, start=0):
    """A serial walk's (accept visits per state, final state)."""
    return serial_walk(table, accept, stream, start)[:2]


#: the k=1 engines' modes: (engine, emit)
MODES = [("fast", "counts"), ("fast", "mask"), ("fast", "full"),
         ("multi", "counts"), ("multi", "full")]


def run_both(engine, jt, pt, classes, starts, **kw):
    """One scan by JAX and by the port: ``dfa_scan_fast`` over classes[0]
    from starts[0], or ``dfa_scan_fast_multi`` over every row."""
    if engine == "fast":
        return (jf.dfa_scan_fast(jt, jnp.asarray(classes[0]), start=int(starts[0]), **kw),
                tf.dfa_scan_fast(pt, torch.as_tensor(classes[0]), start=int(starts[0]), **kw))
    return (jf.dfa_scan_fast_multi(jt, jnp.asarray(classes), starts=jnp.asarray(starts), **kw),
            tf.dfa_scan_fast_multi(pt, torch.as_tensor(classes),
                                   starts=torch.as_tensor(starts), **kw))


def assert_multi_equal(got, want):
    assert got.converged == bool(want.converged)
    assert got.iterations == int(want.iterations)
    assert bool(got.domain_ok) == bool(want.domain_ok)
    assert_eq(got.final_states, want.final_states)
    for field in ("counts", "match_mask", "states"):
        g, w = getattr(got, field), getattr(want, field)
        assert (g is None) == (w is None), field
        if g is not None:
            assert_eq(g, w)


@pytest.mark.parametrize("engine,emit", MODES)
@pytest.mark.parametrize("which,max_iters,overlap", [
    ("reset counter", 16, 64), ("reset counter", 16, 1),
    ("reset counter", 3, 1), ("mod 3", 16, 64), ("mod 3", 5, 64),
    ("parity", 16, 64), ("parity", 4, 0),
])
def test_queued_counts_failed_guesses_match_jax(engine, emit, which, max_iters,
                                                overlap):
    """Every mode where the queued verdict rejects the guess: the Jacobi
    rounds and the output pass after the one read give the JAX package's
    results, final state(s), ``converged`` and ``iterations``, and,
    converged, a serial walk's counts, mask, states and final state, each
    stream from its own start in the batch scan."""
    table, accept = unsynced_tables(which)
    jt, pt = both_tables(table, accept)
    texts = [reset_counter_text(3, 16, 65, resets=(0, 3, 4, 10))]
    starts = np.array([0], np.int32)
    if engine == "multi":
        texts.append(reset_counter_text(5, 16, 65, resets=(1, 2, 9)))
        starts = np.array([0, 1], np.int32)
    classes = np.asarray(jt.class_of)[np.stack(texts)].astype(np.uint8)
    kw = dict(num_blocks=16, max_iters=max_iters, overlap=overlap, emit=emit)
    want, got = run_both(engine, jt, pt, classes, starts, **kw)
    assert got.iterations > 1 and got.domain_ok is True
    if engine == "fast":
        assert_fast_equal(got, want)
        got_finals = [int(got.final_state)]
    else:
        assert_multi_equal(got, want)
        got_finals = got.final_states.tolist()
    assert got.converged == (max_iters == 16)
    if not got.converged:
        return
    for i, (text, start) in enumerate(zip(texts, starts)):
        counts, final, mask, states = serial_walk(table, accept, text, start)
        assert got_finals[i] == final
        row = (lambda t: t) if engine == "fast" else (lambda t: t[i])
        if emit == "counts":
            assert_eq(row(got.counts), counts)
        else:
            assert_eq(row(got.match_mask), mask)
        if emit == "full":
            assert_eq(row(got.states), states)


@pytest.mark.parametrize("engine,emit", MODES + [("kgram", None)])
@pytest.mark.parametrize("guess", ["holds", "misses"])
def test_one_host_read_a_round(engine, emit, guess, monkeypatch):
    """The round helper reads each pass's verdict, final states, range and
    small answer with one ``.cpu()`` and nothing else is read: one read a
    chunk when the speculation's guess holds; after a miss, one a round (the
    k=1 engines: the output pass, the Jacobi rounds, the output pass again;
    K3: its full passes)."""
    from test_torch_kgram import packed

    table, accept = unsynced_tables("reset counter")
    _, pt = both_tables(table, accept)
    text = reset_counter_text(3, 16, 65, resets=(0, 3, 4, 10))
    if guess == "holds":  # a reset at the end of every block
        text[:] = ord("a")
        text[64::65] = ord("b")
    classes = pt.class_of[torch.as_tensor(text).long()].to(torch.uint8)
    if engine == "fast":
        scan = lambda: tf.dfa_scan_fast(pt, classes, num_blocks=16, emit=emit)
    elif engine == "multi":
        scan = lambda: tf.dfa_scan_fast_multi(
            pt, torch.stack([classes, classes]), num_blocks=16, emit=emit)
    else:
        kt = tk.build_kgram(pt, levels=0)
        ta, ids = packed(kt.table, kt.acc_table), tk.map_kgram_classes(kt, text)
        scan = lambda: tk.dfa_scan_kgram(ta, ids, num_blocks=16)
    reads, rounds = [], []
    real_cpu, real_round = torch.Tensor.cpu, tf._round

    def cpu(self, *args, **kw):
        reads.append(tuple(self.shape))
        return real_cpu(self, *args, **kw)

    def spy(*args, **kw):
        before = len(reads)
        out = real_round(*args, **kw)
        rounds.append(len(reads) - before)
        return out
    monkeypatch.setattr(tf, "_round", spy)
    monkeypatch.setattr(tk, "_round", spy)
    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    res = scan()
    assert res.converged
    assert rounds == [1] * len(rounds) and len(reads) == len(rounds)
    if guess == "holds":
        assert res.iterations == 1 and len(rounds) == 1
    else:
        assert res.iterations > 1
        assert len(rounds) == res.iterations + (engine != "kgram")


@pytest.mark.parametrize("which", ["random", "256 classes", "parity"])
def test_batches_with_every_lead_match_jax(which):
    """An equal-length batch of odd width (one lead for every row) and a
    ragged batch whose last chunk gives a row of every lead from 0 to 15,
    beside a short row and an empty one: JAX's counts and final states,
    where the guesses hold, with C = 256 (the stall id needs int16), and
    where the automaton never synchronizes (the one per-row fallback)."""
    rng = np.random.default_rng(6)
    if which == "parity":
        table, accept = unsynced_tables("parity")
    else:
        table, accept = random_dfa_table(rng, 24, 3)
        if which == "random":  # bytes in 40 classes, not 256
            table = table[rng.integers(0, 40, 256)]
    dfa = CompiledDfa(table=table, accept=accept, start=0,
                      dead=-1 if which == "parity" else 23)
    cfg = EngineConfig(scan_backend="device", num_blocks=16,
                       min_block_bytes=4, chunk_bytes=1024, max_iters=4)
    tm = tapi.DfaMatcher(dfa, cfg, device="cpu")
    jm = japi.DfaMatcher(dfa, cfg)
    if which != "parity":
        assert (tm.tables.num_classes == 256) == (which == "256 classes")
    batch = rng.integers(0, 256, size=(5, 997)).astype(np.uint8)
    rows = [rng.integers(0, 256, size=2000 - k).astype(np.uint8)
            for k in range(16)] + [batch[0, :5], batch[0, :0]]
    for run in ("_scan_batch_counts", "_scan_ragged_counts"):
        data = batch if run == "_scan_batch_counts" else rows
        counts, _, converged, finals = getattr(tm, run)(data)
        want = getattr(jm, run)(data)
        np.testing.assert_array_equal(counts, want[0])
        np.testing.assert_array_equal(finals, want[3])
        assert converged == (which != "parity")
    for data in (batch, rows):
        np.testing.assert_array_equal(tm.scan(data).counts,
                                      jm.scan(data).counts)


@pytest.mark.parametrize("which", ["random", "reset counter", "mod 3",
                                   "parity"])
def test_counts_chunks_padded_in_front_match_jax(which, monkeypatch):
    """scan()'s counts-only chunks, each padded in front to a lane
    multiple (``lead`` > 0) and handed on from chunk to chunk: equal to
    the JAX package and to a serial walk, where the guesses hold, where
    they take Jacobi rounds, and where the automaton never synchronizes
    (the exact fallback)."""
    if which == "random":
        table, accept = random_dfa_table(np.random.default_rng(9), 40, 3)
    else:
        table, accept = unsynced_tables(which)
    dfa = CompiledDfa(table=table, accept=accept, start=0,
                      dead=39 if which == "random" else -1)
    cfg = EngineConfig(scan_backend="device", num_blocks=16,
                       min_block_bytes=4, chunk_bytes=1000, max_iters=8)
    tm = tapi.DfaMatcher(dfa, cfg, device="cpu")
    leads, passes = [], []
    real_ids, real_scan = tm._chunk_ids, tapi.dfa_scan_fast

    def ids_spy(data):
        out = real_ids(data)
        leads.append(out[3])
        return out

    def scan_spy(*args, **kw):
        res = real_scan(*args, **kw)
        passes.append((res.iterations, res.converged))
        return res
    monkeypatch.setattr(tm, "_chunk_ids", ids_spy)
    monkeypatch.setattr(tapi, "dfa_scan_fast", scan_spy)
    text = reset_counter_text(7, 57, 64, resets=range(0, 57, 3))[:3641]
    if which == "random":
        text = np.random.default_rng(9).integers(0, 256, 3641).astype(np.uint8)
    got = tm.scan(text)
    assert leads and all(leads)  # every chunk padded in front
    want = japi.DfaMatcher(dfa, cfg).scan(text)
    np.testing.assert_array_equal(got.counts, want.counts)
    counts, final = serial_counts(table, accept, text)
    counts[final] += accept[final]  # the end-of-stream match
    np.testing.assert_array_equal(got.counts[0], counts)
    if which == "reset counter":
        assert max(it for it, _ in passes) >= 2
    if which in ("mod 3", "parity"):
        assert not got.metrics.converged
        assert passes and not any(conv for _, conv in passes)


def test_corrupted_table_raises_rather_than_counts():
    """A table corrupted in place after a clean scan: the range check is
    read once per table tensor, so its version counter has to bring the
    check back; the counts mode flags it and the counts route raises."""
    rng = np.random.default_rng(2)
    table, accept = random_dfa_table(rng, 24, 3)
    dfa = CompiledDfa(table=table, accept=accept, start=0, dead=23)
    cfg = EngineConfig(scan_backend="device", num_blocks=16,
                       min_block_bytes=4, chunk_bytes=1024)
    tm = tapi.DfaMatcher(dfa, cfg, device="cpu")
    text = rng.integers(0, 256, 4096).astype(np.uint8)
    classes = tm.tables.class_of[torch.as_tensor(text).long()].to(torch.uint8)
    clean = tf.dfa_scan_fast(tm.tables, classes, num_blocks=16, emit="counts")
    assert bool(clean.domain_ok)
    want = tm.scan(text)
    tm.tables.table[1, 2] = 999
    bad = tf.dfa_scan_fast(tm.tables, classes, num_blocks=16, emit="counts")
    assert not bool(bad.domain_ok)
    with pytest.raises(RuntimeError, match="out-of-domain"):
        tm.scan(text)
    tm.tables.table[1, 2] = int(table[int(np.flatnonzero(
        tm.tables.class_of.numpy() == 1)[0]), 2])
    np.testing.assert_array_equal(tm.scan(text).counts, want.counts)


def test_table_domain_ok_clean_tables():
    rng = np.random.default_rng(1)
    for s in (3, 16, 300):
        jt, pt = both_tables(*random_dfa_table(rng, s, 1))
        assert bool(tf.table_domain_ok(pt)) == bool(jf.table_domain_ok(jt))


@pytest.mark.parametrize("n,p", [(1, 0.5), (256, 0.0), (256, 1.0),
                                 (1024, 0.03), (4096, 0.2), (4096, 0.6)])
def test_mask_positions_matches_jax(n, p):
    rng = np.random.default_rng(n)
    mask = rng.random(n) < p
    cap = max(8, n // 2)
    pos_j, count_j = jf.mask_positions(jnp.asarray(mask), cap)
    pos_t, count_t = tf.mask_positions(torch.as_tensor(mask), cap)
    assert int(count_t) == int(count_j) == int(mask.sum())
    take = min(int(count_j), cap)
    assert pos_t.shape == (cap,) and pos_t.dtype == torch.int32
    assert_eq(pos_t[:take], np.asarray(pos_j)[:take])


def test_chain_wrappers_reject_bad_inputs():
    rng = np.random.default_rng(0)
    _, pt = both_tables(*random_dfa_table(rng, 8, 1))
    cls = torch.zeros((4, 6), dtype=torch.uint8)
    ent = torch.zeros(6, dtype=torch.int32)
    with pytest.raises(TypeError):
        hopper_dfa.dfa_chain(pt.table, pt.accept, cls.float(), ent)
    with pytest.raises(TypeError):
        hopper_dfa.dfa_chain(pt.table, pt.accept, cls, ent[:5])
    with pytest.raises(ValueError):
        hopper_dfa.dfa_chain(pt.table, pt.accept, cls, ent, mode="states")
    with pytest.raises(ValueError):
        hopper_dfa.dfa_chain_counts(pt.table, pt.accept, cls, ent,
                                    num_streams=4)
    byte_map = pt.class_of.to(torch.uint8)
    with pytest.raises(TypeError, match="raw bytes"):  # the map takes bytes
        hopper_dfa.dfa_chain(pt.table, pt.accept, cls.to(torch.int16), ent,
                             class_of=byte_map)
    for bad in (byte_map[:255], byte_map.int(), byte_map.repeat(2)[::2]):
        with pytest.raises(TypeError, match="class_of"):
            hopper_dfa.dfa_chain_counts(pt.table, pt.accept, cls, ent, class_of=bad)
    with pytest.raises(ValueError, match="class_of is on meta"):
        hopper_dfa.dfa_chain(pt.table, pt.accept, cls, ent,
                             class_of=byte_map.to("meta"))


def test_non_cpu_tensors_never_take_the_plain_version():
    """Only CPU tensors reach the plain version: any other device launches
    the kernel or raises (here: a device with no kernel at all)."""
    rng = np.random.default_rng(0)
    _, pt = both_tables(*random_dfa_table(rng, 8, 1))
    meta = pt.to("meta")
    cls = torch.zeros((4, 6), dtype=torch.uint8, device="meta")
    ent = torch.zeros(6, dtype=torch.int32, device="meta")
    before = dict(hopper_dfa.LAUNCHES)
    with pytest.raises(ValueError, match="no kernel"):
        hopper_dfa.dfa_chain(meta.table, meta.accept, cls, ent)
    with pytest.raises(ValueError, match="no kernel"):
        hopper_dfa.dfa_chain_counts(meta.table, meta.accept, cls, ent)
    assert hopper_dfa.LAUNCHES == before


# ------------------------------------------------ raw bytes through the map


def byte_map_case(which):
    """(port tables, a (256,) uint8 byte map, raw bytes on 64 lanes) for
    the mapped scans: a random automaton; the same with bytes mapped to
    classes at or past C (they step to state 0 and never accept); the reset
    counter, whose guesses miss (Jacobi rounds); the parity counter over
    blocks of odd length, which never synchronizes."""
    rng = np.random.default_rng(len(which))
    if which in ("random", "past the classes"):
        _, pt = both_tables(*random_dfa_table(rng, 40, 5))
        stream = rng.integers(0, 256, size=4096).astype(np.uint8)
    elif which == "parity":
        _, pt = both_tables(*unsynced_tables(which))
        stream = np.zeros(127 * 64, np.uint8)
    else:
        _, pt = both_tables(*unsynced_tables(which))
        stream = reset_counter_text(7, 4096 // 64, 64, resets=range(0, 64, 3))
        stream = np.asarray(stream, np.uint8)[:4096]
    class_of = pt.class_of.to(torch.uint8)
    if which == "past the classes":
        class_of = class_of.clone()
        class_of[200:] = torch.arange(56, dtype=torch.uint8) % 2 * (255 - pt.num_classes) \
            + pt.num_classes
    return pt, class_of, torch.as_tensor(stream)


@pytest.mark.parametrize("emit", ["full", "mask", "counts"])
@pytest.mark.parametrize("which", ["random", "past the classes", "reset counter",
                                   "parity"])
def test_scan_fast_maps_raw_bytes_itself(emit, which):
    """``dfa_scan_fast`` given the byte map over raw bytes equals
    ``dfa_scan_fast`` over the mapped bytes: final state, states, mask,
    counts, ``converged``, ``iterations`` and ``domain_ok``, where the guess
    holds, where it misses (every Jacobi round and the speculation take the
    map too), where the scan does not converge, and for bytes mapped to no
    class of the table."""
    pt, class_of, raw = byte_map_case(which)
    want = tf.dfa_scan_fast(pt, class_of[raw.long()], num_blocks=64, emit=emit,
                            max_iters=8)
    got = tf.dfa_scan_fast(pt, raw, num_blocks=64, emit=emit, max_iters=8,
                           class_of=class_of)
    assert_fast_equal(got, want)
    if which == "reset counter":
        assert got.iterations >= 2 and got.converged
    if which == "parity":
        assert not got.converged
    if which == "past the classes":
        assert int((class_of[raw.long()] >= pt.num_classes).sum()) > 100
    if which == "random":  # unmapped, the raw bytes read as other class ids
        unmapped = tf.dfa_scan_fast(pt, raw, num_blocks=64, emit=emit, max_iters=8)
        assert not all(torch.equal(g, w) for g, w in
                       zip((got.final_state, got.counts, got.match_mask),
                           (unmapped.final_state, unmapped.counts, unmapped.match_mask))
                       if g is not None)


@pytest.mark.parametrize("emit", ["full", "counts"])
@pytest.mark.parametrize("which", ["random", "past the classes", "reset counter",
                                   "parity"])
def test_scan_fast_multi_maps_raw_bytes_itself(emit, which):
    """``dfa_scan_fast_multi`` given the byte map over two rows of raw
    bytes equals the same batch scan over the mapped bytes: final states,
    counts, states, masks, ``converged``, ``iterations`` and
    ``domain_ok``, each row's first lane pinned to its own start."""
    pt, class_of, raw = byte_map_case(which)
    rows = raw.reshape(2, -1)
    kw = dict(num_blocks=32, starts=torch.tensor([0, 1]), emit=emit, max_iters=8)
    want = tf.dfa_scan_fast_multi(pt, class_of[rows.long()], **kw)
    got = tf.dfa_scan_fast_multi(pt, rows, class_of=class_of, **kw)
    assert (got.converged, got.iterations, bool(got.domain_ok)) == \
        (want.converged, want.iterations, bool(want.domain_ok))
    for field in ("final_states", "counts", "match_mask", "states"):
        g, w = getattr(got, field), getattr(want, field)
        assert (g is None) == (w is None), field
        if g is not None:
            assert_eq(g, w)
    if which == "parity":
        assert not got.converged


@pytest.mark.parametrize("which", ["random", "256 classes", "parity"])
def test_batches_on_raw_bytes_match_jax(which, monkeypatch):
    """An equal-length batch whose width the lanes divide hands its raw
    bytes and the byte map to ``dfa_scan_fast_multi`` (no chunk padded),
    and gives JAX's counts and final states; a ragged batch's chunks stay
    mapped and padded by ``_chunk_ids``."""
    rng = np.random.default_rng(7)
    if which == "parity":
        table, accept = unsynced_tables("parity")
    else:
        table, accept = random_dfa_table(rng, 24, 3)
        if which == "random":  # bytes in 40 classes, not 256
            table = table[rng.integers(0, 40, 256)]
    dfa = CompiledDfa(table=table, accept=accept, start=0,
                      dead=-1 if which == "parity" else 23)
    cfg = EngineConfig(scan_backend="device", num_blocks=16,
                       min_block_bytes=4, chunk_bytes=1024, max_iters=4)
    tm = tapi.DfaMatcher(dfa, cfg, device="cpu")
    jm = japi.DfaMatcher(dfa, cfg)
    mapped = []
    real_multi = tapi.dfa_scan_fast_multi

    def spy(*args, **kw):
        mapped.append(kw.get("class_of") is not None)
        return real_multi(*args, **kw)
    monkeypatch.setattr(tapi, "dfa_scan_fast_multi", spy)
    batch = rng.integers(0, 256, size=(5, 2048)).astype(np.uint8)
    counts, _, converged, finals = tm._scan_batch_counts(batch)
    assert mapped == [True, True]
    want = jm._scan_batch_counts(batch)
    np.testing.assert_array_equal(counts, want[0])
    np.testing.assert_array_equal(finals, want[3])
    assert converged == bool(want[2])
    mapped.clear()
    rows = [batch[0], batch[1, :1500]]
    np.testing.assert_array_equal(tm.scan(rows).counts, jm.scan(rows).counts)
    assert mapped and not any(mapped)


@pytest.fixture(scope="module")
def tokenizer_dfas():
    """The GPT-2 byte-level and the cl100k UTF-8 tokenizer automata (the
    benchmark's two configurations), built once."""
    import json
    from pathlib import Path
    conf = json.loads((Path(__file__).resolve().parents[1] / "benchmark" / "configs"
                       / "cl100k-pretok-utf8.json").read_text())
    return {"gpt2": tapi.compile_tokenizer(device="cpu").tok,
            "cl100k": tapi.compile_tokenizer(conf["pat"], device="cpu",
                                             **conf["port"]["kwargs"]).tok}


@pytest.mark.parametrize("shorter", [0, 1])
@pytest.mark.parametrize("name", ["gpt2", "cl100k"])
def test_matcher_raw_byte_chunks_match_padded_ones(tokenizer_dfas, name, shorter,
                                                   monkeypatch):
    """``DfaMatcher`` chunks whose lanes divide them hand raw bytes and the
    byte map to the chain kernels; the others are mapped and padded by
    ``_chunk_ids``. On a corpus slice of three 16-KiB chunks and a 320-byte
    tail (every chunk on raw bytes), and one byte shorter (the tail padded),
    ``count()``, ``scan(collect_positions=True)`` and ``presplit()`` equal
    those of a matcher whose 96 lanes divide no chunk (every chunk padded),
    and the count a serial walk's."""
    from benchmark import gen

    text = np.frombuffer(b"".join(gen.documents("cpython-3.12.12-pydoc-topics")),
                         np.uint8)
    text = text[5000 : 5000 + 3 * (1 << 14) + 320 - shorter]
    mapped = []
    real_scan = tapi.dfa_scan_fast

    def spy(*args, **kw):
        mapped.append(kw.get("class_of") is not None)
        return real_scan(*args, **kw)
    monkeypatch.setattr(tapi, "dfa_scan_fast", spy)

    def matcher(lanes):
        cfg = EngineConfig(num_blocks=lanes, min_block_bytes=16, chunk_bytes=1 << 14,
                           scan_backend="device")
        return tapi.TokenizerMatcher(tokenizer_dfas[name], cfg, device="cpu")

    raw, padded = matcher(64), matcher(96)
    got = raw.scan(text, collect_positions=True)
    assert mapped == [True, True, True, not shorter]
    mapped.clear()
    want = padded.scan(text, collect_positions=True)
    assert mapped == [False] * 4
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.match_positions[0], want.match_positions[0])
    np.testing.assert_array_equal(raw.presplit(text), padded.presplit(text))
    full = raw.tables.table[raw.tables.class_of.long()].numpy()
    accept = raw.tables.accept.numpy()
    counts, final = serial_counts(full, accept, text, raw.start)
    assert raw.count(text) == padded.count(text) == counts.sum() + accept[final]
    assert got.total == counts.sum() + accept[final]
