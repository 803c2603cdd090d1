"""Torch port exact engine (regex_fpga_tpu_torch.ops.dfa_engine, the fast
engine's fallback) against the JAX one, on the same seeded numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regex_fpga_tpu.ops import build_dfa_tables as jax_build_dfa_tables
from regex_fpga_tpu.ops import dfa_engine as je
from regex_fpga_tpu_torch.ops import dfa_engine as te
from regex_fpga_tpu_torch.ops.hopper_dfa import dfa_block_fns
from regex_fpga_tpu_torch.ops.tables import tables_from_numpy

from conftest import random_dfa_table


def both_tables(table, accept):
    j = jax_build_dfa_tables(table, accept)
    return j, tables_from_numpy(np.asarray(j.table), np.asarray(j.class_of),
                                np.asarray(j.accept), j.num_states)


def assert_result_equal(got, want):
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    assert int(got.final_state) == int(want.final_state)
    np.testing.assert_array_equal(got.match_mask.numpy(),
                                  np.asarray(want.match_mask))


def parity_tables():
    ptable = np.zeros((256, 2), dtype=np.int32)
    ptable[:, 0] = 1
    return both_tables(ptable, np.array([False, True]))


@pytest.mark.parametrize("seed,s,length,start", [
    (0, 24, 777, 0), (1, 9, 1, 4), (2, 40, 0, 0),
])
def test_serial_matches_jax(seed, s, length, start):
    rng = np.random.default_rng(seed)
    jt, pt = both_tables(*random_dfa_table(rng, s, 2))
    stream = rng.integers(0, 256, size=length).astype(np.uint8)
    want = je.dfa_scan_serial(jt, jnp.asarray(stream), start=start)
    assert_result_equal(te.dfa_scan_serial(pt, stream, start=start), want)
    assert_result_equal(te.dfa_scan_serial(pt, torch.as_tensor(stream),
                                           start=start), want)


@pytest.mark.parametrize("seed,s,nb,b", [(0, 11, 16, 32), (1, 30, 5, 64),
                                         (2, 4, 1, 8)])
def test_block_functions_and_entries_match_jax(seed, s, nb, b):
    rng = np.random.default_rng(seed)
    jt, pt = both_tables(*random_dfa_table(rng, s, 1))
    classes = rng.integers(0, jt.num_classes, size=(nb, b)).astype(np.int32)
    fj = je.block_transition_functions(jt, jnp.asarray(classes))
    ft = te.block_transition_functions(pt, torch.as_tensor(classes))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    for start in (0, s - 1):
        ej, fin_j = je.block_entry_states(fj, start)
        et, fin_t = te.block_entry_states(ft, start)
        np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
        assert int(fin_t) == int(fin_j)
    np.testing.assert_array_equal(
        te.compose(ft[:-1], ft[1:]).numpy(),
        np.asarray(je.compose(fj[:-1], fj[1:])),
    )


def entry_case(rng, kind, nb, s):
    """(NB, S) block functions: "constant", "identity", "permutation",
    "random", or "mixed" (random with every third function constant)."""
    if kind == "constant":
        f = np.repeat(rng.integers(0, s, size=(nb, 1)), s, axis=1)
    elif kind == "identity":
        f = np.tile(np.arange(s), (nb, 1))
    elif kind == "permutation":
        f = np.stack([rng.permutation(s) for _ in range(nb)])
    else:
        f = rng.integers(0, s, size=(nb, s))
        if kind == "mixed":
            f[::3] = rng.integers(0, s, size=(len(f[::3]), 1))
    return f.astype(np.int32)


@pytest.mark.parametrize("kind", ["constant", "identity", "permutation",
                                  "random", "mixed"])
@pytest.mark.parametrize("nb,s,start", [
    (1, 6, 0),      # one block
    (1, 6, 5),      # one block, a start other than 0
    (13, 3, 2),     # NB not a power of two
    (64, 17, 9),    # a power of two
    (100, 2, 1),    # parity-sized
])
def test_block_entry_states_match_jax(kind, nb, s, start):
    """The combine (the doubling on the CPU, K6's combine kernel's plain
    version) against JAX's associative scan: entry states and the final
    state, from an int start and from a one-element tensor."""
    rng = np.random.default_rng(nb * 31 + s)
    f = entry_case(rng, kind, nb, s)
    ej, fin_j = je.block_entry_states(jnp.asarray(f), start)
    for first in (start, torch.tensor([start], dtype=torch.int32)):
        et, fin_t = te.block_entry_states(torch.as_tensor(f), first)
        np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
        assert et.dtype == torch.int32 and fin_t.shape == ()
        assert int(fin_t) == int(fin_j)


@pytest.mark.parametrize("bad", ["entry -1", "entry S", "start -1",
                                 "start S", "int start S"])
def test_block_entry_states_range_check(bad):
    """The combine's contract: ``block_entry_states`` checks caller-built
    functions and a start, and raises ``ValueError`` on an entry or a start
    outside [0, S) (the card raises the same: test_torch_kernels.py); on
    in-range functions it equals JAX's."""
    rng = np.random.default_rng(5)
    s = 7
    f = entry_case(rng, "mixed", 40, s)
    ej, fin_j = je.block_entry_states(jnp.asarray(f), 3)
    et, fin_t = te.block_entry_states(torch.as_tensor(f), 3)
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    assert int(fin_t) == int(fin_j)
    start = torch.tensor([3], dtype=torch.int32)
    what, value = bad.rsplit(" ", 1)
    value = s if value == "S" else int(value)
    if what == "entry":
        f[17, 2] = value
        match = "entries span"
    elif what == "start":
        start = torch.tensor([value], dtype=torch.int32)
        match = "start state"
    else:
        start = value
        match = "start state"
    with pytest.raises(ValueError, match=match):
        te.block_entry_states(torch.as_tensor(f), start)


def test_blocked_without_matches_matches_jax():
    """``collect_matches=False`` keeps the counts and the final state and
    drops the mask, as in JAX."""
    rng = np.random.default_rng(3)
    jt, pt = both_tables(*random_dfa_table(rng, 20, 3))
    stream = rng.integers(0, 256, size=4 * 256).astype(np.uint8)
    want = je.dfa_scan_blocked(jt, jnp.asarray(stream), 256, 5, False)
    got = te.dfa_scan_blocked(pt, torch.as_tensor(stream), 256, 5, False)
    assert want.match_mask is None and got.match_mask is None
    assert got.states is None
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    assert int(got.final_state) == int(want.final_state)


@pytest.mark.parametrize("seed,s,blocks,block_size,start", [
    (0, 24, 8, 128, 0), (1, 48, 3, 1024, 7), (2, 6, 1, 64, 0),
])
def test_blocked_matches_jax(seed, s, blocks, block_size, start):
    rng = np.random.default_rng(seed)
    jt, pt = both_tables(*random_dfa_table(rng, s, 3))
    stream = rng.integers(0, 256, size=blocks * block_size).astype(np.uint8)
    want = je.dfa_scan_blocked(jt, jnp.asarray(stream), block_size=block_size,
                               start=start)
    got = te.dfa_scan_blocked(pt, torch.as_tensor(stream),
                              block_size=block_size, start=start)
    assert_result_equal(got, want)


def test_blocked_is_exact_on_parity_automaton():
    """The exact path settles what the Jacobi seams cannot."""
    jt, pt = parity_tables()
    stream = np.zeros(7 * 128, np.uint8)
    want = je.dfa_scan_blocked(jt, jnp.asarray(stream), block_size=128)
    got = te.dfa_scan_blocked(pt, torch.as_tensor(stream), block_size=128)
    assert_result_equal(got, want)
    assert_result_equal(got, te.dfa_scan_serial(pt, stream))


@pytest.mark.parametrize("s", [5, 97, 1000])
@pytest.mark.parametrize("group", [1, 3, None])
def test_grouped_blocked_scan_matches_jax(s, group, monkeypatch):
    """The blocked scan in groups of blocks (1, 3, or all NB at once), each
    group entered in the final state of the one before, equals JAX's scan
    over the whole stream: counts, final state, mask, and the states."""
    rng = np.random.default_rng(s)
    nb = 7
    monkeypatch.setattr(te, "FN_GROUP_BYTES", (group or nb) * 4 * s)
    jt, pt = both_tables(*random_dfa_table(rng, s, 3))
    b, start = 64, s // 2
    stream = rng.integers(0, 256, size=nb * b).astype(np.uint8)
    want = je.dfa_scan_blocked(jt, jnp.asarray(stream), block_size=b, start=start)
    got = te.dfa_scan_blocked(pt, torch.as_tensor(stream), block_size=b,
                              start=start)
    assert_result_equal(got, want)
    serial = te.dfa_scan_serial(pt, stream, start=start)
    np.testing.assert_array_equal(got.states.numpy(), serial.states.numpy())
    # pass 1 of one group against JAX's block functions
    classes = np.asarray(jt.class_of)[stream].reshape(nb, b)
    np.testing.assert_array_equal(
        te.block_transition_functions(pt, torch.as_tensor(classes[:3])).numpy(),
        np.asarray(je.block_transition_functions(jt, jnp.asarray(classes[:3]))))


def test_default_groups_bound_the_block_functions(monkeypatch):
    """The default group holds at most FN_GROUP_BYTES of block functions."""
    jt, pt = parity_tables()
    seen = []
    real = te.block_transition_functions
    monkeypatch.setattr(te, "FN_GROUP_BYTES", 3 * 4 * 2)  # 3 blocks of S=2
    monkeypatch.setattr(te, "block_transition_functions",
                        lambda t, c: seen.append(c.shape[0]) or real(t, c))
    stream = np.frombuffer(b"\x01\x00" * 512, np.uint8)
    got = te.dfa_scan_blocked(pt, torch.as_tensor(stream), block_size=128)
    assert seen == [3, 3, 2]
    assert_result_equal(got, je.dfa_scan_blocked(jt, jnp.asarray(stream),
                                                 block_size=128))


def test_dfa_match_positions_matches_jax():
    rng = np.random.default_rng(9)
    jt, pt = both_tables(*random_dfa_table(rng, 12, 2))
    stream = rng.integers(0, 256, size=4 * 256).astype(np.uint8)
    want = je.dfa_match_positions(
        je.dfa_scan_blocked(jt, jnp.asarray(stream), block_size=256))
    got = te.dfa_match_positions(
        te.dfa_scan_blocked(pt, torch.as_tensor(stream), block_size=256))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="mask"):
        te.dfa_match_positions(te.DfaScanResult(got, got, None))


def test_block_functions_reject_a_corrupt_table():
    jt, pt = parity_tables()
    bad = pt.table.clone()
    bad[0, 1] = 7
    with pytest.raises(ValueError, match="corrupt"):
        dfa_block_fns(bad, torch.zeros((2, 8), dtype=torch.uint8))
