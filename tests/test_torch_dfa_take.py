"""Torch port of the lazy-DFA chain scan (regex_fpga_tpu_torch.ops.dfa_take)
against regex_fpga_tpu.ops.dfa_take on the same seeded inputs. Tolerance:
none. The counts form is compared on the entries its K2 pass counts: the
accepting subset states and the unknown state when ``accept`` is given
(all that ``LazyDfa.accept_counts`` and ``unknown_hit`` read), every state
without it; on the CPU the passes run K1/K2's plain versions."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from regex_fpga_tpu.models.lazy_dfa import LazyDfa
from regex_fpga_tpu.ops import dfa_take as jdt
from regex_fpga_tpu_torch.models import gen_l7_traffic, l7_corpus_nfa
from regex_fpga_tpu_torch.ops import dfa_take as tdt


def traffic(seed, n_payloads=200):
    return np.frombuffer(b"".join(gen_l7_traffic(n_payloads, seed)[0]), np.uint8)


WARM = np.concatenate([traffic(s) for s in range(20, 26)])


def snapshot_case(warm, n=8192, pad=None):
    """The l7-corpus lazy DFA warmed on ``warm`` bytes of seeded traffic,
    its padded device table and accept mask (accepting subsets and
    unknown), and the classes of ``n`` bytes of other traffic."""
    ld = LazyDfa(l7_corpus_nfa())
    ld.host_scan(WARM[:warm])
    table, unknown, n_acc = ld.snapshot(pad_to=pad)
    accept = n_acc > 0
    accept[unknown] = True
    classes = ld.class_of[traffic(17)[:n]].astype(np.uint8)
    return ld, table, unknown, accept, classes


def assert_counts_equal(got, want, accept):
    assert int(got.final_state) == int(want.final_state)
    assert got.converged == bool(want.converged)
    assert bool(got.unknown_hit) == bool(want.unknown_hit)
    assert got.iterations == int(want.iterations)
    np.testing.assert_array_equal(got.visits_acc.numpy()[accept],
                                  np.asarray(want.visits_acc)[accept])


@pytest.mark.parametrize("warm,num_blocks,overlap", [
    (100_000, 16, 64), (100_000, 64, 64), (2000, 32, 0), (30_000, 8, 4096)])
def test_take_states_match_jax(warm, num_blocks, overlap):
    ld, table, _, _, classes = snapshot_case(warm, pad=2048)
    got = tdt.dfa_scan_take(torch.as_tensor(table), torch.as_tensor(classes),
                            num_blocks=num_blocks, start=ld.start,
                            sync_overlap=overlap, sync_state=ld.start)
    want = jdt.dfa_scan_take(jnp.asarray(table), jnp.asarray(classes),
                             num_blocks=num_blocks, start=ld.start,
                             sync_overlap=overlap, sync_state=ld.start)
    assert int(got.final_state) == int(want.final_state)
    np.testing.assert_array_equal(got.states.numpy(), np.asarray(want.states))
    assert got.converged == bool(want.converged)
    assert got.iterations == int(want.iterations)


@pytest.mark.parametrize("warm,clean", [(0, False), (2000, False),
                                        (30_000, False), (100_000, True)])
def test_take_counts_match_jax(warm, clean):
    """Small warm-ups leave the walk falling off the frontier (unknown hit)
    or its seams unsettled (not converged), with the accumulator untouched;
    a large one keeps it clean, accepts counted."""
    ld, table, _, accept, classes = snapshot_case(warm)
    acc0 = np.arange(len(accept), dtype=np.int32) % 5
    got = tdt.dfa_scan_take_counts(
        torch.as_tensor(table), torch.as_tensor(classes), torch.as_tensor(acc0),
        num_blocks=32, start=ld.start, sync_state=ld.start,
        accept=torch.as_tensor(accept))
    want = jdt.dfa_scan_take_counts(
        jnp.asarray(table), jnp.asarray(classes), jnp.asarray(acc0),
        num_blocks=32, start=ld.start, sync_state=ld.start)
    assert_counts_equal(got, want, accept)
    assert (got.converged and not bool(got.unknown_hit)) == clean
    if clean:
        assert (got.visits_acc.numpy() > acc0)[accept].any()
    else:
        np.testing.assert_array_equal(got.visits_acc.numpy(), acc0)


@pytest.mark.parametrize("warm,num_blocks", [(100_000, 16), (100_000, 32)])
def test_take_counts_jax_call_counts_every_state(warm, num_blocks):
    """A call written for JAX (no ``accept``, the parameters positional in
    JAX's order) counts the visits of every state: the whole accumulator
    equals JAX's."""
    ld, table, _, _, classes = snapshot_case(warm)
    acc0 = np.arange(table.shape[1], dtype=np.int32) % 3
    got = tdt.dfa_scan_take_counts(
        torch.as_tensor(table), torch.as_tensor(classes), torch.as_tensor(acc0),
        num_blocks, ld.start, 16, 64, ld.start)
    want = jdt.dfa_scan_take_counts(
        jnp.asarray(table), jnp.asarray(classes), jnp.asarray(acc0),
        num_blocks, ld.start, 16, 64, ld.start)
    assert_counts_equal(got, want, np.ones(table.shape[1], bool))
    assert got.converged and not bool(got.unknown_hit)
    assert int((got.visits_acc.numpy() - acc0).sum()) == len(classes)


def test_final_byte_frontier_escape():
    """A chunk whose LAST transition lands on the unknown state is flagged,
    as in JAX: the sentinel never leaks into the carry."""
    table = np.array([[1, 2, 3, 3]], dtype=np.int32)  # 0->1->2->unknown
    accept = np.array([False, False, False, True])
    acc0 = np.zeros(4, np.int32)
    got = tdt.dfa_scan_take_counts(
        torch.as_tensor(table), torch.zeros(3, dtype=torch.uint8),
        torch.as_tensor(acc0), num_blocks=1, start=0, sync_overlap=0,
        accept=torch.as_tensor(accept))
    want = jdt.dfa_scan_take_counts(
        jnp.asarray(table), jnp.zeros(3, jnp.int32), jnp.asarray(acc0),
        num_blocks=1, start=0, sync_overlap=0)
    assert bool(got.unknown_hit) and bool(want.unknown_hit)
    assert_counts_equal(got, want, accept)


def test_non_converging_chain_matches_jax():
    """A parity counter never synchronizes: the Jacobi loop stops at
    max_iters unconverged, with the same states, and the counts form leaves
    the accumulator untouched."""
    table = np.array([[1, 0, 2]], dtype=np.int32)  # 2 = unknown, unreached
    accept = np.array([True, False, True])
    classes = np.zeros(80, np.uint8)  # 16 blocks of 5: odd, so guesses miss
    for start in (0, 1):
        got = tdt.dfa_scan_take(torch.as_tensor(table), torch.as_tensor(classes),
                                num_blocks=16, start=start, max_iters=3,
                                sync_overlap=3)
        want = jdt.dfa_scan_take(jnp.asarray(table), jnp.asarray(classes),
                                 num_blocks=16, start=start, max_iters=3,
                                 sync_overlap=3)
        assert not got.converged and not bool(want.converged)
        assert got.iterations == int(want.iterations) == 3
        np.testing.assert_array_equal(got.states.numpy(), np.asarray(want.states))
        acc0 = np.full(3, 7, np.int32)
        gc = tdt.dfa_scan_take_counts(
            torch.as_tensor(table), torch.as_tensor(classes),
            torch.as_tensor(acc0), num_blocks=16, start=start, max_iters=3,
            sync_overlap=3, accept=torch.as_tensor(accept))
        wc = jdt.dfa_scan_take_counts(
            jnp.asarray(table), jnp.asarray(classes), jnp.asarray(acc0),
            num_blocks=16, start=start, max_iters=3, sync_overlap=3)
        assert_counts_equal(gc, wc, accept)
        np.testing.assert_array_equal(gc.visits_acc.numpy(), acc0)


def test_device_scalar_start_chains_chunks():
    """``start`` as a 0-d tensor (the previous chunk's final state) gives
    the same result as the host integer."""
    ld, table, _, accept, classes = snapshot_case(100_000)
    t, a = torch.as_tensor(table), torch.as_tensor(accept)
    half = len(classes) // 2
    first = tdt.dfa_scan_take_counts(t, torch.as_tensor(classes[:half]),
                                     torch.zeros(len(accept), dtype=torch.int32),
                                     num_blocks=16, start=ld.start, accept=a)
    second = tdt.dfa_scan_take_counts(t, torch.as_tensor(classes[half:]),
                                      first.visits_acc, num_blocks=16,
                                      start=first.final_state, accept=a)
    again = tdt.dfa_scan_take_counts(t, torch.as_tensor(classes[half:]),
                                     first.visits_acc, num_blocks=16,
                                     start=int(first.final_state), accept=a)
    assert torch.equal(second.visits_acc, again.visits_acc)
    whole = tdt.dfa_scan_take_counts(t, torch.as_tensor(classes),
                                     torch.zeros(len(accept), dtype=torch.int32),
                                     num_blocks=32, start=ld.start, accept=a)
    for r in (first, second, whole):
        assert r.converged and not bool(r.unknown_hit)
    assert torch.equal(second.visits_acc, whole.visits_acc)
    assert int(second.final_state) == int(whole.final_state)


def test_accept_mask_must_cover_unknown():
    table = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown"):
        tdt.dfa_scan_take_counts(table, torch.zeros(4, dtype=torch.uint8),
                                 torch.zeros(4, dtype=torch.int32), num_blocks=1,
                                 accept=torch.zeros(4, dtype=torch.bool))
