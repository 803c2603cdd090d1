"""The port's ruleset-parallel scan (regex_fpga_tpu_torch.parallel.
multi_ruleset) against the JAX package's, on its virtual CPU mesh of the
same shape: world size 1 in this process, 4 gloo ranks on the CPU in one
spawn ((2, 2) and (4, 1)). Tolerance: none. JAX ignores the active-set
overflow flag here; the port raises on it (kept tested)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import torch_dist_ranks as R
from conftest import random_nfa
from regex_fpga_tpu.models import nfa_scan as oracle
from regex_fpga_tpu.ops import build_nfa_tables
from regex_fpga_tpu.parallel import make_mesh
from regex_fpga_tpu.parallel.multi_ruleset import (multi_ruleset_scan,
                                                   stack_nfa_tables)
from regex_fpga_tpu_torch.models import gen_l7_traffic, l7_corpus_nfa
from regex_fpga_tpu_torch.ops.tables import build_nfa_tables as tbuild
from regex_fpga_tpu_torch.parallel import make_mesh as tmesh
from regex_fpga_tpu_torch.parallel import multi_ruleset_scan as tscan
from regex_fpga_tpu_torch.parallel import stack_nfa_tables as tstack
from regex_fpga_tpu_torch.parallel.multihost import spawn_ranks


def _arrays(aut):
    return (np.asarray(aut.offsets), np.asarray(aut.trans_char),
            np.asarray(aut.trans_target))


def _rulesets(rng, r):
    return [random_nfa(rng, 20 + 7 * i, 150 + 20 * i, 3) for i in range(r)]


def _cases(shapes_r, seed):
    rng = np.random.default_rng(seed)
    return [("multi", dict(n_data=nd, n_seq=ns,
                           auts=[_arrays(a) for a in _rulesets(rng, r)],
                           stream=rng.integers(0, 256, size=1500)
                           .astype(np.uint8)))
            for nd, ns, r in shapes_r]


CASES1 = _cases([(1, 1, 1), (1, 1, 3), (1, 1, 8)], 1)
CASES4 = _cases([(2, 2, 8), (4, 1, 4), (2, 2, 4)], 4)


def _jax(kw):
    nd, ns = kw["n_data"], kw["n_seq"]
    auts = [R._aut(a) for a in kw["auts"]]
    mesh = make_mesh(nd, ns, devices=jax.devices()[:nd * ns])
    counts = multi_ruleset_scan(mesh, stack_nfa_tables(
        [build_nfa_tables(a) for a in auts]), jnp.asarray(kw["stream"]))
    counts = np.asarray(counts)
    for i, a in enumerate(auts):  # and the oracle, as tests/test_multi_ruleset.py
        np.testing.assert_array_equal(counts[i][:a.num_states],
                                      oracle(a, kw["stream"]))
    return counts


@pytest.mark.parametrize("i", range(len(CASES1)))
def test_world_size_one_matches_jax(i):
    got = R.run_cases([CASES1[i]])[0]
    np.testing.assert_array_equal(got, _jax(CASES1[i][1]))


@pytest.fixture(scope="module")
def four_ranks():
    return spawn_ranks(R.run_cases, 4, device="cpu", args=(CASES4,))


@pytest.mark.parametrize("i", range(len(CASES4)))
def test_four_gloo_ranks_match_jax(four_ranks, i):
    for r in four_ranks:
        np.testing.assert_array_equal(r[i], _jax(CASES4[i][1]))


def test_stack_matches_jax_field_by_field():
    rng = np.random.default_rng(5)
    auts = _rulesets(rng, 4) + [l7_corpus_nfa()]
    got = tstack([tbuild(a) for a in auts])
    want = stack_nfa_tables([build_nfa_tables(a) for a in auts])
    for f in ("delta", "class_of", "accept"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    assert (got.num_states, got.max_fanout) == (want.num_states, want.max_fanout)


def test_l7_beside_random_rulesets():
    """The l7-corpus NFA stacked with smaller rulesets over its traffic."""
    rng = np.random.default_rng(6)
    auts = [l7_corpus_nfa()] + _rulesets(rng, 2)
    data = np.frombuffer(b"".join(gen_l7_traffic()[0]), np.uint8)[:1200]
    got = tscan(tmesh(1, 1), tstack([tbuild(a) for a in auts]), data)
    want = multi_ruleset_scan(make_mesh(1, 1, devices=jax.devices()[:1]),
                              stack_nfa_tables([build_nfa_tables(a) for a in auts]),
                              jnp.asarray(data))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_overflow_raises_where_jax_drops_the_flag():
    """Bound 1 on a ruleset whose active set holds 2-3 states: JAX returns
    counts of a truncated set, the port raises."""
    aut = R._aut((np.array([0, 3, 4, 5, 6]), np.full(6, ord("a"), np.uint8),
                  np.array([1, 2, 3, 0, 1, 0], np.int32)))
    stream = np.full(64, ord("a"), np.uint8)
    multi_ruleset_scan(make_mesh(1, 1, devices=jax.devices()[:1]),
                       stack_nfa_tables([build_nfa_tables(aut)]),
                       jnp.asarray(stream), 1)  # JAX: no error
    with pytest.raises(RuntimeError, match="active-set bound"):
        tscan(tmesh(1, 1), tstack([tbuild(aut)]), stream, 1)
