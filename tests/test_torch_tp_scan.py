"""The port's tensor-parallel NFA scan (regex_fpga_tpu_torch.parallel.tp_scan,
K5's plain version on the CPU) against the JAX package's nfa_scan_tp on its
virtual CPU mesh of the same shape.

World size 1 runs in this process (one K5 route); 4 ranks run as gloo
processes on the CPU in one spawn, on the (data, model) shapes (1, 4),
(2, 2) and (4, 1): the multi-rank route, with one all_reduce over model a
byte. Tolerance: none; counts and the final bitmaps (the resume carries,
the cleared sentinel slot included) must be equal."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_dist_ranks as R
from conftest import random_nfa
from regex_fpga_tpu.models import nfa_scan as oracle
from regex_fpga_tpu.ops import build_nfa_tables, nfa_scan_jax
from regex_fpga_tpu.parallel import make_tp_mesh, nfa_scan_tp, pad_tables_tp
from regex_fpga_tpu_torch.models import gen_l7_traffic, l7_corpus_nfa
from regex_fpga_tpu_torch.ops import hopper_nfa
from regex_fpga_tpu_torch.ops.tables import (build_nfa_csr, nfa_csr_from_tables,
                                             build_nfa_tables as tbuild)
from regex_fpga_tpu_torch.parallel import make_tp_mesh as tmesh
from regex_fpga_tpu_torch.parallel import nfa_scan_tp as tscan
from regex_fpga_tpu_torch.parallel import pad_tables_tp as tpad
from regex_fpga_tpu_torch.parallel.multihost import spawn_ranks
from regex_fpga_tpu_torch.parallel.tp_scan import tp_route


def _arrays(aut):
    return (np.asarray(aut.offsets), np.asarray(aut.trans_char),
            np.asarray(aut.trans_target))


def _cases(shapes, seed):
    rng = np.random.default_rng(seed)
    cases = []
    for nd, nm in shapes:
        for n_states, n_edges, n_acc in ((61, 500, 6), (30, 260, 3),
                                         (40, 300, 4)):
            aut = random_nfa(rng, n_states, n_edges, n_acc)
            streams = rng.integers(0, 256, size=(2 * nd, 300)).astype(np.uint8)
            cases.append(("tp", dict(n_data=nd, n_model=nm, aut=_arrays(aut),
                                     streams=streams)))
        aut = random_nfa(rng, 30, 260, 3)
        cases.append(("tp", dict(  # two chunks, the second resumed
            n_data=nd, n_model=nm, aut=_arrays(aut), split=150,
            streams=rng.integers(0, 256, size=(2 * nd, 400)).astype(np.uint8))))
    return cases


CASES1 = _cases([(1, 1)], 1)
CASES4 = _cases([(1, 4), (2, 2), (4, 1)], 4)


def _jax(kw):
    nd, nm = kw["n_data"], kw["n_model"]
    mesh = make_tp_mesh(n_model=nm, n_data=nd, devices=jax.devices()[:nd * nm])
    tables = build_nfa_tables(R._aut(kw["aut"]))
    streams = kw["streams"]
    split = kw.get("split")
    if split is None:
        c, f = nfa_scan_tp(mesh, tables, jnp.asarray(streams))
    else:
        c1, b1 = nfa_scan_tp(mesh, tables, jnp.asarray(streams[:, :split]))
        c, f = nfa_scan_tp(mesh, tables, jnp.asarray(streams[:, split:]),
                           start_bitmap=b1, counts_init=c1)
    return np.asarray(c), np.asarray(f)


def _check(kw, got):
    want = _jax(kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("i", range(len(CASES1)))
def test_world_size_one_matches_jax(i):
    name, kw = CASES1[i]
    _check(kw, R.run_cases([CASES1[i]])[0])


@pytest.fixture(scope="module")
def four_ranks():
    return spawn_ranks(R.run_cases, 4, args=(CASES4,))


@pytest.mark.parametrize("i", range(len(CASES4)),
                         ids=[f"{c['n_data']}x{c['n_model']}-{j}"
                              for j, (_, c) in enumerate(CASES4)])
def test_four_gloo_ranks_match_jax(four_ranks, i):
    got = [r[i] for r in four_ranks]
    for other in got[1:]:
        for a, b in zip(other, got[0]):
            np.testing.assert_array_equal(a, b)
    _check(CASES4[i][1], got[0])


def test_l7_corpus_matches_jax_and_the_oracle():
    """The l7-corpus NFA (722 states) on its own traffic: K5's plain
    version equals JAX's scan (counts and bitmaps) and the oracle."""
    aut = l7_corpus_nfa()
    data = np.frombuffer(b"".join(gen_l7_traffic()[0]), np.uint8)
    streams = np.stack([data[:2000], data[5000:7000]])
    got = tscan(tmesh(1, 1), build_nfa_csr(aut), streams)
    jmesh = make_tp_mesh(1, 1, devices=jax.devices()[:1])
    want = nfa_scan_tp(jmesh, build_nfa_tables(aut), jnp.asarray(streams))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[0].sum()) > 0
    for i in range(2):
        np.testing.assert_array_equal(got[0][i].numpy(), oracle(aut, streams[i]))


def test_final_bitmap_matches_active_list():
    rng = np.random.default_rng(3)
    aut = random_nfa(rng, n_states=40, n_edges=300, n_accept=4)
    stream = rng.integers(0, 256, size=(1, 200)).astype(np.uint8)
    counts, finals = tscan(tmesh(1, 1), tbuild(aut), stream)
    res = nfa_scan_jax(build_nfa_tables(aut), jnp.asarray(stream[0]))
    active = np.asarray(res.final_active)
    active = set(active[active < aut.num_states].tolist())
    assert set(np.nonzero(finals[0].numpy()[:40])[0].tolist()) == active
    np.testing.assert_array_equal(counts[0].numpy(), np.asarray(res.counts))


@pytest.mark.parametrize("n_model", [1, 2, 3, 4, 8])
def test_pad_tables_tp_matches_jax(n_model):
    rng = np.random.default_rng(n_model)
    aut = random_nfa(rng, 37, 200, 3)
    d, a, s_pad = tpad(tbuild(aut), n_model)
    jd, ja, js = pad_tables_tp(build_nfa_tables(aut), n_model)
    assert s_pad == js
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))


def test_start_carries_with_sentinel_and_padding_bits():
    """Bits set in the sentinel and padding slots of a start bitmap and any
    start counts, as JAX takes them (S_pad > S + 1 on 8 model devices)."""
    rng = np.random.default_rng(9)
    aut = random_nfa(rng, 45, 300, 4)
    s = aut.num_states
    s_pad = 48  # 46 rounded up to 8 model devices
    bm = rng.random((2, s_pad)) < 0.3
    bm[:, 0] = True
    cnt = rng.integers(0, 50, size=(2, s_pad)).astype(np.int32)
    streams = rng.integers(0, 256, size=(2, 120)).astype(np.uint8)
    jmesh = make_tp_mesh(n_model=8, devices=jax.devices())
    want = nfa_scan_tp(jmesh, build_nfa_tables(aut), jnp.asarray(streams),
                       start_bitmap=jnp.asarray(bm), counts_init=jnp.asarray(cnt))
    csr = build_nfa_csr(aut)
    got = hopper_nfa.nfa_tp_scan_plain(csr, torch.as_tensor(streams),
                                       torch.as_tensor(bm), torch.as_tensor(cnt))
    np.testing.assert_array_equal(got[0][:, :s].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    # a stream of no bytes keeps its carries as given
    empty = torch.zeros((2, 0), dtype=torch.uint8)
    c0, b0 = hopper_nfa.nfa_tp_scan(csr, empty, torch.as_tensor(bm),
                                    torch.as_tensor(cnt))
    assert torch.equal(b0, torch.as_tensor(bm)) and torch.equal(c0, torch.as_tensor(cnt))


def test_dense_tables_and_csr_agree():
    """``nfa_csr_from_tables`` of the dense table is the automaton's CSR."""
    rng = np.random.default_rng(4)
    aut = random_nfa(rng, 50, 400, 5)
    a, b = nfa_csr_from_tables(tbuild(aut)), build_nfa_csr(aut)
    for f in ("offsets", "targets", "class_of", "accept"):
        assert torch.equal(getattr(a, f), getattr(b, f))
    assert a.num_states == b.num_states


def test_route_names_what_the_per_byte_collective_forces():
    assert "K5" in tp_route(tmesh(1, 1))


def test_pack_bits_round_trip():
    rng = np.random.default_rng(0)
    for n in (1, 31, 32, 33, 723):
        bm = torch.as_tensor(rng.random((3, n)) < 0.5)
        words = hopper_nfa._pack_bits(bm)
        assert words.dtype == torch.int32 and words.shape == (3, -(-n // 32))
        assert torch.equal(hopper_nfa._unpack_bits(words, n), bm)


def test_sharded_scan_on_the_cpu_is_the_plain_step():
    """CPU tensors take the plain step, on any slice of the states; a slice
    outside S_pad, or an S_pad without the sentinel, is refused."""
    rng = np.random.default_rng(11)
    aut = random_nfa(rng, 40, 250, 4)
    s = aut.num_states
    csr = build_nfa_csr(aut)
    streams = torch.as_tensor(rng.integers(0, 256, size=(3, 90)).astype(np.uint8))
    s_pad, half = 42, 21
    before = hopper_nfa.LAUNCHES["nfa_tp_step"]
    bm = torch.as_tensor(rng.random((3, half)) < 0.2)
    cnt = torch.as_tensor(rng.integers(0, 9, size=(3, half)).astype(np.int32))
    for lo in (0, half):
        got = hopper_nfa.nfa_tp_scan_sharded(csr, streams, bm, cnt, lo, s_pad)
        want = hopper_nfa.nfa_tp_scan_plain(csr, streams, bm, cnt, lo, s_pad)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert hopper_nfa.LAUNCHES["nfa_tp_step"] == before
    with pytest.raises(ValueError):
        hopper_nfa.nfa_tp_scan_sharded(csr, streams, bm, cnt, 22, s_pad)
    with pytest.raises(ValueError):
        hopper_nfa.nfa_tp_scan_sharded(csr, streams, bm, cnt, 0, s)
