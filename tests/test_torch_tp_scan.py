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


BOUNDARY = (1023, 1024, 1025)  # W = 32, 32, 33 words: both K5 bitmap routes


def _carries(rng, b, n_states, s_pad):
    """Start bitmaps with bits in the sentinel and padding slots, and start
    counts of any value, over ``s_pad`` slots."""
    bm = rng.random((b, s_pad)) < 0.02
    bm[:, 0] = True
    bm[:, n_states:] = True  # the sentinel and every padding slot
    return bm, rng.integers(0, 50, size=(b, s_pad)).astype(np.int32)


def _boundary_cases(shapes, seed):
    rng = np.random.default_rng(seed)
    cases = []
    for nd, nm in shapes:
        for n_states in BOUNDARY:
            aut = random_nfa(rng, n_states, 3 * n_states, n_states // 50)
            s_pad = -(-(n_states + 1) // nm) * nm
            bm, cnt = _carries(rng, 2 * nd, n_states, s_pad)
            streams = rng.integers(0, 256, size=(2 * nd, 120)).astype(np.uint8)
            cases.append(("tp", dict(n_data=nd, n_model=nm, aut=_arrays(aut),
                                     streams=streams, start_bitmap=bm,
                                     counts_init=cnt)))
    return cases


CASES1 = _cases([(1, 1)], 1)
CASES4 = _cases([(1, 4), (2, 2), (4, 1)], 4) \
    + _boundary_cases([(1, 4), (2, 2)], 44)


def _jax(kw):
    nd, nm = kw["n_data"], kw["n_model"]
    mesh = make_tp_mesh(n_model=nm, n_data=nd, devices=jax.devices()[:nd * nm])
    tables = build_nfa_tables(R._aut(kw["aut"]))
    streams = kw["streams"]
    split = kw.get("split")
    if split is None:
        carries = {k: jnp.asarray(kw[k]) for k in ("start_bitmap", "counts_init")
                   if kw.get(k) is not None}
        c, f = nfa_scan_tp(mesh, tables, jnp.asarray(streams), **carries)
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
    return spawn_ranks(R.run_cases, 4, device="cpu", args=(CASES4,))


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


@pytest.mark.parametrize("n_states", BOUNDARY)
def test_boundary_sizes_world_size_one_match_jax(n_states):
    """Random NFAs on both sides of K5's register/list boundary (S = 1,023,
    1,024, 1,025: W = 32, 32, 33 words), from start carries with the
    sentinel bit set: the one-rank scan on a 1x1 mesh equals JAX's; and the
    plain step with uint8 flags over an S_pad of four ranks (padding bits
    set, all states on one rank, no sum) equals JAX on four devices."""
    rng = np.random.default_rng(n_states)
    aut = random_nfa(rng, n_states, 3 * n_states, n_states // 50)
    streams = rng.integers(0, 256, size=(2, 150)).astype(np.uint8)
    csr = build_nfa_csr(aut)
    tables = build_nfa_tables(aut)
    for n_model in (1, 4):
        s_pad = -(-(n_states + 1) // n_model) * n_model
        bm, cnt = _carries(rng, 2, n_states, s_pad)
        jmesh = make_tp_mesh(n_model=n_model, devices=jax.devices()[:n_model])
        want = nfa_scan_tp(jmesh, tables, jnp.asarray(streams),
                           start_bitmap=jnp.asarray(bm),
                           counts_init=jnp.asarray(cnt))
        if n_model == 1:
            got = tscan(tmesh(1, 1), csr, streams, bm, cnt)
        else:
            got = hopper_nfa.nfa_tp_scan_plain(
                csr, torch.as_tensor(streams), torch.as_tensor(bm),
                torch.as_tensor(cnt), 0, s_pad)
            got = (got[0][:, :n_states], got[1])
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_plain_step_sums_uint8_flags():
    """The plain step hands ``all_reduce`` (B, S_pad) uint8 flags of 0 or 1,
    whose sum over the ranks is read as > 0."""
    rng = np.random.default_rng(12)
    aut = random_nfa(rng, 40, 250, 4)
    csr = build_nfa_csr(aut)
    streams = torch.as_tensor(rng.integers(0, 256, size=(3, 20)).astype(np.uint8))
    bm = torch.zeros((3, 21), dtype=torch.bool)
    bm[:, 0] = True
    seen = []

    def summed(x):  # a second rank that flags every state
        seen.append((x.dtype, int(x.max())))
        x += 1

    got = hopper_nfa.nfa_tp_scan_plain(csr, streams, bm,
                                       torch.zeros((3, 21), dtype=torch.int32),
                                       0, 42, summed)
    assert seen and all(d == torch.uint8 and m <= 1 for d, m in seen)
    assert bool(got[1].all())


def test_model_axis_of_more_than_255_ranks_raises():
    """The uint8 flags' sum over the model axis must not wrap: a mesh built
    by hand with 256 model ranks is refused before any collective."""
    from regex_fpga_tpu_torch.parallel.mesh import Mesh

    aut = random_nfa(np.random.default_rng(13), 30, 200, 3)
    mesh = Mesh(("data", "model"), {"data": 1, "model": 256},
                {"data": 0, "model": 0}, {"data": (None, [0]),
                                          "model": (None, list(range(256)))},
                None)
    with pytest.raises(ValueError, match="255"):
        tscan(mesh, build_nfa_csr(aut), np.zeros((1, 8), np.uint8))


def test_spawn_ranks_defaults_to_the_card(monkeypatch):
    """With no device, ``spawn_ranks`` runs the ranks on the card, and
    raises when no card is visible, as every entry point of the port does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        spawn_ranks(R.run_cases, 2, args=([],))


def _trie(rng, n_patterns, n_bytes):
    """An unanchored literal trie with no shared prefixes: the start state
    loops on every byte and starts each pattern's chain; one-byte patterns
    make start successors accept."""
    from regex_fpga_tpu.models import CsrAutomaton

    src, chars, tgts, nxt = [0] * 256, list(range(256)), [0] * 256, 1
    for _ in range(n_patterns):
        prev = 0
        for _ in range(int(rng.integers(1, 6))):
            src.append(prev)
            chars.append(int(rng.integers(0, n_bytes)))
            tgts.append(nxt)
            prev, nxt = nxt, nxt + 1
    src = np.array(src)
    order = np.argsort(src, kind="stable")
    return CsrAutomaton(
        offsets=np.searchsorted(src[order], np.arange(nxt + 1)).astype(np.int64),
        trans_char=np.array(chars, np.uint8)[order],
        trans_target=np.array(tgts, np.int32)[order])


@pytest.mark.parametrize("case", ["l7", "random", "one state", "dense", "trie"])
def test_k5_start_pairs_and_edge_slots(case):
    """What K5 reads beside the CSR, built on the CPU: the start state's
    (word, mask) pairs and self-loop flag give back row 0 of every class,
    each state's edge slots give back its rows, and the longest other row
    and the accepting count are the CSR's."""
    rng = np.random.default_rng(21)
    aut = {"l7": l7_corpus_nfa, "random": lambda: random_nfa(rng, 300, 350, 9),
           "one state": lambda: random_nfa(rng, 2, 3, 1),
           "dense": lambda: random_nfa(rng, 200, 3000, 9),
           "trie": lambda: _trie(rng, 60, 6)}[case]()
    csr = build_nfa_csr(aut)
    n_acc, start_off, rows, two_step, slots, d, max_row = hopper_nfa._k5_aux(csr)
    assert hopper_nfa._k5_aux(csr)[1] is start_off  # built once per CSR
    s, c = csr.num_states, csr.num_classes
    off, tg = csr.offsets.numpy(), csr.targets.numpy()
    so = start_off.numpy().astype(np.int64) & 0xffffffff
    deg = np.diff(off, axis=1)[:, :s].sum(0)
    for k in range(c):
        want = set(tg[off[k, 0]:off[k, 1]].tolist())
        got = {0} if (so[k] >> 31) & 1 else set()
        for w, m in rows.numpy()[so[k] & 0x3fffffff:so[k + 1] & 0x3fffffff].tolist():
            assert m != 0 and not (w == 0 and m & 1)
            got |= {32 * w + b for b in range(32) if (m >> b) & 1}
        assert got == want
    assert d == (int(deg[1:].max()) if 0 < deg[1:].max() <= 8 else 0)
    if d:
        cells = slots.numpy().astype(np.int64) & 0xffffffff
        assert (cells[0] == 0xffffffff).all()
        for st in range(1, s):
            want = sorted((k, t) for k in range(c)
                          for t in tg[off[k, st]:off[k, st + 1]].tolist())
            got = sorted((int(x >> 24), int(x & 0xffffff)) for x in cells[st]
                         if x != 0xffffffff)
            assert got == want
    assert max_row == int(np.diff(off, axis=1)[:, 1:s].max())
    assert n_acc == int(csr.accept[:s].sum())
    # the two-step table: for classes (c1, c2), the successors on c2 of the
    # start state's successors on c1, when only the start state reaches them
    succ = {k: set(tg[off[k, 0]:off[k, 1]].tolist()) - {0} for k in range(c)}
    acc = csr.accept.numpy()
    for k in range(c):
        assert bool((so[k] >> 30) & 1) == any(acc[t] for t in succ[k])
    reached = {int(t) for k in range(c) for st in range(1, s)
               for t in tg[off[k, st]:off[k, st + 1]]}
    assert (two_step is None) == bool(reached & set().union(*succ.values()))
    if two_step is not None:
        t_off, t_rows = two_step[0].numpy(), two_step[1].numpy()
        for c1 in range(c):
            for c2 in range(c):
                want = {int(t) for st in succ[c1] for t in tg[off[c2, st]:off[c2, st + 1]]}
                got = set()
                for w, m in t_rows[t_off[c1 * c + c2]:t_off[c1 * c + c2 + 1]].tolist():
                    got |= {32 * w + b for b in range(32) if (m >> b) & 1}
                assert got == want
