"""The port's distributed scans (regex_fpga_tpu_torch.parallel.dist_scan)
against the JAX package's on its virtual CPU mesh of the same shape: the
fast and the k-gram DFA scans (with the adversarial seam cases of
tests/test_dist.py) and the data-parallel NFA scan.

World size 1 runs in this process; 4 and 2 ranks run as gloo processes on
the CPU (``spawn_ranks``), one spawn per rank count with every case of that
count inside it, on the mesh shapes (2, 2), (1, 4), (4, 1), (1, 2) and
(2, 1). Tolerance: none; finals, counts, totals and ``converged`` are
integers and flags and must be equal. Where the fixpoint does not converge,
only the flag is compared (the JAX contract says nothing of the counts)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_dist_ranks as R
from conftest import random_dfa_table, random_nfa
from regex_fpga_tpu.models import build_tokenizer_dfa
from regex_fpga_tpu.ops import build_dfa_tables, build_nfa_tables
from regex_fpga_tpu.ops.kgram import build_kgram, map_kgram_classes
from regex_fpga_tpu.parallel import (dfa_scan_fast_dist, dfa_scan_kgram_dist,
                                     make_mesh, nfa_scan_dist)
from regex_fpga_tpu_torch.parallel.multihost import spawn_ranks


def _arrays(aut):
    return (np.asarray(aut.offsets), np.asarray(aut.trans_char),
            np.asarray(aut.trans_target))


def _counter(s_states):
    """state = (state + byte) mod S: never synchronizes."""
    table = (np.arange(256)[:, None] + np.arange(s_states)[None, :]) % s_states
    accept = np.zeros(s_states, dtype=bool)
    accept[0] = True
    return table.astype(np.int32), accept


def _cycle(s_states, accept_state=1):
    table = np.zeros((256, s_states), dtype=np.int32)
    for s in range(s_states):
        table[:, s] = (s + 1) % s_states
    accept = np.zeros(s_states, dtype=bool)
    accept[accept_state] = True
    return table, accept


# 0 -> {1, 2, 3}, 1 -> 0, 2 -> 1, 3 -> 0, all on "a"
OVERFLOWING = (np.array([0, 3, 4, 5, 6]), np.full(6, ord("a"), np.uint8),
               np.array([1, 2, 3, 0, 1, 0], np.int32))


def _cases(shapes, seed):
    """(name, kwargs) cases for ``torch_dist_ranks.run_cases`` on the given
    (n_data, n_seq) shapes."""
    rng = np.random.default_rng(seed)
    tok = build_tokenizer_dfa()
    text = np.frombuffer(b"The quick brown fox 123 jumps!  over  the lazy dog "
                         b"45.6 " * 2000, np.uint8)
    cases = []
    for nd, ns in shapes:
        table, accept = random_dfa_table(rng, 32, 4)
        cases.append(("fast", dict(
            n_data=nd, n_seq=ns, table=table, accept=accept,
            streams=rng.integers(0, 256, size=(2 * nd, ns * 4 * 64))
            .astype(np.uint8), bps=4)))
        cases.append(("fast", dict(
            n_data=nd, n_seq=ns, table=tok.table, accept=tok.accept,
            streams=np.stack([np.roll(text[:ns * 8 * 128], 7 * i)
                              for i in range(2 * nd)]),
            bps=8, start=int(tok.start))))
        table, accept = _counter(17)
        cases.append(("fast", dict(  # few blocks: converges by propagation
            n_data=nd, n_seq=ns, table=table, accept=accept,
            streams=rng.integers(0, 256, size=(nd, ns * 2 * 128))
            .astype(np.uint8), bps=2, max_iters=4 * ns)))
        cases.append(("fast", dict(  # too many blocks: reports it
            n_data=nd, n_seq=ns, table=table, accept=accept,
            streams=rng.integers(0, 256, size=(nd, ns * 16 * 64))
            .astype(np.uint8), bps=16, max_iters=8)))
        table, accept = random_dfa_table(rng, 24, 4)
        for levels in (1, 2):
            cases.append(("kgram", dict(
                n_data=nd, n_seq=ns, table=table[np.arange(256) % 5],
                accept=accept, levels=levels, bps=4,
                streams=rng.integers(0, 256, size=(2 * nd, ns * 4 * 64 << levels))
                .astype(np.uint8))))
        cases.append(("kgram", dict(
            n_data=nd, n_seq=ns, table=tok.table, accept=tok.accept, levels=2,
            bps=8, start=int(tok.start),
            streams=np.stack([np.roll(text[:ns * 8 * 32 * 4], 5 * i)
                              for i in range(2 * nd)]))))
        table, accept = _cycle(3)
        cases.append(("kgram", dict(  # 26 steps of 2 bytes a block, odd in 3
            n_data=nd, n_seq=ns, table=table, accept=accept, levels=1, bps=2,
            streams=np.zeros((nd, ns * 2 * 26 * 2), np.uint8), max_iters=32)))
        table, accept = _cycle(5)
        cases.append(("kgram", dict(
            n_data=nd, n_seq=ns, table=table, accept=accept, levels=1, bps=16,
            streams=np.zeros((nd, ns * 16 * 13 * 2), np.uint8), max_iters=8)))
        aut = random_nfa(rng, n_states=40, n_edges=300, n_accept=4)
        cases.append(("nfa", dict(
            n_data=nd, n_seq=ns, aut=_arrays(aut), bound=128,
            streams=rng.integers(0, 256, size=(2 * nd, 512)).astype(np.uint8))))
        cases.append(("nfa", dict(  # 2-3 states stay active: bound 1 overflows
            n_data=nd, n_seq=ns, aut=OVERFLOWING, bound=1,
            streams=np.full((2 * nd, 64), ord("a"), np.uint8))))
    return cases


SHAPES1 = [(1, 1)]
SHAPES4 = [(2, 2), (1, 4), (4, 1)]
SHAPES2 = [(1, 2), (2, 1)]
CASES1 = _cases(SHAPES1, 1)
CASES4 = _cases(SHAPES4, 4)
CASES2 = _cases(SHAPES2, 2)


def _jax_mesh(nd, ns):
    return make_mesh(nd, ns, devices=jax.devices()[:nd * ns])


def _jax(name, kw):
    """The JAX package's answer to a case, in the port's result layout."""
    mesh = _jax_mesh(kw["n_data"], kw["n_seq"])
    if name == "nfa":
        aut = R._aut(kw["aut"])
        c, t = nfa_scan_dist(mesh, build_nfa_tables(aut),
                             jnp.asarray(kw["streams"]), kw["bound"])
        return np.asarray(c), np.asarray(t)
    dt = build_dfa_tables(kw["table"], kw["accept"])
    args = dict(blocks_per_shard=kw["bps"], start=kw.get("start", 0),
                max_iters=kw.get("max_iters", 16))
    if name == "fast":
        classes = np.asarray(dt.class_of)[kw["streams"]]
        out = dfa_scan_fast_dist(mesh, dt, jnp.asarray(classes), **args)
    else:
        kg = build_kgram(dt, levels=kw["levels"], max_classes=200_000)
        ck = np.stack([map_kgram_classes(kg, s) for s in kw["streams"]])
        out = dfa_scan_kgram_dist(mesh, jnp.asarray(kg.table),
                                  jnp.asarray(kg.acc_table), jnp.asarray(ck),
                                  acc_bound=kg.k, **args)
    finals, counts, conv = out
    return np.asarray(finals), np.asarray(counts), bool(conv)


def _assert_dfa(got, want):
    finals, counts, conv = got
    assert conv == want[2]
    if conv:
        np.testing.assert_array_equal(finals, want[0])
        np.testing.assert_array_equal(counts, want[1])


def _check(name, kw, got):
    want = _jax(name, kw)
    if name == "fast":
        _assert_dfa(got, want)
    elif name == "kgram":
        for path in got:  # class ids, then raw bytes with the maps
            _assert_dfa(path, want)
    elif kw["bound"] == 128:
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    else:  # JAX drops the overflow flag; the port raises on it
        assert tuple(got[:2]) == ("raised", "RuntimeError")


def _check_ranks(results, i, cases):
    name, kw = cases[i]
    per_rank = [r[i] for r in results]
    for other in per_rank[1:]:  # every rank returns the global result
        _assert_same(other, per_rank[0])
    _check(name, kw, per_rank[0])


def _assert_same(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("i", range(len(CASES1)),
                         ids=[f"{n}-{j}" for j, (n, _) in enumerate(CASES1)])
def test_world_size_one_matches_jax(i):
    name, kw = CASES1[i]
    _check(name, kw, R.run_cases([CASES1[i]])[0])


@pytest.fixture(scope="module")
def four_ranks():
    return spawn_ranks(R.run_cases, 4, device="cpu", args=(CASES4,))


@pytest.fixture(scope="module")
def two_ranks():
    return spawn_ranks(R.run_cases, 2, device="cpu", args=(CASES2,))


@pytest.mark.parametrize("i", range(len(CASES4)),
                         ids=[f"{n}-{c['n_data']}x{c['n_seq']}-{j}"
                              for j, (n, c) in enumerate(CASES4)])
def test_four_gloo_ranks_match_jax(four_ranks, i):
    _check_ranks(four_ranks, i, CASES4)


@pytest.mark.parametrize("i", range(len(CASES2)),
                         ids=[f"{n}-{c['n_data']}x{c['n_seq']}-{j}"
                              for j, (n, c) in enumerate(CASES2)])
def test_two_gloo_ranks_match_jax(two_ranks, i):
    _check_ranks(two_ranks, i, CASES2)


def test_world_size_one_without_a_process_group():
    """No process group: the world is one rank and every collective is the
    identity; a mesh that asks for more raises as JAX's does."""
    from regex_fpga_tpu_torch.parallel import make_mesh as tmesh
    from regex_fpga_tpu_torch.parallel import make_tp_mesh as ttp
    from regex_fpga_tpu_torch.parallel.mesh import (all_gather, all_reduce,
                                                    collective_route,
                                                    ring_shift)

    assert not torch.distributed.is_initialized()
    mesh = tmesh()
    assert mesh.shape == {"data": 1, "seq": 1} and mesh.backend is None
    x = torch.arange(6, dtype=torch.int32)
    assert ring_shift(mesh, "seq", x) is x
    assert torch.equal(all_reduce(mesh, "data", x.clone()), x)
    assert torch.equal(all_gather(mesh, "seq", x), x[None])
    assert "identity" in collective_route(mesh, "cpu")
    assert ttp().shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="does not cover"):
        tmesh(2, 1)


def test_multihost_single_process_topology():
    """init_distributed is a no-op for one process; global_mesh spans the
    one rank and runs a distributed scan equal to a serial walk."""
    from regex_fpga_tpu_torch import native
    from regex_fpga_tpu_torch.models import build_tokenizer_dfa as ttok
    from regex_fpga_tpu_torch.ops.tables import build_dfa_tables as tbuild
    from regex_fpga_tpu_torch.parallel import dfa_scan_fast_dist as tfast
    from regex_fpga_tpu_torch.parallel.multihost import (global_mesh,
                                                         init_distributed)

    topo = init_distributed(device="cpu")
    assert topo.host_count == 1 and topo.host_index == 0
    assert topo.global_devices == 1
    assert topo.local_devices == torch.cuda.device_count()
    assert not torch.distributed.is_initialized()
    tok = ttok()
    dt = tbuild(tok.table, tok.accept)
    rng = np.random.default_rng(3)
    streams = rng.integers(0, 256, size=(2, 8 * 128)).astype(np.uint8)
    classes = dt.class_of[torch.as_tensor(streams).long()]
    finals, counts, conv = tfast(global_mesh(), dt, classes,
                                 blocks_per_shard=8, start=tok.start)
    assert conv
    for i in range(2):
        c, _, f = native.dfa_scan(dt.table.numpy(), dt.class_of.numpy(),
                                  dt.accept.numpy(), streams[i],
                                  start=tok.start, want_mask=False)
        assert int(finals[i]) == f and int(counts[i]) == int(c.sum())
