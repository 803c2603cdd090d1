"""The port's collective-traffic model (regex_fpga_tpu_torch.parallel.
comm_model) against the JAX package's, and the collectives that the port's
scans really issue against the model.

The byte formulas must equal JAX's on a grid of arguments, with JAX's TPU
constants passed in explicitly (the port has none). The scans' collectives
are read from the counting helpers of ``parallel.mesh`` (the port's
counterpart of tests/test_comm_model.py's walk over a jaxpr): at world size
1 in this process and on 4 gloo ranks in one spawn, which also runs
``graft_entry.dryrun_multichip(4)``'s checks. Tolerance: none."""

import itertools

import numpy as np
import pytest

import regex_fpga_tpu.parallel.comm_model as jc
import regex_fpga_tpu_torch.parallel.comm_model as tc
import torch_dist_ranks as R
from regex_fpga_tpu.ops import build_dfa_tables
from regex_fpga_tpu.ops.kgram import build_kgram
from regex_fpga_tpu_torch.parallel.multihost import spawn_ranks

LINK = dict(link_bps=jc.V5E_ICI_LINK_BPS, latency_s=jc.COLLECTIVE_LATENCY_S)

GRID = list(itertools.product([1, 9], [1 << 20], [1, 2], [1, 4, 8], [0, 64],
                              [1, 2]))


@pytest.mark.parametrize("batch,shard,n_data,n_seq,overlap,iters", GRID)
def test_bytes_and_projection_match_jax(batch, shard, n_data, n_seq, overlap,
                                        iters):
    got = tc.fast_dist_comm_bytes(batch, shard, n_data, n_seq, overlap, iters)
    want = jc.fast_dist_comm_bytes(batch, shard, n_data, n_seq, overlap, iters)
    assert got == want
    for rate in (2.36e9, 6.16e9):
        assert tc.project_efficiency(got, rate, **LINK) == \
            jc.project_efficiency(want, rate)


@pytest.mark.parametrize("target", [0.5, 0.85, 0.99])
@pytest.mark.parametrize("n_data,n_seq", [(1, 1), (2, 4), (4, 16)])
def test_min_shard_matches_jax(target, n_data, n_seq):
    for rate in (2.36e9, 6.16e9):
        assert tc.min_shard_bytes_for_efficiency(
            target, 8, n_data, n_seq, rate, **LINK) == \
            jc.min_shard_bytes_for_efficiency(target, 8, n_data, n_seq, rate)


def test_report_matches_jax_with_its_constants():
    got = tc.comm_model_report(2.36e9, 6.16e9, **LINK)
    want = jc.comm_model_report(2.36e9, 6.16e9)
    assert got["configs"] == want["configs"]
    for key in ("min_shard_bytes_eff_85", "min_shard_bytes_eff_99"):
        assert got[key] == want[key]
    assert got["assumptions"]["link_bps"] == jc.V5E_ICI_LINK_BPS


def test_no_tpu_constants():
    """The link rate, latency and compute rates are the caller's."""
    assert not hasattr(tc, "V5E_ICI_LINK_BPS")
    assert not hasattr(tc, "COLLECTIVE_LATENCY_S")
    comm = tc.fast_dist_comm_bytes(8, 1 << 20, 2, 4)
    with pytest.raises(TypeError):
        tc.project_efficiency(comm, 1e9)
    with pytest.raises(TypeError):
        tc.comm_model_report()


def _audit_case(n_data, n_seq, seed):
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 9, size=(256, 9), dtype=np.int32)
    accept = rng.random(9) < 0.3
    table7 = rng.integers(0, 7, size=(256, 7), dtype=np.int32)[np.arange(256) % 5]
    kg = build_kgram(build_dfa_tables(table7, rng.random(7) < 0.3), levels=1)
    batch, nbps, ov = 4 * n_data, 4, 8
    return ("audit", dict(
        n_data=n_data, n_seq=n_seq, table=table, accept=accept,
        classes=np.zeros((batch, n_seq * nbps * 16), np.int32),
        classes_k=np.zeros((batch, n_seq * nbps * 8), np.int32),
        kg_table=np.asarray(kg.table), kg_acc=np.asarray(kg.acc_table),
        bps=nbps, overlap=ov))


def _check_inventory(records, converged, kw):
    """The scan's collectives are exactly those of the model's table, in
    order, with its payloads; the all_gathers over data return the
    (B,) results that JAX's sharded outputs leave implicit."""
    n_seq, b_loc = kw["n_seq"], kw["classes"].shape[0] // kw["n_data"]
    assert converged
    out = [r for r in records if r[:2] == ("all_gather", "data")]
    assert [r[2] for r in out] == [b_loc * 4, b_loc * 4]
    body = [r for r in records if r[:2] != ("all_gather", "data")]
    iters = sum(r[0] == "ring_shift" for r in body) - 1
    assert iters >= 1
    want = ([("ring_shift", "seq", b_loc * kw["overlap"] * 4)]
            + [("ring_shift", "seq", b_loc * 4), ("all_reduce", "data", 4),
               ("all_reduce", "seq", 4)] * iters
            + [("all_reduce", "seq", b_loc * 4), ("all_gather", "seq", b_loc * 4)])
    assert [r[:3] for r in body] == want
    gather = body[-1]
    assert gather[3] == n_seq * b_loc * 4
    # the model's table, re-derived from the payloads the scan issued
    model = tc.fast_dist_comm_bytes(kw["classes"].shape[0], 1 << 20,
                                    kw["n_data"], n_seq, overlap=kw["overlap"],
                                    iters=iters)["per_device_bytes"]
    assert model["seam_tail_ppermute"] == body[0][2]
    assert model["finals_ppermute_x_iters"] == iters * body[1][2]
    assert model["convergence_psum_x_iters"] == iters * (body[2][2] + body[3][2])
    assert model["counts_psum"] == round(2 * (n_seq - 1) / n_seq * body[-2][2], 1)
    assert model["finals_all_gather"] == gather[3] - gather[2]


@pytest.mark.parametrize("scan", ["fast", "kgram"])
def test_world_size_one_collectives_match_model(scan):
    kw = _audit_case(1, 1, 0)[1]
    records, conv = R.audit(**kw)[scan == "kgram"]
    _check_inventory(records, conv, kw)


CASES4 = [_audit_case(2, 2, 1), _audit_case(1, 4, 2)]


@pytest.fixture(scope="module")
def four_ranks():
    return spawn_ranks(R.run_cases, 4, device="cpu", args=(CASES4,))


@pytest.mark.parametrize("scan", ["fast", "kgram"])
@pytest.mark.parametrize("i", range(len(CASES4)))
def test_four_gloo_ranks_collectives_match_model(four_ranks, i, scan):
    kw = CASES4[i][1]
    for r in four_ranks:
        records, conv = r[i][scan == "kgram"]
        _check_inventory(records, conv, kw)


def test_dryrun_multichip_on_four_gloo_ranks(capsys):
    from regex_fpga_tpu_torch.graft_entry import dryrun_multichip

    dryrun_multichip(4, device="cpu")
    out = capsys.readouterr().out
    assert "dryrun_multichip ok: mesh=2x2 (gloo on cpu)" in out
    assert "tp NFA [S=600" in out and "oracle-exact" in out


def test_entry_runs_one_fast_scan():
    import torch

    from regex_fpga_tpu_torch.graft_entry import entry
    from regex_fpga_tpu_torch.ops import hopper_dfa

    fn, args = entry("cpu")
    state = fn(*args)
    assert state.dtype == torch.int32 and 0 <= int(state) < args[0].num_states
    assert hopper_dfa.LAUNCHES["dfa_chain"] == 0  # the CPU takes the plain pass
