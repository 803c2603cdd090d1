"""Torch port k-gram engine (regex_fpga_tpu_torch.ops.kgram and the plain
version of its kernel K3 in ops.hopper_kgram) against the JAX engine and the
Pallas k-gram kernel in interpret mode, on the same seeded numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regex_fpga_tpu.models import build_tokenizer_dfa
from regex_fpga_tpu.ops import build_dfa_tables as jax_build_dfa_tables
from regex_fpga_tpu.ops import kgram as jk
from regex_fpga_tpu.ops.pallas_kgram import (
    KGRAM_LANE_TILE,
    kgram_chain_pallas,
    pack_ta128,
)
from regex_fpga_tpu_torch.ops import hopper_kgram
from regex_fpga_tpu_torch.ops import kgram as tk
from regex_fpga_tpu_torch.ops.tables import tables_from_numpy

from conftest import random_dfa_table


def both_tables(table, accept):
    j = jax_build_dfa_tables(table, accept)
    return j, tables_from_numpy(np.asarray(j.table), np.asarray(j.class_of),
                                np.asarray(j.accept), j.num_states)


def packed(table, acc_table):
    return hopper_kgram.pack_ta(torch.as_tensor(table), torch.as_tensor(acc_table))


def tokenizer_tables():
    tok = build_tokenizer_dfa()
    return (*both_tables(tok.table, tok.accept), tok.start)


TEXT = np.frombuffer(
    (b"Hello world, it's 2026! k-gram test 12.5% ... " * 200)[:8192], np.uint8
)


def assert_kgram_tables_equal(port, ref):
    np.testing.assert_array_equal(port.table, ref.table)
    np.testing.assert_array_equal(port.acc_table, ref.acc_table)
    np.testing.assert_array_equal(port.class_of, np.asarray(ref.class_of))
    assert len(port.pair_maps) == len(ref.pair_maps)
    for a, b in zip(port.pair_maps, ref.pair_maps):
        np.testing.assert_array_equal(a, b)
    assert port.level_classes == ref.level_classes
    assert (port.num_states, port.k) == (ref.num_states, ref.k)


@pytest.mark.parametrize("levels", [1, 2, 3])
def test_build_and_map_match_jax_tokenizer(levels):
    jt, pt, _ = tokenizer_tables()
    kj = jk.build_kgram(jt, levels=levels)
    kt = tk.build_kgram(pt, levels=levels)
    assert_kgram_tables_equal(kt, kj)
    want = jk.map_kgram_classes(kj, TEXT)
    np.testing.assert_array_equal(tk.map_kgram_classes(kt, TEXT).numpy(), want)
    got = tk.map_kgram_classes(kt, torch.tensor(TEXT))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_build_matches_jax_random_and_blowup():
    rng = np.random.default_rng(0)
    jt, pt = both_tables(*random_dfa_table(rng, 12, 3))
    kj = jk.build_kgram(jt, levels=1, max_classes=200_000)
    kt = tk.build_kgram(pt, levels=1, max_classes=200_000)
    assert_kgram_tables_equal(kt, kj)
    stream = rng.integers(0, 256, size=2048).astype(np.uint8)
    np.testing.assert_array_equal(tk.map_kgram_classes(kt, stream).numpy(),
                                  jk.map_kgram_classes(kj, stream))
    jt, pt = both_tables(*random_dfa_table(rng, 64, 4))
    assert jk.build_kgram(jt, levels=2, max_classes=512) is None
    assert tk.build_kgram(pt, levels=2, max_classes=512) is None
    assert tk.KGRAM_MAX_STATES == jk.KGRAM_MAX_STATES


def assert_scan_equal(got, want):
    assert int(got.total) == int(want.total)
    assert int(got.final_state) == int(want.final_state)
    assert got.converged == bool(want.converged)
    assert got.iterations == int(want.iterations)


@pytest.mark.parametrize("levels,nb,overlap", [(1, 32, 16), (2, 32, 16),
                                               (2, 8, 0), (3, 1, 16)])
def test_scan_kgram_matches_jax_tokenizer(levels, nb, overlap):
    jt, pt, start = tokenizer_tables()
    kj = jk.build_kgram(jt, levels=levels)
    kt = tk.build_kgram(pt, levels=levels)
    ck = jk.map_kgram_classes(kj, TEXT)
    want = jk.dfa_scan_kgram(jnp.asarray(kj.table), jnp.asarray(kj.acc_table),
                             jnp.asarray(ck), num_blocks=nb, start=start,
                             overlap=overlap)
    got = tk.dfa_scan_kgram(packed(kt.table, kt.acc_table),
                            torch.as_tensor(ck), num_blocks=nb, start=start,
                            overlap=overlap)
    assert_scan_equal(got, want)


@pytest.mark.parametrize("max_iters", [2, 16])
def test_scan_kgram_mod3_iterations_match_jax(max_iters):
    """A mod-3 counter never synchronizes: speculation fails and the loop
    counts its full passes from 0, the first inside the loop."""
    ptable = np.zeros((256, 3), dtype=np.int32)
    for s in range(3):
        ptable[:, s] = (s + 1) % 3
    jt, pt = both_tables(ptable, np.array([False, True, False]))
    kj = jk.build_kgram(jt, levels=1)
    kt = tk.build_kgram(pt, levels=1)
    ck = jk.map_kgram_classes(kj, np.zeros(4 * 26, np.uint8))
    want = jk.dfa_scan_kgram(jnp.asarray(kj.table), jnp.asarray(kj.acc_table),
                             jnp.asarray(ck), num_blocks=4, max_iters=max_iters)
    got = tk.dfa_scan_kgram(packed(kt.table, kt.acc_table), torch.as_tensor(ck),
                            num_blocks=4, max_iters=max_iters)
    assert got.iterations > 1
    assert_scan_equal(got, want)


@pytest.mark.parametrize("seed,s,block_major,dtype", [
    (0, 23, False, torch.int32), (1, 40, True, torch.int16),
    (2, 5, True, torch.uint8),
])
def test_kgram_pass_full_matches_jax(seed, s, block_major, dtype):
    rng = np.random.default_rng(seed)
    c = 37
    table = rng.integers(0, s, size=(c, s)).astype(np.int32)
    acc = rng.integers(0, 5, size=(c, s)).astype(np.int32)
    b, nb = 24, 40
    cls = rng.integers(0, c, size=(b, nb)).astype(np.int32)
    ent = rng.integers(0, s, size=nb).astype(np.int32)
    fj, tj = jk.kgram_pass_full(jnp.asarray(table), jnp.asarray(acc),
                                jnp.asarray(cls), jnp.asarray(ent))
    cls_t = (torch.as_tensor(np.ascontiguousarray(cls.T)).to(dtype).T
             if block_major else torch.as_tensor(cls).to(dtype))
    ft, tt = tk.kgram_pass_full(packed(table, acc), cls_t, torch.as_tensor(ent))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))


def test_kgram_chain_matches_pallas_interpret():
    """The plain K3 against the Pallas kernel it replaces, run as
    tests/test_kgram.py runs it (interpret mode): directly, and through
    dfa_scan_kgram(use_pallas=True)."""
    rng = np.random.default_rng(0)
    jt, pt, start = tokenizer_tables()
    kj = jk.build_kgram(jt, levels=1)
    kt = tk.build_kgram(pt, levels=1)
    stream = rng.integers(0, 256, size=KGRAM_LANE_TILE * 128 * 2).astype(np.uint8)
    ck = jk.map_kgram_classes(kj, stream)
    nb = KGRAM_LANE_TILE
    blocks = ck.reshape(nb, -1)
    ent = rng.integers(0, kj.num_states, size=nb).astype(np.int32)
    fj, tj = kgram_chain_pallas(pack_ta128(kj.table, kj.acc_table),
                                jnp.asarray(blocks), jnp.asarray(ent))
    ft, tt = hopper_kgram.kgram_chain(
        packed(kt.table, kt.acc_table), torch.as_tensor(blocks).T,
        torch.as_tensor(ent),
    )
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))

    want = jk.dfa_scan_kgram(jnp.asarray(kj.table), jnp.asarray(kj.acc_table),
                             jnp.asarray(ck), num_blocks=nb, start=start,
                             use_pallas=True)
    got = tk.dfa_scan_kgram(packed(kt.table, kt.acc_table), torch.as_tensor(ck),
                            num_blocks=nb, start=start)
    assert_scan_equal(got, want)


def test_kgram_wrapper_checks_and_device_rule():
    table = torch.zeros((3, 4), dtype=torch.int32)
    ta = hopper_kgram.pack_ta(table, table)
    cls = torch.zeros((5, 6), dtype=torch.int32)
    ent = torch.zeros(6, dtype=torch.int32)
    with pytest.raises(TypeError):
        hopper_kgram.pack_ta(table, table[:2])
    with pytest.raises(TypeError):
        hopper_kgram.kgram_chain(table, cls, ent)
    with pytest.raises(TypeError):
        hopper_kgram.kgram_chain(ta, cls.float(), ent)
    with pytest.raises(ValueError, match="no kernel"):
        hopper_kgram.kgram_chain(ta.to("meta"), cls.to("meta"), ent.to("meta"))
    with pytest.raises(ValueError):
        tk.map_kgram_classes(tk.build_kgram(tokenizer_tables()[1], levels=2),
                             TEXT[:6])
