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


def reset_counter_tables():
    """Three states counting bytes mod 3, ``b`` resetting to 0, state 1
    accepting. A block with no ``b`` hands its entry's error on to the
    next, so the guesses fail and each Jacobi pass carries the right
    entries one block further."""
    table = np.empty((256, 3), dtype=np.int32)
    for s in range(3):
        table[:, s] = (s + 1) % 3
    table[ord("b"), :] = 0
    return table, np.array([False, True, False])


def reset_counter_text(seed, nb, block, resets):
    """``nb`` blocks of ``block`` bytes of ``a``, one ``b`` at a seeded
    place in each block of ``resets``."""
    rng = np.random.default_rng(seed)
    text = np.full(nb * block, ord("a"), dtype=np.uint8)
    for blk in resets:
        text[blk * block + int(rng.integers(0, block))] = ord("b")
    return text


@pytest.mark.parametrize("raw", [False, True])
@pytest.mark.parametrize("levels,overlap,seed", [(1, 0, 0), (1, 1, 1),
                                                 (2, 0, 2), (2, 1, 3)])
def test_scan_kgram_failed_guesses_match_jax(levels, overlap, seed, raw):
    """Guesses that the first pass does not verify: the passes that follow,
    and the one read a pass, give the JAX package's final state, total,
    ``converged`` and ``iterations``, over class ids and over raw text."""
    jt, pt = both_tables(*reset_counter_tables())
    kj = jk.build_kgram(jt, levels=levels)
    kt = tk.build_kgram(pt, levels=levels)
    text = reset_counter_text(seed, 16, 64, resets=(0, 3, 4, 10))
    ck = jk.map_kgram_classes(kj, text)
    want = jk.dfa_scan_kgram(jnp.asarray(kj.table), jnp.asarray(kj.acc_table),
                             jnp.asarray(ck), num_blocks=16, overlap=overlap)
    got = tk.dfa_scan_kgram(packed(kt.table, kt.acc_table),
                            torch.as_tensor(text if raw else ck),
                            num_blocks=16, overlap=overlap,
                            maps=tk.kgram_maps(kt) if raw else None)
    assert got.converged and got.iterations >= 2
    assert_scan_equal(got, want)


@pytest.mark.parametrize("raw", [False, True])
def test_scan_kgram_runs_out_of_passes_like_jax(raw):
    """A run of eleven blocks with no reset needs more passes than
    ``max_iters`` allows: unconverged, with the last pass's total and final
    state, as in the JAX package."""
    jt, pt = both_tables(*reset_counter_tables())
    kj = jk.build_kgram(jt, levels=2)
    kt = tk.build_kgram(pt, levels=2)
    text = reset_counter_text(5, 16, 64, resets=(0, 12))
    ck = jk.map_kgram_classes(kj, text)
    want = jk.dfa_scan_kgram(jnp.asarray(kj.table), jnp.asarray(kj.acc_table),
                             jnp.asarray(ck), num_blocks=16, max_iters=3,
                             overlap=1)
    got = tk.dfa_scan_kgram(packed(kt.table, kt.acc_table),
                            torch.as_tensor(text if raw else ck), num_blocks=16,
                            max_iters=3, overlap=1,
                            maps=tk.kgram_maps(kt) if raw else None)
    assert not got.converged and got.iterations == 3
    assert_scan_equal(got, want)


@pytest.mark.parametrize("which", ["reset counter", "mod 3"])
def test_count_chunk_loop_equals_scan(which, monkeypatch):
    """count() over many chunks, each a k-gram scan with its one read, and
    the carry state handed on from chunk to chunk: equal to scan().total
    and to a serial walk, where chunks take several passes (the reset
    counter) and where they run out of passes (a mod-3 counter never
    synchronizes: the exact fallback)."""
    from regex_fpga_tpu_torch import api as tapi
    from regex_fpga_tpu_torch.models import CompiledDfa
    from regex_fpga_tpu_torch.utils.config import EngineConfig

    table, accept = reset_counter_tables()
    if which == "mod 3":
        table[ord("b"), :] = table[ord("a"), :]
    cfg = EngineConfig(scan_backend="device", num_blocks=16, min_block_bytes=4,
                       chunk_bytes=1024, max_iters=8)
    m = tapi.DfaMatcher(CompiledDfa(table=table, accept=accept, start=0, dead=-1),
                        cfg, device="cpu")
    assert m._kgram() is not None
    passes = []
    real = tapi.dfa_scan_kgram

    def spy(*args, **kw):
        res = real(*args, **kw)
        passes.append((res.iterations, res.converged))
        return res
    monkeypatch.setattr(tapi, "dfa_scan_kgram", spy)
    text = bytes(reset_counter_text(7, 57, 64, resets=range(0, 57, 3))[:3641])
    got = m.count(text)
    assert got == m.scan(text).total == jk_total(m, text)
    if which == "mod 3":
        # every chunk diverges and falls back in place, its own K3 part
        assert passes == [(cfg.max_iters, False)] * 4
    else:
        assert len(passes) == 4 and all(conv for _, conv in passes)
        assert max(it for it, _ in passes) >= 2


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


def few_class_tables(seed):
    """A random DFA whose 256 byte columns are copies of 3, so that three
    levels of pairing stay small."""
    rng = np.random.default_rng(seed)
    table, accept = random_dfa_table(rng, 6, 2)
    return both_tables(table[rng.integers(0, 3, size=256)], accept)


def kgram_case(which, levels):
    """(JAX k-gram tables, port k-gram tables, text) for one automaton."""
    if which == "tokenizer":
        jt, pt, _ = tokenizer_tables()
        text = TEXT
    else:
        jt, pt = few_class_tables(levels)
        text = np.random.default_rng(levels).integers(
            0, 256, size=8192).astype(np.uint8)
    kj = jk.build_kgram(jt, levels=levels, max_classes=10_000)
    kt = tk.build_kgram(pt, levels=levels, max_classes=10_000)
    assert_kgram_tables_equal(kt, kj)
    return kj, kt, text


@pytest.mark.parametrize("which", ["tokenizer", "random"])
@pytest.mark.parametrize("levels", [1, 2, 3])
@pytest.mark.parametrize("block_major", [True, False])
def test_kgram_chain_bytes_matches_jax(which, levels, block_major):
    """Raw text through kgram_chain_bytes (its plain version, on the CPU)
    against the JAX package's map_kgram_classes + kgram_pass_full, in both
    storage orders. Tolerance 0."""
    kj, kt, text = kgram_case(which, levels)
    k = kt.k
    nb = 16
    b = len(text) // k // nb
    ids = jk.map_kgram_classes(kj, text).reshape(nb, b)
    ent = np.random.default_rng(0).integers(0, kj.num_states, size=nb).astype(np.int32)
    fj, tj = jk.kgram_pass_full(jnp.asarray(kj.table), jnp.asarray(kj.acc_table),
                                jnp.asarray(ids.T), jnp.asarray(ent))
    blocks = torch.as_tensor(text).reshape(nb, b, k)
    text3 = (blocks.transpose(0, 1) if block_major
             else blocks.transpose(0, 1).contiguous())
    ta, maps = packed(kt.table, kt.acc_table), tk.kgram_maps(kt)
    assert maps.k == k and hopper_kgram.kgram_bytes_supported(ta, maps)
    for fn in (hopper_kgram.kgram_chain_bytes, hopper_kgram.kgram_chain_bytes_plain,
               lambda *a: tk.kgram_pass_full(a[0], a[2], a[3], maps=a[1])):
        ft, tt = fn(ta, maps, text3, torch.as_tensor(ent))
        np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    np.testing.assert_array_equal(
        hopper_kgram.map_classes(maps, torch.as_tensor(text)).numpy(), ids.reshape(-1))


@pytest.mark.parametrize("levels,nb,overlap", [(1, 32, 16), (2, 32, 16),
                                               (2, 8, 0), (3, 1, 16), (3, 16, 4)])
def test_scan_kgram_raw_text_matches_jax(levels, nb, overlap):
    """dfa_scan_kgram fed the raw text and the packed maps against the JAX
    scan over mapped class ids."""
    jt, pt, start = tokenizer_tables()
    kj = jk.build_kgram(jt, levels=levels)
    kt = tk.build_kgram(pt, levels=levels)
    want = jk.dfa_scan_kgram(jnp.asarray(kj.table), jnp.asarray(kj.acc_table),
                             jnp.asarray(jk.map_kgram_classes(kj, TEXT)),
                             num_blocks=nb, start=start, overlap=overlap)
    got = tk.dfa_scan_kgram(packed(kt.table, kt.acc_table), torch.as_tensor(TEXT),
                            num_blocks=nb, start=start, overlap=overlap,
                            maps=tk.kgram_maps(kt))
    assert_scan_equal(got, want)


@pytest.mark.parametrize("s,top,dtype", [
    (23, 4, np.uint16),        # the tokenizer's size
    (4095, 4, np.uint16),      # 3 count bits leave 13 for the column offset
    (4096, 4, np.uint32),
    (8191, 4, np.uint32), (8192, 4, np.uint32), (8193, 4, np.uint32),
    (4095, 8, np.uint32),      # a fourth count bit
    (8191, 3, np.uint16),      # two count bits
    (20, 255, np.uint16), (200, 255, np.uint32),
])
def test_pack_ta_narrow_form_unpacks_exactly(s, top, dtype):
    """The narrow table decodes to exactly (T_k, A_k), with the largest
    count present, T_k entries outside [0, S) as column S, and a zero row
    and column around it."""
    rng = np.random.default_rng(s)
    c = 3
    table = rng.integers(0, s, size=(c, s)).astype(np.int32)
    acc = rng.integers(0, top + 1, size=(c, s)).astype(np.int32)
    acc[0, 0], table[0, 0], table[1, 0] = top, s - 1, 0
    table[2, :4] = [-1, s, s + 5, 2**31 - 1]
    ta = packed(table, acc)
    assert ta.entry_bytes == np.dtype(dtype).itemsize
    assert ta.narrow.numel() * ta.entry_bytes % 16 == 0
    cols, counts = ta.unpack_narrow()
    valid = (table >= 0) & (table < s)
    np.testing.assert_array_equal(cols[:c, :s], np.where(valid, table, s))
    np.testing.assert_array_equal(counts[:c, :s], acc)
    assert not cols[c].any() and not cols[:, s].any()
    assert not counts[c].any() and not counts[:, s].any()
    np.testing.assert_array_equal(ta.wide[..., 0].numpy(), table)
    np.testing.assert_array_equal(ta.wide[..., 1].numpy(), acc)


@pytest.mark.parametrize("s,eb,want", [
    (23, 2, 26), (23, 4, 25), (1024, 2, 1026), (836, 2, 838), (4095, 2, 4098),
    (1, 2, 2), (1, 4, 3), (30, 4, 31), (31, 4, 33),
])
def test_narrow_rows_are_an_odd_number_of_words(s, eb, want):
    """A row of the narrow table holds S + 1 entries and is padded to an odd
    number of 32-bit words, so that the rows of one column fall into
    different shared-memory banks; pack_ta lays the table out so."""
    assert hopper_kgram.row_entries(s, eb) == want
    words = want * eb // 4
    assert want >= s + 1 and want * eb % 4 == 0 and words % 2 == 1
    if eb == 2:
        table = torch.zeros((3, s), dtype=torch.int32)
        ta = hopper_kgram.pack_ta(table, table)
        assert ta.entry_bytes == 2 and ta.narrow.numel() >= 4 * want


@pytest.mark.parametrize("s,counts", [
    (23, [0, -1]),             # a negative count
    (100, [0, 256]),           # a count above the uint32 form's 8 bits
    (1 << 22, [0, 1]),         # too many states for 22 column bits
])
def test_pack_ta_refuses_what_no_narrow_form_holds(s, counts):
    table = torch.zeros((1, s), dtype=torch.int32)
    acc = torch.zeros((1, s), dtype=torch.int32)
    acc[0, :2] = torch.tensor(counts, dtype=torch.int32)
    ta = hopper_kgram.pack_ta(table, acc)
    assert ta.narrow is None and ta.entry_bytes == 0
    cls = torch.zeros((3, 2), dtype=torch.int32)
    ent = torch.tensor([0, 1], dtype=torch.int32)
    finals, totals = hopper_kgram.kgram_chain(ta, cls, ent)  # the wide table
    assert finals.tolist() == [0, 0]
    assert totals.tolist() == [counts[0] * 3, counts[1] + counts[0] * 2]


def test_pack_maps_validates():
    jt, pt, _ = tokenizer_tables()
    kt = tk.build_kgram(pt, levels=2)
    maps = tk.kgram_maps(kt)
    assert (maps.k, maps.level_classes) == (4, (10, 49, 221))
    assert maps.size == 256 + 100 + 2401 and maps.packed.numel() % 8 == 0
    bad = [m.copy() for m in kt.pair_maps]
    bad[1][7] = 221  # not a class of the last level
    with pytest.raises(ValueError, match="not classes"):
        hopper_kgram.pack_maps(kt.class_of, bad, kt.level_classes)
    with pytest.raises(ValueError, match="entries"):
        hopper_kgram.pack_maps(kt.class_of, [kt.pair_maps[0][:-1], kt.pair_maps[1]],
                               kt.level_classes)
    with pytest.raises(ValueError, match="levels"):
        hopper_kgram.pack_maps(kt.class_of, [], kt.level_classes[:1])
    assert tk.kgram_maps(tk.build_kgram(pt, levels=1)).k == 2
    ta = packed(kt.table, kt.acc_table)
    ent = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        hopper_kgram.kgram_chain_bytes(ta, maps, torch.zeros((3, 2, 2), dtype=torch.uint8), ent)
    with pytest.raises(ValueError, match="one automaton"):
        hopper_kgram.kgram_chain_bytes(ta, tk.kgram_maps(tk.build_kgram(pt, levels=1)),
                                       torch.zeros((3, 2, 2), dtype=torch.uint8), ent)
    with pytest.raises(ValueError, match="multiple"):
        tk.dfa_scan_kgram(ta, torch.zeros(6, dtype=torch.uint8), num_blocks=1, maps=maps)


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


def test_level_gates_follow_the_card_constants():
    """The gates price a level by the card's gate sweep (KGRAM_SWEEP), not
    by MXU tiles: at each swept automaton a level costs its measured time a
    byte; between swept tables the price lies between theirs; a level the
    sweep did not reach costs infinity. Above KGRAM_MAX_STATES the k=1 pass
    is the choice whatever the classes."""
    per_byte = 1e-3 / (64 << 20)
    for lv, rows in tk.KGRAM_SWEEP.items():
        for s, c, _, ms in rows:
            assert tk.kgram_step_cost(s, c, lv) == pytest.approx(ms * per_byte)
    lo, hi = (tk.kgram_step_cost(s, c, 1)
              for s, c, _, _ in (tk.KGRAM_SWEEP[1][3], tk.KGRAM_SWEEP[1][4]))
    assert lo < tk.kgram_step_cost(400, 150, 1) < hi
    assert tk.kgram_step_cost(23, 10, 4) == float("inf")
    assert tk.choose_kgram_level(23, [10, 49, 221, 629, 900]) == 2
    # the sweep's automata: the tokenizer and the Aho-Corasick ones
    levels = {23: [10, 49, 221, 629], 32: [17, 43, 115, 475],
              67: [28, 80, 199, 726], 107: [31, 94, 217, 782]}
    assert {s: tk.choose_scan_level(s, c) for s, c in levels.items()} == \
        {23: 2, 32: 2, 67: 0, 107: 0}
    assert tk.choose_scan_level(tk.KGRAM_MAX_STATES + 1, levels[23]) == 0
    assert tk.choose_scan_level(23, None) == 0
    assert tk.choose_scan_level(23, []) == 0


@pytest.mark.parametrize("s,classes,level", [
    (23, [10, 49, 221], 2),      # the tokenizer: k = 4 over raw text
    (107, [31, 94, 217], 1),     # the raw-text levels, k = 2 the cheaper
    (836, [36, 175, 753], 1),    # 300 keywords: both levels mapped to class ids
    (4008, [36, 217], 1),        # 1,500 keywords: level 2 out of reach
])
def test_choose_kgram_level_depends_on_s_and_classes(s, classes, level):
    """The level within the k-gram engine follows the sweep: at S = 836 the
    card, like the JAX package's TPU model (tests/test_kgram.py), picks
    level 1, since both levels read class ids mapped from the bytes and
    level 2's map costs more; the tokenizer takes level 2."""
    assert tk.choose_kgram_level(s, classes) == level
    assert tk.choose_scan_level(s, classes) == (level if s <= 32 else 0)


def test_gate_constant_is_the_sweeps_crossover():
    """KGRAM_MAX_STATES is the largest swept S up to which K3 at k = 4
    (level 2) beat K2 (level 0), and the model's own choice agrees with the
    gate at every swept automaton."""
    k2 = {s: ms for s, _, _, ms in tk.KGRAM_SWEEP[0]}
    k3 = {s: ms for s, _, _, ms in tk.KGRAM_SWEEP[2]}
    swept = sorted(s for s in k3 if s <= 107)
    wins = [s for s in swept if k3[s] < k2[s]]
    assert wins == swept[: len(wins)] and wins[-1] == tk.KGRAM_MAX_STATES
    assert tk.KGRAM_MAX_STATES == jk.KGRAM_MAX_STATES == 32
    for s in swept:
        classes = [c for lv in sorted(tk.KGRAM_SWEEP)
                   for n, c, _, _ in tk.KGRAM_SWEEP[lv] if n == s]
        model = int(np.argmin([tk.kgram_step_cost(s, c, lv)
                               for lv, c in enumerate(classes)]))
        assert (model > 0) == (s <= tk.KGRAM_MAX_STATES)


@pytest.mark.parametrize("gate", [0, 32, 1000])
def test_count_does_not_depend_on_the_level(gate, monkeypatch):
    """count() is exact on either engine: moving the gate (k=1 everywhere, the
    card's 32, k-gram for larger automata) changes the engine, not the
    total."""
    from regex_fpga_tpu_torch import api as tapi
    from regex_fpga_tpu_torch.utils.config import EngineConfig

    monkeypatch.setattr(tapi, "KGRAM_MAX_STATES", gate)
    cfg = EngineConfig(scan_backend="device", num_blocks=16, chunk_bytes=4096)
    text = bytes(TEXT[:9001])
    for m in (tapi.compile_tokenizer(config=cfg, device="cpu"),
              tapi.compile_regex(rb"[a-z]+[0-9]|fox", config=cfg, device="cpu")):
        assert (m._kgram() is not None) == (m.num_states <= gate)
        assert m.count(text) == m.scan(text).total
        assert m.count(text) == int(jk_total(m, text))


def jk_total(m, text):
    """The total of a serial walk of ``m``'s tables."""
    t, c, a = (x.numpy() for x in (m.tables.table, m.tables.class_of,
                                   m.tables.accept))
    s, total = m.start, 0
    for byte in text:
        total += int(a[s])
        s = int(t[c[byte], s])
    return total + int(m._accept_eof[s])
