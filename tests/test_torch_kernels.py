"""The Hopper kernels K1 (dfa_chain), K2 (dfa_chain_counts), K3
(kgram_chain) and K4 (nfa_active_scan) against their plain versions, on the
card, bit for bit.

Every test here needs a CUDA card and nvcc and skips without them. The file
imports no JAX and no conftest helper, so that it runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q
"""

import numpy as np
import pytest
import torch

from regex_fpga_tpu_torch.models import CsrAutomaton, gen_l7_traffic, l7_corpus_nfa
from regex_fpga_tpu_torch.ops import hopper_dfa, hopper_kgram, hopper_nfa
from regex_fpga_tpu_torch.ops.nfa_engine import initial_active
from regex_fpga_tpu_torch.ops.tables import build_nfa_csr

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def random_table(rng, c, s, device):
    table = torch.as_tensor(rng.integers(0, s, size=(c, s)).astype(np.int32),
                            device=device)
    accept = torch.as_tensor(rng.random(s) < 0.3, device=device)
    return table, accept


def class_columns(rng, c, b, nb, dtype, block_major, device):
    """(B, NB) class ids on the card, stored time-major or block-major."""
    if block_major:
        ids = rng.integers(0, c, size=(nb, b))
        return torch.as_tensor(ids, device=device).to(dtype).T
    return torch.as_tensor(rng.integers(0, c, size=(b, nb)),
                           device=device).to(dtype)


SHAPES = [  # (C, S, B, NB, class dtype, block-major storage)
    (10, 23, 100, 1000, torch.uint8, True),     # tokenizer-sized table
    (36, 836, 64, 4096, torch.int32, False),    # keyword AC-sized table
    (256, 1024, 64, 4096, torch.uint8, True),   # table above shared memory
    (37, 5, 33, 77, torch.int16, False),        # ragged edges everywhere
    (83, 2049, 256, 1024, torch.uint8, True),   # a lazy-DFA snapshot's shape
]


@pytest.mark.parametrize("c,s,b,nb,dtype,block_major", SHAPES)
def test_dfa_chain_matches_plain(cuda, c, s, b, nb, dtype, block_major):
    rng = np.random.default_rng(c * s)
    table, accept = random_table(rng, c, s, cuda)
    cls = class_columns(rng, c, b, nb, dtype, block_major, cuda)
    ent = torch.as_tensor(rng.integers(0, s, size=nb).astype(np.int32),
                          device=cuda)
    for mode in hopper_dfa.MODES:
        before = hopper_dfa.LAUNCHES["dfa_chain"]
        got = hopper_dfa.dfa_chain(table, accept, cls, ent, mode)
        assert hopper_dfa.LAUNCHES["dfa_chain"] == before + 1
        want = hopper_dfa.dfa_chain_plain(table, accept, cls, ent, mode)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if g is not None:
                assert torch.equal(g, w), mode


@pytest.mark.parametrize("c,s,b,nb,dtype,block_major", SHAPES)
@pytest.mark.parametrize("num_streams", [None, 1, 7])
def test_dfa_chain_counts_matches_plain(cuda, c, s, b, nb, dtype, block_major,
                                        num_streams):
    if num_streams and nb % num_streams:
        nb -= nb % num_streams
    rng = np.random.default_rng(c + s)
    table, accept = random_table(rng, c, s, cuda)
    cls = class_columns(rng, c, b, nb, dtype, block_major, cuda)
    ent = torch.as_tensor(rng.integers(0, s, size=nb).astype(np.int32),
                          device=cuda)
    got = hopper_dfa.dfa_chain_counts(table, accept, cls, ent, num_streams)
    want = hopper_dfa.dfa_chain_counts_plain(table, accept, cls, ent,
                                             num_streams)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("c,s,b,nb,dtype,block_major", [
    (221, 23, 64, 2048, torch.int32, True),     # tokenizer level-2 k-gram
    (2049, 40, 32, 512, torch.int32, False),    # class ids above 2048
    (36, 836, 16, 700, torch.int16, True),      # table above shared memory
])
def test_kgram_chain_matches_plain(cuda, c, s, b, nb, dtype, block_major):
    rng = np.random.default_rng(c)
    table, _ = random_table(rng, c, s, cuda)
    acc = torch.as_tensor(rng.integers(0, 5, size=(c, s)).astype(np.int32),
                          device=cuda)
    cls = class_columns(rng, c, b, nb, dtype, block_major, cuda)
    ent = torch.as_tensor(rng.integers(0, s, size=nb).astype(np.int32),
                          device=cuda)
    ta = hopper_kgram.pack_ta(table, acc)
    got = hopper_kgram.kgram_chain(ta, cls, ent)
    want = hopper_kgram.kgram_chain_plain(ta, cls, ent)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_out_of_range_ids_step_like_plain(cuda):
    """Corrupt tables and entries: out-of-range ids go to state 0 in the
    kernels exactly as in the plain versions, and nothing faults."""
    rng = np.random.default_rng(1)
    table, accept = random_table(rng, 12, 30, cuda)
    table[0, 0], table[3, 7] = 999, -3
    cls = class_columns(rng, 14, 50, 300, torch.int32, True, cuda)  # ids >= C
    ent = torch.as_tensor(rng.integers(-5, 40, size=300).astype(np.int32),
                          device=cuda)
    for mode in hopper_dfa.MODES:
        for g, w in zip(hopper_dfa.dfa_chain(table, accept, cls, ent, mode),
                        hopper_dfa.dfa_chain_plain(table, accept, cls, ent, mode)):
            if g is not None:
                assert torch.equal(g, w), mode
    got = hopper_dfa.dfa_chain_counts(table, accept, cls, ent, 3)
    want = hopper_dfa.dfa_chain_counts_plain(table, accept, cls, ent, 3)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    ta = hopper_kgram.pack_ta(table, table.abs() % 3)
    got = hopper_kgram.kgram_chain(ta, cls, ent)
    want = hopper_kgram.kgram_chain_plain(ta, cls, ent)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_api_on_card_matches_cpu(cuda):
    from regex_fpga_tpu_torch import api

    cfg = api.EngineConfig(scan_backend="device", num_blocks=256,
                       chunk_bytes=1 << 16)
    text = (b"The quick brown fox jumps over 1234 lazy dogs, it's 99.5% "
            b"fine! " * 3000)
    on_card = api.compile_tokenizer(config=cfg, device=cuda)
    on_cpu = api.compile_tokenizer(config=cfg, device="cpu")
    np.testing.assert_array_equal(on_card.scan(text).counts,
                                  on_cpu.scan(text).counts)
    assert on_card.count(text) == on_cpu.count(text)
    np.testing.assert_array_equal(on_card.presplit(text),
                                  on_cpu.presplit(text))
    got = on_card.scan(text, collect_positions=True)
    want = on_cpu.scan(text, collect_positions=True)
    np.testing.assert_array_equal(got.match_positions[0],
                                  want.match_positions[0])


def random_nfa(rng, n_states, n_edges, n_accept, n_bytes=256):
    """A random CSR NFA whose accepting states have no out-edges."""
    accept = rng.choice(np.arange(1, n_states), size=n_accept, replace=False)
    src = np.sort(rng.choice(np.setdiff1d(np.arange(n_states), accept),
                             size=n_edges))
    return CsrAutomaton(
        offsets=np.searchsorted(src, np.arange(n_states + 1)).astype(np.int64),
        trans_char=rng.integers(0, n_bytes, size=n_edges).astype(np.uint8),
        trans_target=rng.integers(0, n_states, size=n_edges).astype(np.int32),
    )


def l7_case(rng):
    return (l7_corpus_nfa(),
            np.frombuffer(b"".join(gen_l7_traffic()[0]), np.uint8))


def random_case(n_states, n_edges, n_bytes):
    """A random NFA over the first n_bytes byte values, and bytes of them."""
    def make(rng):
        aut = random_nfa(rng, n_states, n_edges, n_states // 10, n_bytes)
        return aut, rng.integers(0, n_bytes, size=5000).astype(np.uint8)
    return make


NFAS = {  # name -> (automaton, bytes) from a seeded generator
    "random": random_case(60, 2000, 16),
    "two-byte alphabet": random_case(40, 240, 2),  # every list overflows
    "40,000 states": random_case(40_000, 200_000, 4),
    "l7 corpus": l7_case,
}


@pytest.mark.parametrize("name", list(NFAS))
@pytest.mark.parametrize("bound", [1, 4, 32, 128])
def test_nfa_active_scan_matches_plain(cuda, name, bound):
    """Ragged streams (0 to 2,000 bytes), overflow at small bounds, start
    counts of any value and one unsorted start list with duplicates."""
    rng = np.random.default_rng(bound)
    aut, data = NFAS[name](rng)
    s = aut.num_states
    csr = build_nfa_csr(aut, device=cuda)
    lens = np.array([0, 1, 31, 32, 33, 700, 2000, 1999])
    starts = rng.integers(0, len(data) - 2000, size=len(lens))
    active = initial_active(s, bound, len(lens), cuda)
    active[-1] = torch.as_tensor(rng.integers(0, s + 1, size=bound), device=cuda)
    counts = torch.as_tensor(rng.integers(0, 1000, size=(len(lens), s + 1))
                             .astype(np.int32), device=cuda)
    dev_data = torch.as_tensor(np.array(data), device=cuda)
    before = hopper_nfa.LAUNCHES["nfa_active_scan"]
    got = hopper_nfa.nfa_active_scan(csr, dev_data, starts, lens, active, counts)
    assert hopper_nfa.LAUNCHES["nfa_active_scan"] == before + 1
    want = hopper_nfa.nfa_active_scan_plain(csr, dev_data, starts, lens,
                                            active, counts)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if name == "two-byte alphabet" and bound <= 4:
        assert bool(want[2].any())  # the overflow path ran
    if name == "l7 corpus" and bound == 128:
        assert not bool(want[2].any())
