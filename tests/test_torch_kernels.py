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
    (83, 1025, 4096, 1024, torch.uint8, True),  # the Snort lazy snapshot: uint16
    (83, 1400, 97, 257, torch.uint8, True),     # just past the uint16 limit
    (2, 70_000, 40, 300, torch.int16, False),   # S above 65,535: never narrowed
]

# the table route each shape must take on an H100 (227 KB of shared memory a
# block), in finals mode with uint8 class ids
ROUTES = {(10, 23): "shared int32", (36, 836): "shared int32",
          (256, 1024): "global", (37, 5): "shared int32",
          (83, 2049): "global", (83, 1025): "shared uint16",
          (83, 1400): "global", (2, 70_000): "global"}


@pytest.mark.parametrize("c,s", list(ROUTES))
def test_dfa_chain_route(cuda, c, s):
    route = hopper_dfa.dfa_chain_route("finals", c, s, 1024)
    assert route["table"] == ROUTES[(c, s)]
    assert route["table_smem"] == (ROUTES[(c, s)] != "global")
    assert route["lanes_per_cta"] == 128


@pytest.mark.parametrize("nb", [1, 31, 1024, 65536])
@pytest.mark.parametrize("b", [1, 31, 33, 64, 95])
@pytest.mark.parametrize("block_major", [True, False])
def test_dfa_chain_lanes_steps_and_orders(cuda, nb, b, block_major):
    """Lane counts from one to a full chunk's, steps that are not a
    multiple of the 32-step window, rows that start at any byte, both input
    orders, on the uint16 route (the Snort lazy snapshot's shape)."""
    rng = np.random.default_rng(nb + b)
    table, accept = random_table(rng, 83, 1025, cuda)
    cls = class_columns(rng, 83, b, nb, torch.uint8, block_major, cuda)
    ent = torch.as_tensor(rng.integers(0, 1025, size=nb).astype(np.int32),
                          device=cuda)
    for mode in hopper_dfa.MODES:
        got = hopper_dfa.dfa_chain(table, accept, cls, ent, mode)
        want = hopper_dfa.dfa_chain_plain(table, accept, cls, ent, mode)
        for g, w in zip(got, want):
            if g is not None:
                assert torch.equal(g, w), mode
    got = hopper_dfa.dfa_chain_counts(table, accept, cls, ent)
    want = hopper_dfa.dfa_chain_counts_plain(table, accept, cls, ent)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("c,s", [(83, 1025), (12, 30)])
def test_corrupt_table_on_each_shared_route(cuda, c, s):
    """Entries that uint16 cannot hold (negative, 65,535 and above) and
    entries past S step exactly as in the plain version on the narrowed
    route (83, 1025) and the int32 route (12, 30); a strided view of the
    class ids (neither stride 1) is read too."""
    rng = np.random.default_rng(c)
    table, accept = random_table(rng, c, s, cuda)
    flat = table.view(-1)
    hit = torch.as_tensor(rng.choice(flat.numel(), size=40, replace=False),
                          device=cuda)
    flat[hit] = torch.as_tensor(
        rng.choice([-3, -70_000, 65_535, 65_536, 70_001, s, s + 7], size=40)
        .astype(np.int32), device=cuda)
    wide = class_columns(rng, c + 2, 70, 2 * 300, torch.uint8, False, cuda)
    cls = wide[::2, ::2]  # (35, 300), strides (1200, 2)
    ent = torch.as_tensor(rng.integers(-2, s + 2, size=300).astype(np.int32),
                          device=cuda)
    for mode in hopper_dfa.MODES:
        for g, w in zip(hopper_dfa.dfa_chain(table, accept, cls, ent, mode),
                        hopper_dfa.dfa_chain_plain(table, accept, cls, ent, mode)):
            if g is not None:
                assert torch.equal(g, w), mode
    got = hopper_dfa.dfa_chain_counts(table, accept, cls, ent, 4)
    want = hopper_dfa.dfa_chain_counts_plain(table, accept, cls, ent, 4)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


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
    "3,000 states": random_case(3000, 20_000, 8),  # CSR shared, bitmap summary
    "40,000 states": random_case(40_000, 200_000, 4),  # CSR in global memory
    "l7 corpus": l7_case,
}
# where K4 keeps the CSR of each (one stream per CTA at 8 streams)
CSR_SMEM = {"random": True, "two-byte alphabet": True, "3,000 states": True,
            "40,000 states": False, "l7 corpus": True}


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
    route = hopper_nfa.nfa_active_route(csr, len(lens), bound)
    assert route["csr_smem"] == CSR_SMEM[name]
    assert route["counts_smem"] and route["streams_per_cta"] == 1
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


@pytest.mark.parametrize("name", ["l7 corpus", "3,000 states"])
def test_nfa_active_scan_many_streams_per_cta(cuda, name):
    """397 streams: several share a CTA (and its CSR), and the last CTA is
    only partly filled; zero-length and overflowing streams among them."""
    rng = np.random.default_rng(397)
    aut, data = NFAS[name](rng)
    s = aut.num_states
    csr = build_nfa_csr(aut, device=cuda)
    n = 397
    route = hopper_nfa.nfa_active_route(csr, n, 8)
    assert route["streams_per_cta"] > 1 and n % route["streams_per_cta"]
    lens = rng.integers(0, 300, size=n)
    lens[::50] = 0
    starts = rng.integers(0, len(data) - 300, size=n)
    active = initial_active(s, 8, n, cuda)
    counts = torch.zeros((n, s + 1), dtype=torch.int32, device=cuda)
    dev_data = torch.as_tensor(np.array(data), device=cuda)
    got = hopper_nfa.nfa_active_scan(csr, dev_data, starts, lens, active, counts)
    want = hopper_nfa.nfa_active_scan_plain(csr, dev_data, starts, lens,
                                            active, counts)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
