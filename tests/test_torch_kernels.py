"""The Hopper kernels K1 (dfa_chain), K2 (dfa_chain_counts), K3
(kgram_chain), K4 (nfa_active_scan), K5 (nfa_tp_scan) and K6 (dfa_block_fns
and its combine, dfa_fn_combine) against their plain versions, on the card,
bit for bit.

Every test here needs a CUDA card and nvcc and skips without them. The file
imports no JAX and no conftest helper, so that it runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q
"""

import numpy as np
import pytest
import torch

from regex_fpga_tpu_torch.models import (CsrAutomaton, build_tokenizer_dfa,
                                         gen_l7_traffic, gen_traffic,
                                         l7_corpus_nfa, snort_corpus_nfa)
from regex_fpga_tpu_torch.ops import hopper_dfa, hopper_kgram, hopper_nfa
from regex_fpga_tpu_torch.ops import kgram as kgram_ops
from regex_fpga_tpu_torch.ops.nfa_engine import initial_active
from regex_fpga_tpu_torch.ops.tables import build_dfa_tables, build_nfa_csr

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def random_table(rng, c, s, device, density=0.3):
    table = torch.as_tensor(rng.integers(0, s, size=(c, s)).astype(np.int32),
                            device=device)
    accept = torch.as_tensor(rng.random(s) < density, device=device)
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
    (2, 70_000, 40, 300, torch.int16, False),   # S above 32,767: never narrowed
    (2, 32_767, 40, 300, torch.uint8, True),    # the largest uint16 table
    (2, 32_768, 40, 300, torch.uint8, True),    # one state more: global
]

# the table route each shape must take on an H100 (227 KB of shared memory a
# block), in finals mode with uint8 class ids and 1,024 lanes (a CTA an SM:
# uint32 entries wherever they fit)
ROUTES = {(10, 23): "shared uint32", (36, 836): "shared uint32",
          (256, 1024): "global", (37, 5): "shared uint32",
          (83, 2049): "global", (83, 1025): "shared uint16",
          (83, 1400): "global", (2, 70_000): "global",
          (2, 32_767): "shared uint16", (2, 32_768): "global"}
# the histogram each takes in counts mode: a private row per lane up to 64
# states, else a row per stream of the CTA, unless two such rows outgrow
# shared memory
HISTS = {s: ("lane rows" if s <= 64 else "stream rows" if s < 30_000
             else "global") for _, s in ROUTES}


@pytest.mark.parametrize("c,s", list(ROUTES))
def test_dfa_chain_route(cuda, c, s):
    route = hopper_dfa.dfa_chain_route("finals", c, s, 1024)
    assert route["table"] == ROUTES[(c, s)]
    assert route["table_smem"] == (ROUTES[(c, s)] != "global")
    assert route["lanes_per_cta"] == 128
    assert not route["accept_folded"]
    counts = hopper_dfa.dfa_chain_route("counts", c, s, 1024, 4)
    assert counts["table"] == ROUTES[(c, s)]
    # one load per step wherever the table is in shared memory
    assert counts["accept_folded"] == counts["table_smem"]
    assert counts["hist"] == HISTS[s]
    assert counts["hist_smem"] == (HISTS[s] != "global")
    assert route["ring"] in (2, 4, 8) and counts["ring"] in (2, 4, 8)


def test_routes_follow_the_lane_count(cuda):
    """Few lanes (a CTA an SM, nothing else to hide a window's copy behind)
    take the deepest staging ring that fits; a grid that needs four CTAs an
    SM keeps them: a shallower ring, and uint16 entries where uint32 ones
    would leave an SM fewer CTAs."""
    few = hopper_dfa.dfa_chain_route("finals", 10, 23, 1024)
    many = hopper_dfa.dfa_chain_route("counts", 10, 23, 65536)
    assert (few["ring"], many["ring"]) == (8, 4)  # lane rows leave room for four
    assert few["table"] == many["table"] == "shared uint32"
    lazy = hopper_dfa.dfa_chain_route("counts", 83, 1025, 1024)
    assert lazy["table"] == "shared uint16" and lazy["ring"] >= 4
    assert hopper_dfa.dfa_chain_route("finals", 36, 836, 1024)["table"] == "shared uint32"
    wide = hopper_dfa.dfa_chain_route("counts", 36, 836, 65536)
    assert wide["table"] == "shared uint16" and wide["accept_folded"]
    kg, ta, maps = tokenizer_kgram(2, cuda)
    assert hopper_kgram.kgram_chain_route(ta, num_lanes=1024)["ring"] == 8
    assert hopper_kgram.kgram_chain_route(ta, maps, num_lanes=65536)["ring"] in (2, 4)


@pytest.mark.parametrize("b", [257, 300, 1031])
@pytest.mark.parametrize("nb", [200, 65_536])
@pytest.mark.parametrize("block_major", [True, False])
def test_chains_longer_than_the_ring(cuda, b, nb, block_major):
    """More windows than the staging ring holds, the last one partial, at a
    lane count that takes the ring of eight in every mode and one that takes
    a shallower one where the output tiles need the room: K1 in every mode,
    K2, and K3 over class ids and raw text."""
    rng = np.random.default_rng(b + nb)
    table, accept = random_table(rng, 10, 23, cuda)
    cls = class_columns(rng, 11, b, nb, torch.uint8, block_major, cuda)
    ent = torch.as_tensor(rng.integers(0, 23, size=nb).astype(np.int32),
                          device=cuda)
    assert hopper_dfa.dfa_chain_route("finals", 10, 23, nb)["ring"] == 8
    assert hopper_dfa.dfa_chain_route("counts", 10, 23, nb, 8)["ring"] == (8 if nb == 200 else 4)
    for mode in hopper_dfa.MODES:
        for g, w in zip(hopper_dfa.dfa_chain(table, accept, cls, ent, mode),
                        hopper_dfa.dfa_chain_plain(table, accept, cls, ent, mode)):
            if g is not None:
                assert torch.equal(g, w), mode
    got = hopper_dfa.dfa_chain_counts(table, accept, cls, ent, 8)
    want = hopper_dfa.dfa_chain_counts_plain(table, accept, cls, ent, 8)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    kg, ta, maps = tokenizer_kgram(2, cuda)
    ids = class_columns(rng, kg.table.shape[0], b, nb, torch.int16, block_major, cuda)
    got = hopper_kgram.kgram_chain(ta, ids, ent)
    want = hopper_kgram.kgram_chain_plain(ta, ids, ent)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    shape = (nb, b, 4) if block_major else (b, nb, 4)
    raw = torch.as_tensor(rng.integers(0, 256, size=shape).astype(np.uint8), device=cuda)
    text = raw.transpose(0, 1) if block_major else raw
    got = hopper_kgram.kgram_chain_bytes(ta, maps, text, ent)
    want = hopper_kgram.kgram_chain_bytes_plain(ta, maps, text, ent)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("nb", [1, 31, 1024, 65536])
@pytest.mark.parametrize("b", [1, 31, 33, 64, 95])
@pytest.mark.parametrize("block_major", [True, False])
@pytest.mark.parametrize("c,s", [(83, 1025), (10, 23)])
def test_dfa_chain_lanes_steps_and_orders(cuda, nb, b, block_major, c, s):
    """Lane counts from one to a full chunk's, steps that are not a
    multiple of the 32-step window, rows that start at any byte, both input
    orders, on the uint16 route (the Snort lazy snapshot's shape, a
    histogram row per stream) and the uint32 route (the tokenizer's shape, a
    histogram row per lane)."""
    rng = np.random.default_rng(nb + b + s)
    table, accept = random_table(rng, c, s, cuda)
    cls = class_columns(rng, c, b, nb, torch.uint8, block_major, cuda)
    ent = torch.as_tensor(rng.integers(0, s, size=nb).astype(np.int32),
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


@pytest.mark.parametrize("c,s", [(83, 1025), (12, 30), (2, 32_767), (2, 32_768)])
def test_corrupt_table_on_each_shared_route(cuda, c, s):
    """Entries that uint16 cannot hold (negative, 65,535 and above) and
    entries past S step exactly as in the plain version on the narrowed
    route (83, 1025), the int32 route (12, 30), the largest table whose
    entries carry the accept bit in uint16 (S = 32,767) and the first one
    past it (global memory); a strided view of the class ids (neither stride
    1) is read too."""
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


@pytest.mark.parametrize("density", [0.01, 0.95])
@pytest.mark.parametrize("c,s,lanes_per_stream", [
    (10, 23, 4096),     # lane rows, CTAs within one stream
    (10, 23, 48),       # lane rows, streams that end inside a warp
    (83, 1025, 48),     # uint16 table, stream rows, a CTA across 4 streams
    (36, 836, 200),     # uint32 table, stream rows
    (2, 40_000, 200),   # past the uint16 limit: the global route
    (256, 1024, 1),     # global table, one lane a stream
])
def test_dfa_chain_counts_dense_and_sparse_hits(cuda, density, c, s,
                                                lanes_per_stream):
    """K2 with nearly every step counted and with nearly none, on each
    histogram placement, streams cut anywhere relative to the CTAs."""
    rng = np.random.default_rng(s + lanes_per_stream)
    n = 7
    nb = n * lanes_per_stream
    table, accept = random_table(rng, c, s, cuda, density)
    accept[int(table[0, 0])] = True  # at least one state counts
    cls = class_columns(rng, c, 70, nb, torch.uint8, True, cuda)
    ent = torch.as_tensor(rng.integers(0, s, size=nb).astype(np.int32),
                          device=cuda)
    got = hopper_dfa.dfa_chain_counts(table, accept, cls, ent, n)
    want = hopper_dfa.dfa_chain_counts_plain(table, accept, cls, ent, n)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(want[1].sum()) > 0


KGRAM_SHAPES = [  # (C, S, largest count, B, NB, class dtype, block-major, table)
    (221, 23, 4, 64, 2048, torch.int32, True, "shared uint16"),   # tokenizer k=4
    (2049, 40, 4, 32, 512, torch.int32, False, "shared uint16"),  # ids above 2048
    (36, 836, 4, 16, 700, torch.int16, True, "shared uint16"),
    (3, 4095, 4, 33, 300, torch.uint8, True, "shared uint16"),    # the largest
    (3, 4096, 4, 33, 300, torch.uint8, True, "shared uint32"),    # one state more
    (8, 5000, 200, 95, 300, torch.int16, False, "shared uint32"),
    (36, 5000, 4, 31, 300, torch.uint8, True, "global"),   # above shared memory
    (10, 100, 300, 64, 300, torch.int32, False, "global"),  # counts no form holds
]


@pytest.mark.parametrize("c,s,top,b,nb,dtype,block_major,where", KGRAM_SHAPES)
def test_kgram_chain_matches_plain(cuda, c, s, top, b, nb, dtype, block_major,
                                   where):
    """Both narrow forms and the global route, steps off the window, both
    storage orders; a tenth of the transitions lead outside the table."""
    rng = np.random.default_rng(c)
    table, _ = random_table(rng, c, s, cuda)
    table.view(-1)[::10] = torch.as_tensor(
        rng.choice([-3, s, s + 7, 70_001], size=len(table.view(-1)[::10]))
        .astype(np.int32), device=cuda)
    acc = torch.as_tensor(rng.integers(0, top + 1, size=(c, s)).astype(np.int32),
                          device=cuda)
    acc[0, 0] = top
    cls = class_columns(rng, c + 1, b, nb, dtype, block_major, cuda)
    ent = torch.as_tensor(rng.integers(-1, s + 1, size=nb).astype(np.int32),
                          device=cuda)
    ta = hopper_kgram.pack_ta(table, acc)
    assert hopper_kgram.kgram_chain_route(ta, class_dtype=dtype)["table"] == where
    before = hopper_kgram.LAUNCHES["kgram_chain"]
    for steps in (b, 1, 2):  # a corrupt final state is read back exactly
        got = hopper_kgram.kgram_chain(ta, cls[:steps], ent)
        want = hopper_kgram.kgram_chain_plain(ta, cls[:steps], ent)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert hopper_kgram.LAUNCHES["kgram_chain"] == before + 3


def tokenizer_kgram(levels, device):
    tok = build_tokenizer_dfa()
    kg = kgram_ops.build_kgram(build_dfa_tables(tok.table, tok.accept,
                                                device="cpu"), levels=levels)
    ta = hopper_kgram.pack_ta(torch.as_tensor(kg.table),
                              torch.as_tensor(kg.acc_table)).to(device)
    return kg, ta, kgram_ops.kgram_maps(kg).to(device)


TEXT = (b"The quick brown fox jumps over 1234 lazy dogs, it's 99.5% fine!  "
        b"pre-split   benchmark text \xc3\xa9t\xc3\xa9 2026... ")


@pytest.mark.parametrize("levels", [1, 2, 3])
@pytest.mark.parametrize("b,nb", [(1, 1), (31, 77), (33, 1000), (256, 4096)])
@pytest.mark.parametrize("block_major", [True, False])
def test_kgram_chain_bytes_matches_plain(cuda, levels, b, nb, block_major):
    """Raw text in, k = 2, 4 and 8 bytes a step, on the tokenizer's tables:
    half text, half random bytes, both storage orders, and a view that
    starts off a multiple of k (copied by the wrapper)."""
    rng = np.random.default_rng(levels + b)
    kg, ta, maps = tokenizer_kgram(levels, cuda)
    k = kg.k
    n = b * nb * k
    raw = np.where(rng.random(n + 1) < 0.5, np.resize(np.frombuffer(TEXT, np.uint8), n + 1),
                   rng.integers(0, 256, size=n + 1)).astype(np.uint8)
    data = torch.as_tensor(raw, device=cuda)
    ent = torch.as_tensor(rng.integers(0, kg.num_states, size=nb).astype(np.int32),
                          device=cuda)
    assert hopper_kgram.kgram_bytes_supported(ta, maps)
    assert hopper_kgram.kgram_chain_route(ta, maps)["table"] == "shared uint16"
    for flat in (data[:n], data[1:]):
        text = (flat.reshape(nb, b, k).transpose(0, 1) if block_major
                else flat.reshape(b, nb, k))
        before = hopper_kgram.LAUNCHES["kgram_chain_bytes"]
        got = hopper_kgram.kgram_chain_bytes(ta, maps, text, ent)
        assert hopper_kgram.LAUNCHES["kgram_chain_bytes"] == before + 1
        want = hopper_kgram.kgram_chain_bytes_plain(ta, maps, text, ent)
        ids = hopper_kgram.kgram_chain(
            ta, hopper_kgram.map_classes(maps, text)[..., 0], ent)
        torch.cuda.synchronize()
        for g, w, i in zip(got, want, ids):
            assert torch.equal(g, w) and torch.equal(i, w)


def test_kgram_bytes_with_maps_above_shared_memory(cuda):
    """Pair maps of 720 KB: the raw-text kernel refuses them, and the scan
    maps the classes first and takes the class-id kernel."""
    rng = np.random.default_rng(5)
    classes = (256, 600, 50)
    maps = hopper_kgram.pack_maps(
        np.arange(256), [rng.integers(0, 600, size=256 * 256),
                         rng.integers(0, 50, size=600 * 600)], classes).to(cuda)
    table, _ = random_table(rng, 50, 23, cuda)
    ta = hopper_kgram.pack_ta(table, table % 5)
    assert not hopper_kgram.kgram_bytes_supported(ta, maps)
    data = torch.as_tensor(rng.integers(0, 256, size=64 * 40 * 4).astype(np.uint8),
                           device=cuda)
    ent = torch.zeros(64, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="do not fit"):
        hopper_kgram.kgram_chain_bytes(ta, maps, data.reshape(40, 64, 4), ent)
    before = dict(hopper_kgram.LAUNCHES)
    got = kgram_ops.dfa_scan_kgram(ta, data, num_blocks=64, maps=maps)
    assert hopper_kgram.LAUNCHES["kgram_chain_bytes"] == before["kgram_chain_bytes"]
    assert hopper_kgram.LAUNCHES["kgram_chain"] > before["kgram_chain"]
    want = kgram_ops.dfa_scan_kgram(ta.to("cpu"), data.cpu(), num_blocks=64,
                                    maps=maps.to("cpu"))
    assert (int(got.total), int(got.final_state), got.converged, got.iterations) == \
        (int(want.total), int(want.final_state), want.converged, want.iterations)


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
    before = hopper_kgram.LAUNCHES["kgram_chain_bytes"]
    assert on_card.count(text) == on_cpu.count(text) == on_cpu.scan(text).total
    # count sends the raw text to the k-gram kernel: no class-id tensor
    assert hopper_kgram.LAUNCHES["kgram_chain_bytes"] > before
    np.testing.assert_array_equal(on_card.presplit(text),
                                  on_cpu.presplit(text))
    got = on_card.scan(text, collect_positions=True)
    want = on_cpu.scan(text, collect_positions=True)
    np.testing.assert_array_equal(got.match_positions[0],
                                  want.match_positions[0])


def block_fn_case(rng, kind, c, s, nb, b):
    """A (C, S) table and (NB, B) uint8 class ids of one kind: "random";
    "narrow" (every entry in states 0-2: at most 3 chains after a byte);
    "permutation" (every class permutes the states: no two chains ever
    meet); "reset" (class 0 sends every state to one state, and every
    block but the last starts with it: all chains merge at byte 1);
    "late" (permutations, and the reset class only after the last merge
    check). Out-of-range class ids (255) on the last block, which step to
    state 0."""
    if kind == "random":
        table = rng.integers(0, s, size=(c, s))
    elif kind == "narrow":  # every class leads into states 0-2: packs of 3
        table = rng.integers(0, 3, size=(c, s))
    else:
        table = np.stack([rng.permutation(s) for _ in range(c)])
    cls = rng.integers(0, c, size=(nb, b))
    if kind in ("reset", "late"):
        table[0] = rng.integers(0, s)
        cls = rng.integers(1, c, size=(nb, b))
        if kind == "reset":
            cls[:-1, 0] = 0
        else:
            last = 8
            while last * 2 < b:
                last *= 2
            cls[::2, last + (b - last) // 2] = 0
    if c < 256:
        cls[-1, ::7] = 255
    return table.astype(np.int32), cls.astype(np.uint8)


@pytest.mark.parametrize("kind,c,s,nb,b", [
    ("random", 2, 2, 333, 1024),         # a parity automaton: a block a thread
    ("random", 3, 4, 64, 1000),          # (aa)*b reversed, a block size not of 16
    ("random", 10, 23, 200, 5),          # a block shorter than the first check
    ("random", 7, 33, 100, 333),         # S just above a warp: a block a warp
    ("random", 36, 836, 70, 1024),       # Aho-Corasick-sized: uint16 table, merging
    ("random", 256, 300, 5, 64),         # 256 classes
    ("random", 40, 5000, 9, 256),        # above shared memory: global table, merging
    ("random", 2, 70_000, 3, 32),        # S above uint16: global table, no checks
    ("reset", 36, 836, 40, 1024),        # every chain merges at byte 1: packed
    ("reset", 36, 836, 100, 9),          # packed, one byte after the pack
    ("narrow", 36, 836, 70, 1000),       # three chains a block packed, B not of 16
    ("narrow", 40, 5000, 5, 64),         # global table: no packing above a pass
    ("reset", 5, 64, 50, 77),
    ("late", 36, 836, 20, 1024),         # merges only after the last check
    ("permutation", 36, 836, 30, 1024),  # never merges
    ("permutation", 36, 1500, 12, 1024),  # never merges; S above a pass of 1,024 chains
    ("permutation", 2, 32_767, 3, 40),   # the largest uint16 table: no room for checks
])
def test_dfa_block_fns_matches_plain(cuda, kind, c, s, nb, b):
    """K6 pass 1 against its plain version on each route, bit for bit."""
    rng = np.random.default_rng(s + b)
    table, cls = block_fn_case(rng, kind, c, s, nb, b)
    table = torch.as_tensor(table, device=cuda)
    cls = torch.as_tensor(cls, device=cuda)
    before = hopper_dfa.LAUNCHES["dfa_block_fns"]
    got = hopper_dfa.dfa_block_fns(table, cls)
    torch.cuda.synchronize()
    assert hopper_dfa.LAUNCHES["dfa_block_fns"] == before + 1
    assert torch.equal(got, hopper_dfa.dfa_block_fns_plain(table, cls))


@pytest.mark.parametrize("c,s,b,route", [
    (2, 2, 1024, ("block a thread", "shared uint32", 2, 0, False, 128)),
    (3, 4, 1000, ("block a thread", "shared uint32", 4, 0, False, 128)),
    (10, 23, 1024, ("block a thread", "shared uint32", 24, 0, False, 128)),
    (7, 33, 1024, ("block a warp", "shared uint16", 2, 7, True, 16 * 32)),
    (36, 836, 1024, ("block a warp", "shared uint16", 27, 7, True, 10 * 32)),
    (36, 836, 16, ("block a warp", "shared uint16", 27, 1, True, 10 * 32)),
    (36, 836, 8, ("block a warp", "shared uint16", 27, 0, False, 16)),
    (36, 836, 5, ("block a warp", "shared uint16", 27, 0, False, 16)),
    (36, 1500, 1024, ("block a warp", "shared uint16", 32, 7, False, 9)),
    (40, 5000, 256, ("block a warp", "global", 32, 5, False, 12)),
    (2, 32_767, 40, ("block a warp", "shared uint16", 32, 0, False, 16)),
    (2, 70_000, 32, ("block a warp", "global", 32, 0, False, 16)),
])
def test_dfa_block_fns_route(cuda, c, s, b, route):
    """The route K6 pass 1 takes on an H100 (227 KB of shared memory a
    block): a block a thread up to 32 states, else a block a warp with merge
    checks after 8, 16, ... bytes wherever the owner tables fit, and packing
    where a pass holds every start state and the block outlasts the first
    check."""
    got = hopper_dfa.dfa_block_fns_route(c, s, 65536, b)
    keys = ("route", "table", "chains_per_lane", "merge_checks", "packed",
            "blocks_per_cta")
    assert tuple(got[k] for k in keys) == route


def combine_case(rng, kind, nb, s):
    """(NB, S) int32 block functions of one kind: "random", "constant",
    "identity", "permutation", or "mixed" (random, every third constant)."""
    if kind == "constant":
        f = np.repeat(rng.integers(0, s, size=(nb, 1)), s, axis=1)
    elif kind == "identity":
        f = np.tile(np.arange(s), (nb, 1))
    elif kind == "permutation":
        f = np.stack([rng.permutation(s) for _ in range(nb)])
    else:
        f = rng.integers(0, s, size=(nb, s))
        if kind == "mixed":
            f[::3] = rng.integers(0, s, size=(len(f[::3]), 1))
    return f.astype(np.int32)


@pytest.mark.parametrize("kind", ["random", "constant", "identity",
                                  "permutation", "mixed"])
@pytest.mark.parametrize("nb,s", [(1, 5), (7, 3), (1000, 2), (5000, 33),
                                  (20_073, 836), (3, 5000), (65_536, 2)])
def test_dfa_fn_combine_matches_doubling(cuda, kind, nb, s):
    """K6's combine against its plain version (the doubling), from state 0,
    from the last state and from a start held in a tensor on the card."""
    rng = np.random.default_rng(nb + s)
    fns = torch.as_tensor(combine_case(rng, kind, nb, s), device=cuda)
    for start in (0, s - 1, torch.tensor([s // 2], dtype=torch.int32, device=cuda)):
        before = hopper_dfa.LAUNCHES["dfa_fn_combine"]
        entry, final = hopper_dfa.dfa_fn_combine(fns, start)
        torch.cuda.synchronize()
        assert hopper_dfa.LAUNCHES["dfa_fn_combine"] == before + 1
        want_entry, want_final = hopper_dfa.dfa_fn_combine_plain(fns, start)
        assert torch.equal(entry, want_entry)
        assert final.shape == () and int(final) == int(want_final)


@pytest.mark.parametrize("bad", ["entry -1", "entry S", "start -1",
                                 "start S", "int start S"])
def test_block_entry_states_range_check_on_card(cuda, bad):
    """The combine's contract on the card: ``block_entry_states`` raises the
    CPU's ``ValueError``, message and all, on an entry or a start outside
    [0, S), before the combine launches; in range it equals the CPU."""
    from regex_fpga_tpu_torch.ops.dfa_engine import block_entry_states

    rng = np.random.default_rng(5)
    s = 7
    f = combine_case(rng, "mixed", 40, s)
    got = block_entry_states(torch.as_tensor(f, device=cuda), 3)
    want = block_entry_states(torch.as_tensor(f), 3)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    what, value = bad.rsplit(" ", 1)
    value = s if value == "S" else int(value)
    start = 3
    if what == "entry":
        f[17, 2] = value
    elif what == "start":
        start = torch.tensor([value], dtype=torch.int32)
    else:
        start = value
    messages = []
    for dev in ("cpu", cuda):
        first = start.to(dev) if isinstance(start, torch.Tensor) else start
        before = hopper_dfa.LAUNCHES["dfa_fn_combine"]
        with pytest.raises(ValueError) as err:
            block_entry_states(torch.as_tensor(f, device=dev), first)
        assert hopper_dfa.LAUNCHES["dfa_fn_combine"] == before
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_exact_fallback_on_card_matches_cpu(cuda, monkeypatch):
    """The blocked scan on the card (K6 pass 1, its combine, then K1's full
    mode), in groups of blocks, equals the CPU's plain path, and launches
    pass 1 and the combine once a group."""
    from regex_fpga_tpu_torch.ops import dfa_engine
    from regex_fpga_tpu_torch.ops.dfa_engine import dfa_scan_blocked
    from regex_fpga_tpu_torch.ops.tables import tables_from_numpy

    rng = np.random.default_rng(3)
    t = rng.integers(0, 97, size=(256, 97)).astype(np.int32)
    cpu = tables_from_numpy(t, np.arange(256), rng.random(97) < 0.3, 97)
    card = cpu.to(cuda)
    stream = rng.integers(0, 256, size=40 * 1024).astype(np.uint8)
    want = dfa_scan_blocked(cpu, torch.as_tensor(stream), start=5)
    for group in (1, 3, 40):
        monkeypatch.setattr(dfa_engine, "FN_GROUP_BYTES", group * 4 * 97)
        before = dict(hopper_dfa.LAUNCHES)
        got = dfa_scan_blocked(card, torch.as_tensor(stream, device=cuda),
                               start=5)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
        groups = -(-40 // group)
        for name in ("dfa_block_fns", "dfa_fn_combine"):
            assert hopper_dfa.LAUNCHES[name] == before[name] + groups


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


def hub_nfa(rng, n_states, n_edges, hub_edges, n_bytes):
    """A random NFA whose start state has ``hub_edges`` more successors, as
    the start state of the Snort-corpus NFA has: rows far wider than a CTA."""
    aut = random_nfa(rng, n_states, n_edges, n_states // 10, n_bytes)
    src = np.concatenate([np.zeros(hub_edges, np.int64),
                          np.repeat(np.arange(n_states), np.diff(aut.offsets))])
    order = np.argsort(src, kind="stable")
    chars = np.concatenate([rng.integers(0, n_bytes, size=hub_edges),
                            aut.trans_char])[order]
    tgts = np.concatenate([rng.integers(1, n_states, size=hub_edges),
                           aut.trans_target])[order]
    return CsrAutomaton(
        offsets=np.searchsorted(src[order], np.arange(n_states + 1)).astype(np.int64),
        trans_char=chars.astype(np.uint8), trans_target=tgts.astype(np.int32))


def hub_case(n_states, n_edges, hub_edges, n_bytes):
    def make(rng):
        aut = hub_nfa(rng, n_states, n_edges, hub_edges, n_bytes)
        return aut, rng.integers(0, n_bytes, size=5000).astype(np.uint8)
    return make


def all_active_case(n_states, n_bytes):
    """A random NFA in which every state also loops to itself on every byte:
    from the start every state is active on every byte, so K5's word list
    holds every word."""
    def make(rng):
        aut = random_nfa(rng, n_states, 3 * n_states, n_states // 10, n_bytes)
        src = np.concatenate([np.repeat(np.arange(n_states), 256),
                              np.repeat(np.arange(n_states), np.diff(aut.offsets))])
        chars = np.concatenate([np.tile(np.arange(256), n_states), aut.trans_char])
        tgts = np.concatenate([np.repeat(np.arange(n_states), 256),
                               aut.trans_target])
        order = np.argsort(src, kind="stable")
        return CsrAutomaton(
            offsets=np.searchsorted(src[order], np.arange(n_states + 1)).astype(np.int64),
            trans_char=chars[order].astype(np.uint8),
            trans_target=tgts[order].astype(np.int32)), \
            rng.integers(0, n_bytes, size=5000).astype(np.uint8)
    return make


def chain_case(n_states, n_bytes, hub_edges):
    """A random NFA whose states but the start state have one or two edges
    over all bytes, and whose start state has ``hub_edges`` more: the
    per-class CSR outgrows shared memory and the edges go to slots."""
    def make(rng):
        src = np.concatenate([np.zeros(hub_edges, np.int64),
                              np.arange(1, n_states),
                              rng.choice(np.arange(1, n_states), n_states // 2)])
        order = np.argsort(src, kind="stable")
        chars = rng.integers(0, n_bytes, size=src.size)[order]
        tgts = rng.integers(0, n_states, size=src.size)[order]
        return CsrAutomaton(
            offsets=np.searchsorted(src[order], np.arange(n_states + 1)).astype(np.int64),
            trans_char=chars.astype(np.uint8), trans_target=tgts.astype(np.int32)), \
            rng.integers(0, n_bytes, size=5000).astype(np.uint8)
    return make


def trie_case(n_patterns, n_bytes):
    """An unanchored literal trie with no shared prefixes, as the Snort-corpus
    NFA is: the start state loops on every byte and starts each pattern's
    chain, so only it reaches its successors (K5's two-step route on the
    listed bitmaps); one-byte patterns make some of them accept."""
    def make(rng):
        src, chars, tgts, nxt = [0] * 256, list(range(256)), [0] * 256, 1
        for _ in range(n_patterns):
            prev = 0
            for _ in range(int(rng.integers(1, 7))):
                src.append(prev)
                chars.append(int(rng.integers(0, n_bytes)))
                tgts.append(nxt)
                prev, nxt = nxt, nxt + 1
        src = np.array(src)
        order = np.argsort(src, kind="stable")
        return CsrAutomaton(
            offsets=np.searchsorted(src[order], np.arange(nxt + 1)).astype(np.int64),
            trans_char=np.array(chars, np.uint8)[order],
            trans_target=np.array(tgts, np.int32)[order]), \
            rng.integers(0, n_bytes, size=5000).astype(np.uint8)
    return make


def snort_case(rng):
    return (snort_corpus_nfa(),
            np.resize(np.frombuffer(b"".join(gen_traffic()[0]), np.uint8), 1 << 20))


TP_NFAS = {  # name -> (automaton, bytes), K5's CSR route
    **NFAS,
    "hub of 3,000 successors": hub_case(4000, 30_000, 3000, 16),
    # one byte value, about 30 successors a state: every row is wide
    "1,500 dense states": random_case(1500, 40_000, 1),
    # on both sides of the register/list boundary: W = 32, 32, 33 words
    "1,023 states": random_case(1023, 4000, 8),
    "1,024 states": random_case(1024, 4000, 8),
    "1,025 states": random_case(1025, 4000, 8),
    "all active, 700 states": all_active_case(700, 4),
    "all active, 1,100 states": all_active_case(1100, 4),
    # the start state's rows of up to 1,266 successors a class; every other
    # state has at most one edge
    "Snort corpus": snort_case,
    # one or two edges a state: edge slots, with either bitmap route
    "1,000-state chains": chain_case(1000, 256, 300),
    "6,000-state chains": chain_case(6000, 20, 2000),
    # only the start state reaches its successors, some of which accept
    "trie of 400 patterns": trie_case(400, 6),
}
# the listed NFAs whose start successors only the start state reaches
TP_START = {"Snort corpus": "two-step", "trie of 400 patterns": "two-step"}
# where K5 keeps the edges of each (4 streams)
TP_EDGES = {**{k: "shared CSR" if v else "global CSR" for k, v in CSR_SMEM.items()},
            "hub of 3,000 successors": "shared CSR",
            "1,500 dense states": "shared CSR", "1,023 states": "shared CSR",
            "1,024 states": "shared CSR", "1,025 states": "shared CSR",
            "all active, 700 states": "shared CSR",
            "all active, 1,100 states": "shared CSR",
            "Snort corpus": "shared slots", "1,000-state chains": "shared slots",
            "6,000-state chains": "shared slots", "trie of 400 patterns": "shared CSR"}


def tp_inputs(rng, aut, data, b, length, cuda):
    """Streams, and start bitmaps and counts that cover S + 1 states and a
    few padding slots, with bits set in the sentinel and padding slots."""
    s = aut.num_states
    n = s + 1 + 5
    starts = rng.integers(0, len(data) - length, size=b)
    streams = np.stack([data[o:o + length] for o in starts])
    bitmap = rng.random((b, n)) < 0.05
    bitmap[:, 0] = True
    counts = rng.integers(0, 1000, size=(b, n)).astype(np.int32)
    return (torch.as_tensor(streams, device=cuda),
            torch.as_tensor(bitmap, device=cuda),
            torch.as_tensor(counts, device=cuda))


@pytest.mark.parametrize("name", list(TP_NFAS))
def test_nfa_tp_scan_matches_plain(cuda, name):
    """Random start bitmaps (sentinel and padding bits among them), start
    counts of any value, and a stream of 0 bytes, which keeps its bitmap."""
    rng = np.random.default_rng(5)
    aut, data = TP_NFAS[name](rng)
    csr = build_nfa_csr(aut, device=cuda)
    route = hopper_nfa.nfa_tp_route(csr, 4)
    assert route["edges"] == TP_EDGES[name]
    assert route["bitmap"] == ("register" if aut.num_states <= 1024 else "listed")
    assert route["start"] == TP_START.get(name, "dense words" if aut.num_states <= 1024
                                          else "pairs")
    assert route["warps_per_cta"] == 1
    length = 1500 if aut.num_states < 10_000 else 400
    for b, ln in ((4, length), (3, 0), (2, 33)):
        streams, bitmap, counts = tp_inputs(rng, aut, data, b, ln, cuda)
        before = hopper_nfa.LAUNCHES["nfa_tp_scan"]
        got = hopper_nfa.nfa_tp_scan(csr, streams, bitmap, counts)
        assert hopper_nfa.LAUNCHES["nfa_tp_scan"] == before + 1
        want = hopper_nfa.nfa_tp_scan_plain(csr, streams, bitmap, counts)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        if ln == 0:
            assert torch.equal(got[1], bitmap) and torch.equal(got[0], counts)


@pytest.mark.parametrize("name", ["l7 corpus", "1,024 states", "1,025 states",
                                  "6,000-state chains", "trie of 400 patterns"])
def test_nfa_tp_scan_many_streams_per_cta(cuda, name):
    """301 streams, more than the card's 132 SMs: several share a CTA (and
    its CSR), and the last CTA is only partly filled; lengths not a
    multiple of 32."""
    rng = np.random.default_rng(301)
    aut, data = TP_NFAS[name](rng)
    csr = build_nfa_csr(aut, device=cuda)
    route = hopper_nfa.nfa_tp_route(csr, 301)
    assert route["warps_per_cta"] > 1 and 301 % route["warps_per_cta"]
    for length in (77, 300):
        streams, bitmap, counts = tp_inputs(rng, aut, data, 301, length, cuda)
        got = hopper_nfa.nfa_tp_scan(csr, streams, bitmap, counts)
        want = hopper_nfa.nfa_tp_scan_plain(csr, streams, bitmap, counts)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_nfa_tp_scan_all_active_counts(cuda):
    """Every state active on every byte: each accepting state counts once a
    byte, and the final bitmap holds every real state."""
    rng = np.random.default_rng(9)
    for name in ("all active, 700 states", "all active, 1,100 states"):
        aut, data = TP_NFAS[name](rng)
        s = aut.num_states
        csr = build_nfa_csr(aut, device=cuda)
        streams = torch.as_tensor(np.stack([data[:999], data[1000:1999]]),
                                  device=cuda)
        bitmap = torch.ones((2, s + 1), dtype=torch.bool, device=cuda)
        counts = torch.zeros((2, s + 1), dtype=torch.int32, device=cuda)
        got = hopper_nfa.nfa_tp_scan(csr, streams, bitmap, counts)
        want_counts = torch.zeros_like(counts)
        want_counts[:, :s] = 999 * csr.accept[:s].to(torch.int32)
        assert torch.equal(got[0], want_counts)
        assert bool(got[1][:, :s].all()) and not bool(got[1][:, s].any())


@pytest.mark.parametrize("name", ["l7 corpus", "hub of 3,000 successors",
                                  "1,023 states", "1,025 states",
                                  "all active, 1,100 states", "Snort corpus",
                                  "1,000-state chains", "trie of 400 patterns"])
def test_nfa_tp_scan_resumes(cuda, name):
    """Two chunks in a row, the second from the first's carries, equal one
    unbroken run; on l7 the counts equal K4's at bound 128."""
    rng = np.random.default_rng(8)
    aut, data = TP_NFAS[name](rng)
    s = aut.num_states
    csr = build_nfa_csr(aut, device=cuda)
    streams = torch.as_tensor(np.stack([data[o:o + 3000] for o in (0, 900)]),
                              device=cuda)
    bitmap = torch.zeros((2, s + 1), dtype=torch.bool, device=cuda)
    bitmap[:, 0] = True
    counts = torch.zeros((2, s + 1), dtype=torch.int32, device=cuda)
    whole = hopper_nfa.nfa_tp_scan(csr, streams, bitmap, counts)
    c1, b1 = hopper_nfa.nfa_tp_scan(csr, streams[:, :1234], bitmap, counts)
    two = hopper_nfa.nfa_tp_scan(csr, streams[:, 1234:].contiguous(), b1, c1)
    for g, w in zip(two, whole):
        assert torch.equal(g, w)
    if name == "l7 corpus":
        flat = streams.reshape(-1)
        k4 = hopper_nfa.nfa_active_scan(
            csr, flat, [0, 3000], [3000, 3000], initial_active(s, 128, 2, cuda),
            torch.zeros((2, s + 1), dtype=torch.int32, device=cuda))
        assert not bool(k4[2].any())
        assert torch.equal(whole[0][:, :s], k4[0][:, :s])


@pytest.mark.parametrize("name", list(TP_NFAS))
def test_nfa_tp_step_matches_plain(cuda, name):
    """K5's sharded step, a launch a byte: on every state it equals the
    one-launch K5; on each half of the states of an S_pad rounded up to
    two ranks (no sum over ranks) it equals the plain step on that half,
    the sentinel and padding bits of the start bitmap among them."""
    rng = np.random.default_rng(6)
    aut, data = TP_NFAS[name](rng)
    s = aut.num_states
    csr = build_nfa_csr(aut, device=cuda)
    streams, bitmap, counts = tp_inputs(rng, aut, data, 3, 200, cuda)
    n_all = bitmap.shape[1]
    before = hopper_nfa.LAUNCHES["nfa_tp_step"]
    got = hopper_nfa.nfa_tp_scan_sharded(csr, streams, bitmap, counts, 0, n_all)
    assert hopper_nfa.LAUNCHES["nfa_tp_step"] == before + 200
    whole = hopper_nfa.nfa_tp_scan(csr, streams, bitmap, counts)
    for g, w in zip(got, whole):
        assert torch.equal(g, w)
    s_pad = -(-(s + 1) // 2) * 2
    half = s_pad // 2
    for lo in (0, half):
        cols = slice(lo, lo + half)
        bm = torch.zeros((3, half), dtype=torch.bool, device=cuda)
        cnt = torch.zeros((3, half), dtype=torch.int32, device=cuda)
        width = min(half, n_all - lo)
        bm[:, :width], cnt[:, :width] = bitmap[:, cols], counts[:, cols]
        got = hopper_nfa.nfa_tp_scan_sharded(csr, streams, bm, cnt, lo, s_pad)
        want = hopper_nfa.nfa_tp_scan_plain(csr, streams, bm, cnt, lo, s_pad)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
