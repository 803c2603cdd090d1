"""The block-count rule of the port's DFA engines: every chunk runs on the
full lane count of ``shrink_blocks(w, num_blocks, min_block_bytes,
divisible=False)``, padded at the front with the stall class where the lanes
do not divide its length. The JAX package runs such a chunk on its largest
power-of-two divisor of lanes instead.

Every count, total, position, span, ``presplit`` boundary and final state is
held to the JAX package bit for bit on the CPU (the kernels' plain
versions), at odd, prime, 2 x prime and chunk-boundary +- 1 lengths, on
small configs (64 lanes, 8 KiB chunks). ``iterations`` is held to JAX's own
``dfa_scan_fast`` over the same padded class ids with JAX's
``stall_extend`` tables. The lane test needs no JAX: it records the lanes
each engine call gets at full size and stops the call there."""

import numpy as np
import pytest

from regex_fpga_tpu import api as japi
from regex_fpga_tpu.ops.dfa_fast import dfa_scan_fast as jax_scan_fast
from regex_fpga_tpu.ops.tables import stall_extend as jax_stall_extend
from regex_fpga_tpu.utils.config import EngineConfig
from regex_fpga_tpu_torch import api as tapi
from regex_fpga_tpu_torch.models import CompiledDfa
from regex_fpga_tpu_torch.utils.config import shrink_blocks

import jax.numpy as jnp

from conftest import random_dfa_table

CB = 1 << 13
SMALL = EngineConfig(scan_backend="device", num_blocks=64, chunk_bytes=CB)
# 997 and 4099 are prime; 1994 = 2 x 997; the rest sit on chunk boundaries
LENGTHS = [997, 1994, 4099, CB - 1, CB + 1, 2 * CB + 1]
FRAG = (b"The quick brown fox jumps over 1234 lazy dogs, it's 99.5% fine!  "
        b"pre-split   benchmark text \xc3\xa9t\xc3\xa9 2026... ")
TEXT = np.frombuffer(FRAG * 300, np.uint8)
PATTERN = rb"[a-z]+[0-9]|\d+\.\d+|\s\s"


def tokenizers(config=SMALL):
    return (japi.compile_tokenizer(config=config),
            tapi.compile_tokenizer(config=config, device="cpu"))


def regexes(pattern=PATTERN, config=SMALL):
    return (japi.compile_regex(pattern, config=config),
            tapi.compile_regex(pattern, config=config, device="cpu"))


def dfas(dfa, config=SMALL):
    return (japi.DfaMatcher(dfa, config),
            tapi.DfaMatcher(dfa, config, device="cpu"))


def accepting_dfa(seed: int, n_states: int = 12) -> CompiledDfa:
    """A random DFA whose start state accepts and about half of the others
    too, with no dead state: chunks start and end in accepting states, so
    the pad correction and the end-of-stream match both matter."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, n_states, size=(256, n_states)).astype(np.int32)
    accept = rng.random(n_states) < 0.5
    accept[0] = True
    return CompiledDfa(table=table, accept=accept, start=0, dead=-1)


def parity_dfa() -> CompiledDfa:
    """Every byte flips the state: it never synchronizes."""
    table = np.zeros((256, 2), dtype=np.int32)
    table[:, 0] = 1
    return CompiledDfa(table=table, accept=np.array([False, True]), start=0,
                       dead=-1)


def jax_padded_run(jm, stream: np.ndarray, config=SMALL):
    """(iterations, converged) of JAX's dfa_scan_fast over the port's
    padded chunks of ``stream``: each chunk's class ids at
    shrink_blocks(..., divisible=False) lanes, with ``lead`` stall ids in
    front where the lanes do not divide its length, over JAX's
    stall-extended tables; each chunk from the previous one's final state
    (the exact fallback's where JAX's scan does not converge)."""
    stall = jax_stall_extend(jm.tables)
    classes = jm._class_lut[stream].astype(np.int32)
    iters, converged, cur = 0, True, jm.start
    for off in range(0, len(stream), config.chunk_bytes):
        cls = classes[off:off + config.chunk_bytes]
        nb = shrink_blocks(len(cls), config.num_blocks,
                           config.min_block_bytes, divisible=False)
        lead = -len(cls) % nb
        ids = np.concatenate([np.full(lead, jm.tables.num_classes, np.int32),
                              cls])
        res = jax_scan_fast(stall if lead else jm.tables, jnp.asarray(ids),
                            num_blocks=nb, start=cur,
                            max_iters=config.max_iters, emit="counts")
        if bool(res.converged):
            cur = int(res.final_state)
            iters = max(iters, int(res.iterations))
        else:
            converged = False
            cur = int(jm._exact_fallback(
                stream[off:off + config.chunk_bytes], cur).final_state)
    return iters, converged


def assert_counts_equal(got, want):
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.total == want.total
    assert (got.match_positions is None) == (want.match_positions is None)
    if want.match_positions is not None:
        for g, w in zip(got.match_positions, want.match_positions):
            np.testing.assert_array_equal(g, w)


def stream_of(n: int, seed: int = 0) -> np.ndarray:
    return np.resize(TEXT[seed % 100:], n)


@pytest.mark.parametrize("who", ["tokenizer", "regex"])
@pytest.mark.parametrize("n", LENGTHS)
def test_scan_matches_jax(who, n):
    """Single-stream counts and positions, the final state, and
    ``iterations``/``converged`` against JAX over the padded ids."""
    jm, tm = tokenizers() if who == "tokenizer" else regexes()
    data = stream_of(n, n)
    got, want = tm.scan(data), jm.scan(data)
    assert_counts_equal(got, want)
    assert tm._last_final == jm._last_final
    assert (got.metrics.iterations, got.metrics.converged) == \
        jax_padded_run(jm, data)
    assert_counts_equal(tm.scan(data, collect_positions=True),
                        jm.scan(data, collect_positions=True))
    assert tm._last_final == jm._last_final


@pytest.mark.parametrize("n", LENGTHS)
def test_spans_and_presplit_match_jax(n):
    """finditer and finditer_arrays (the reversed mask pass and the states
    pass), and the tokenizer's presplit (the forward mask pass)."""
    jm, tm = regexes()
    data = stream_of(n, 7).tobytes()
    np.testing.assert_array_equal(tm.finditer_arrays(data),
                                  jm.finditer_arrays(data))
    assert tm.finditer(data) == jm.finditer(data)
    jt, tt = tokenizers()
    np.testing.assert_array_equal(tt.presplit(data), jt.presplit(data))


@pytest.mark.parametrize("n", [1, 3, 5, *LENGTHS])
def test_count_matches_jax(n):
    """count(): K3 over the longest prefix of whole steps that the full lane
    count divides, then the padded k=1 counts engine from its carry."""
    jm, tm = tokenizers()
    data = stream_of(n, 3)
    assert tm.count(data) == jm.count(data) == tm.scan(data).total


@pytest.mark.parametrize("width", [997, CB + 1])
def test_equal_row_batch_matches_jax(width):
    """An equal-row batch of odd width: each row padded at its front, the
    pad correction at each row's own entry state."""
    jm, tm = dfas(accepting_dfa(1))
    rng = np.random.default_rng(width)
    batch = rng.integers(0, 256, size=(5, width)).astype(np.uint8)
    got, want = tm.scan(batch), jm.scan(batch)
    assert want.metrics.engine == got.metrics.engine == "dfa-fast-batch"
    assert_counts_equal(got, want)


def test_stream_scanner_in_odd_pieces_matches_jax():
    jm, tm = regexes()
    data = stream_of(3 * CB + 5, 11)
    js, ts = jm.stream_scanner(), tm.stream_scanner()
    at = 0
    for piece in (1, 997, CB + 1, 3, 4099, CB - 1):
        ts.feed(data[at:at + piece])
        js.feed(data[at:at + piece])
        at += piece
        assert ts.state == js.state
        np.testing.assert_array_equal(ts.counts, js.counts)
    assert ts.total == js.total == tm.scan(data[:at]).total


@pytest.mark.parametrize("include_final_match", [True, False])
@pytest.mark.parametrize("n", [997, CB + 1, 2 * CB + 1])
def test_accepting_entry_and_final_states_match_jax(include_final_match, n):
    """The pad steps sit in the chunk's entry state, which accepts here at
    every chunk: counts, positions, count() and the end-of-stream match."""
    jm, tm = dfas(accepting_dfa(2))
    jm.include_final_match = tm.include_final_match = include_final_match
    rng = np.random.default_rng(n)
    data = rng.integers(0, 256, size=n).astype(np.uint8)
    assert tm.tables.accept[tm.start]
    for collect in (False, True):
        assert_counts_equal(tm.scan(data, collect_positions=collect),
                            jm.scan(data, collect_positions=collect))
    assert bool(tm._accept_eof[tm._last_final])
    assert tm.count(data) == jm.count(data)


@pytest.mark.parametrize("n", [997, CB + 1])
def test_256_classes_match_jax(n):
    """C = 256: the stall id is 256, so padded chunks take int16 ids."""
    rng = np.random.default_rng(4)
    table, accept = random_dfa_table(rng, 40, 3)
    dfa = CompiledDfa(table=table, accept=accept, start=0, dead=39)
    jm, tm = dfas(dfa)
    assert tm.tables.num_classes == 256
    data = rng.integers(0, 256, size=n).astype(np.uint8)
    for collect in (False, True):
        assert_counts_equal(tm.scan(data, collect_positions=collect),
                            jm.scan(data, collect_positions=collect))
    assert tm.count(data) == jm.count(data)
    _, ids, nb, lead, class_of = tm._chunk_ids(tm._upload(data[:997]))
    assert (ids.dtype, nb, lead, class_of) == (tapi.torch.int16, 8, 3, None)


def test_parity_falls_back_exactly_where_jax_runs_one_lane():
    """At an odd length JAX runs the parity automaton on one lane, which is
    trivially converged; the port runs 64 padded lanes, which never
    converge, and takes the exact fallback on the unpadded bytes. The
    counts are the same; ``converged`` differs (a deliberate difference)."""
    jm, tm = dfas(parity_dfa())
    data = np.random.default_rng(5).integers(0, 256, size=CB - 1)
    data = data.astype(np.uint8)
    got, want = tm.scan(data), jm.scan(data)
    assert_counts_equal(got, want)
    assert tm._last_final == jm._last_final
    assert want.metrics.converged and not got.metrics.converged
    assert got.metrics.converged == jax_padded_run(jm, data)[1]
    assert tm.count(data) == jm.count(data) == got.total


def test_front_padding_keeps_the_speculation():
    """1,023 stall ids before 4,097 bytes at 1,024 lanes of 5 steps: about
    200 lanes are pad only. Each guesses the chunk's entry state, which is
    right, so an automaton that synchronizes in one byte still converges
    on the speculation pass (at the back they would guess the entry state
    where the end state holds). JAX over the same padded ids agrees."""
    cfg = EngineConfig(scan_backend="device", num_blocks=1024,
                       min_block_bytes=4, chunk_bytes=CB)
    jm, tm = regexes(rb"[0-9]", cfg)
    data = np.concatenate([stream_of(4096, 9), np.frombuffer(b"7", np.uint8)])
    _, ids, nb, lead, _ = tm._chunk_ids(tm._upload(data))
    assert (nb, lead, ids.shape[0]) == (1024, 1023, 5120)
    got, want = tm.scan(data), jm.scan(data)
    assert_counts_equal(got, want)
    assert tm._last_final != tm.start  # the end state differs from the entry
    assert (got.metrics.iterations, got.metrics.converged) == (1, True)
    assert jax_padded_run(jm, data, cfg) == (1, True)


def test_lane_divisible_chunk_takes_the_unpadded_route():
    """A chunk whose length the lanes divide: the matcher's own tables,
    the raw bytes with the byte map for the kernels to map them, no stall
    tables built, iterations as JAX reports them."""
    jm, tm = tokenizers()
    data = stream_of(2 * CB, 1)
    raw = tm._upload(data[:CB])
    tables, ids, nb, lead, class_of = tm._chunk_ids(raw)
    assert (tables is tm.tables, ids is raw, class_of is tm._class_lut, nb, lead) == \
        (True, True, True, 64, 0)
    got, want = tm.scan(data), jm.scan(data)
    assert_counts_equal(got, want)
    assert (got.metrics.iterations, got.metrics.converged) == \
        (want.metrics.iterations, want.metrics.converged)
    assert tm.count(data) == jm.count(data)
    assert tm._stall_tables is None


# ------------------------------------------------------------ the lanes


class _Stop(Exception):
    """Raised by the recording engines: no plain scan runs at full size."""


MIB = 1 << 20
FULL = EngineConfig(scan_backend="device")  # 64 MiB chunks, 65,536 lanes
PATHS = {
    "counts": lambda m, s: m.scan(s),
    "mask": lambda m, s: m._scan_match_positions(s),
    "states": lambda m, s: m._scan_match_states(s),
    "batch": lambda m, s: m.scan(np.stack([s, s])),
    "count": lambda m, s: m.count(s),
}


@pytest.fixture
def engine_calls(monkeypatch):
    """Replaces the engines that api calls with recorders of (engine,
    tables, class ids or text, lanes) that stop the call."""
    calls = []

    def recorder(name):
        def record(tables, ids, num_blocks, **_):
            calls.append((name, tables, ids, num_blocks))
            raise _Stop
        return record

    for name in ("dfa_scan_fast", "dfa_scan_fast_multi", "dfa_scan_kgram"):
        monkeypatch.setattr(tapi, name, recorder(name))
    return calls


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("n, lanes, steps_lanes", [
    (64 * MIB - 1, 65536, 65536),  # one lane under the old rule
    (1_383_198, 16384, 4096),      # two lanes under the old rule
])
def test_odd_lengths_run_on_the_full_lane_count(engine_calls, path, n, lanes,
                                                steps_lanes):
    """Under the default config a chunk of 64 MiB - 1 bytes runs on 65,536
    lanes (the largest power-of-two divisor of its length is 1), and the
    1,383,198-byte Snort payload on 16,384 (2 under the divisor rule), padded
    to a lane multiple; count() runs K3 on the longest whole-step prefix
    that the full lane count of its steps divides."""
    m = tapi.compile_tokenizer(config=FULL, device="cpu")
    stream = np.zeros(n, np.uint8)
    with pytest.raises(_Stop):
        PATHS[path](m, stream)
    (name, tables, ids, nb), = engine_calls
    assert nb == shrink_blocks(n if path != "count" else n // 4, 65536, 64,
                               divisible=False)
    if path == "count":
        assert name == "dfa_scan_kgram" and nb == steps_lanes
        assert ids.shape == ((n // 4 // nb) * nb * 4,)  # raw text, k = 4
        assert n - ids.shape[0] < nb * 4
        return
    assert nb == lanes
    assert ids.shape[-1] == -(-n // nb) * nb
    assert (ids[..., :ids.shape[-1] - n] == m.tables.num_classes).all()
    assert tables is m._stall_tables
    assert name == ("dfa_scan_fast_multi" if path == "batch" else
                    "dfa_scan_fast")


@pytest.mark.parametrize("path", list(PATHS))
def test_power_of_two_chunk_keeps_its_lanes(engine_calls, path):
    """A 64 MiB chunk: 65,536 lanes, unpadded uint8 ids, the matcher's own
    tables, as before the full-lane rule."""
    m = tapi.compile_tokenizer(config=FULL, device="cpu")
    stream = np.zeros(64 * MIB, np.uint8)
    with pytest.raises(_Stop):
        PATHS[path](m, stream)
    (name, tables, ids, nb), = engine_calls
    assert nb == 65536 and ids.shape[-1] == 64 * MIB
    assert ids.dtype == tapi.torch.uint8
    if path != "count":
        assert tables is m.tables and m._stall_tables is None
