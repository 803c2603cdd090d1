"""The ``engine.byte_map_share`` reader on synthetic traces, and its reading
in the cl100k cell on the card."""

import time

import pytest

from benchmark import cells, run
from benchmark import trace as T

CELL = "cl100k-pretok-utf8.shard-count"
SMALL = {"bytes": 1 << 16, "pool": 2}
SEED = 2**31 + 5150
E = T.Event
U = "user_annotation"
READ = cells.metric_reader("engine.byte_map_share")


def _trace(events):
    return T.Trace(events, 0.0, 1000.0, 3, 3 * 67_000_000, 24)


def _chunks(held):
    """``rf.engine.k1`` chunk spans (microseconds), the i-th holding its
    launches inside an ``rf.engine.byte_map`` span where ``held[i]``."""
    events = [E("bench.window", U, 0.0, 1000.0)]
    for i, mapped in enumerate(held):
        t = 10.0 + 200.0 * i
        events += [E("rf.api.count", U, t, 190.0), E("rf.engine.k1", U, t + 5, 180.0),
                   E("rf.engine.pass", U, t + 50, 100.0)]
        if mapped:
            events += [E("rf.engine.byte_map", U, t + 20, 10.0),
                       E("rf.engine.byte_map", U, t + 60, 10.0)]
        events += [E("rf.engine.global_table", U, t + 21, 8.0),
                   E("cudaLaunchKernel", "cuda_runtime", t + 22, 4.0),
                   E("dfa_chain_kernel", "kernel", t + 30, 40.0)]
    return events


@pytest.mark.parametrize("held,share", [((True, True), 1.0), ((True, False), 0.5),
                                        ((False, True, True, True), 0.75)])
def test_byte_map_share_on_a_synthetic_trace(held, share):
    assert READ(_trace(_chunks(held))) == pytest.approx(share)


def test_byte_map_share_reads_nothing_without_a_chunk_on_the_card():
    """No ``rf.engine.k1`` chunk, or none that launched a kernel (the plain
    versions on the CPU): nothing to read. Chunks on the card but no
    ``rf.engine.byte_map`` span (every chunk mapped by the engine, or a
    program that records no such span): 0.0, not a missing metric."""
    no_chunk = [e for e in _chunks((True, True)) if e.name != "rf.engine.k1"]
    assert READ(_trace(no_chunk)) is None
    assert READ(_trace(_chunks(()))) is None
    on_cpu = [e for e in _chunks((True, True)) if e.cat not in ("cuda_runtime", "kernel")]
    assert READ(_trace(on_cpu)) is None
    assert READ(_trace(_chunks((False, False)))) == 0.0


def test_byte_map_share_is_listed_for_its_cells():
    assert "engine.byte_map_share" in {m["name"] for m in cells.load(CELL).per_layer}


@pytest.mark.cuda
def test_byte_map_share_on_the_card(card):
    r = run.run_cell(CELL, SEED, 1.0, True, device=card, t0=time.perf_counter(),
                     overrides=SMALL)
    assert r["correct"]
    assert r["metrics"]["engine.byte_map_share"]["value"] == 1.0
