"""The readers of the program's spans (``benchmark/spans.py`` and the four
metrics on it) on synthetic event lists."""

import dataclasses

import numpy as np
import pytest

from benchmark import cells
from benchmark import spans as S
from benchmark import trace as T

E = T.Event
U = "user_annotation"
READERS = ["api.idle_ms_per_call", "engine.idle_ms_per_call",
           "engine.control_waits_per_call", "engine.passes_per_chunk"]


def read(name, tr):
    return cells.metric_reader(name)(tr)


def _trace(events, calls=2):
    return T.Trace(events, 0.0, 1000.0, calls, 10**6, 16)


# two calls, microseconds: a count over a K3 chunk and a K2 tail, then a
# presplit over a K1 chunk and its positions. Each device event starts the
# instant its launch does: the two clocks agree here
WINDOW = [
    E("bench.window", U, 0.0, 1000.0),
    E("api.TokenizerMatcher.count", U, 0.0, 400.0),
    E("rf.api.count", U, 0.0, 400.0),
    E("rf.engine.kgram", U, 20.0, 230.0),           # 20-250
    E("rf.device.upload", U, 30.0, 40.0),           # 30-70
    E("cudaMemcpyAsync", "cuda_runtime", 40.0, 5.0),
    E("cudaStreamSynchronize", "cuda_runtime", 45.0, 20.0),  # the upload's
    E("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 40.0, 100.0),  # 40-140
    E("rf.engine.pass", U, 150.0, 60.0),            # 150-210
    E("cudaLaunchKernel", "cuda_runtime", 160.0, 4.0),
    E("kgram_chain_bytes", "kernel", 160.0, 20.0),  # 160-180
    E("cudaStreamSynchronize", "cuda_runtime", 185.0, 20.0),  # convergence
    E("rf.device.readback", U, 220.0, 20.0),        # 220-240
    E("cudaMemcpyAsync", "cuda_runtime", 228.0, 1.0),
    E("cudaStreamSynchronize", "cuda_runtime", 229.0, 10.0),  # the total
    E("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 228.0, 2.0),  # 228-230
    E("rf.engine.k1", U, 260.0, 120.0),             # 260-380
    E("rf.engine.pass", U, 280.0, 30.0),            # 280-310
    E("cudaLaunchKernel", "cuda_runtime", 285.0, 4.0),
    E("dfa_chain_counts", "kernel", 285.0, 10.0),   # 285-295
    E("rf.engine.pass", U, 320.0, 30.0),            # 320-350: a Jacobi round
    E("cudaStreamSynchronize", "cuda_runtime", 390.0, 5.0),  # in the API alone
    E("api.TokenizerMatcher.presplit", U, 500.0, 400.0),
    E("rf.api.presplit", U, 500.0, 400.0),
    E("rf.engine.k1", U, 520.0, 100.0),             # 520-620
    E("rf.engine.pass", U, 540.0, 40.0),            # 540-580
    E("cuLaunchKernel", "cuda_driver", 545.0, 4.0),
    E("dfa_chain_kernel", "kernel", 545.0, 15.0),   # 545-560
    E("rf.engine.positions", U, 640.0, 60.0),       # 640-700
    E("cudaStreamSynchronize", "cuda_runtime", 650.0, 40.0),  # the count
    E("rf.device.readback", U, 720.0, 40.0),        # 720-760
    E("cudaMemcpyAsync", "cuda_runtime", 730.0, 25.0),
    E("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 730.0, 10.0),  # 730-740
    E("cudaStreamSynchronize", "cuda_runtime", 950.0, 5.0),  # outside a call
]


def test_innermost_span_gives_each_span_its_self_intervals():
    tl = S.innermost(S.program(_trace(WINDOW)), 0.0, 1000.0)
    assert tl[:4] == [(0.0, 20.0, "rf.api.count"), (20.0, 30.0, "rf.engine.kgram"),
                      (30.0, 70.0, "rf.device.upload"), (70.0, 150.0, "rf.engine.kgram")]
    self_us = {}
    for a, b, name in tl:
        self_us[name] = self_us.get(name, 0.0) + b - a
    assert self_us["rf.api.count"] == pytest.approx(400 - 230 - 120)
    assert self_us["rf.api.presplit"] == pytest.approx(400 - 100 - 60 - 40)
    assert self_us["rf.engine.pass"] == pytest.approx(60 + 30 + 30 + 40)
    # stretches under no program span (between and after the calls) are out
    assert sum(b - a for a, b, _ in tl) == pytest.approx(800.0)


def test_innermost_cuts_at_the_window():
    tl = S.innermost(S.program(_trace(WINDOW)), 100.0, 300.0)
    assert tl[0] == (100.0, 150.0, "rf.engine.kgram")
    assert tl[-1] == (280.0, 300.0, "rf.engine.pass")


def test_idle_is_cut_exactly_at_nested_spans():
    idle = S.idle_by_span(_trace(WINDOW))
    # busy: 40-140, 160-180, 228-230, 285-295, 545-560, 730-740
    assert idle["rf.api.count"] == pytest.approx(20 + 10 + 20)  # 0-20, 250-260, 380-400
    assert idle["rf.device.upload"] == pytest.approx(10)        # 30-40
    # 20-30, 140-150 (70-140 is the copy's), 210-220, 240-250
    assert idle["rf.engine.kgram"] == pytest.approx(10 + 10 + 10 + 10)
    assert idle["rf.engine.pass"] == pytest.approx(
        (10 + 30) + (5 + 15) + 30 + (5 + 20))
    assert idle["rf.engine.k1"] == pytest.approx((20 + 10 + 30) + (20 + 40))
    assert idle["rf.device.readback"] == pytest.approx(18 + 30)
    assert idle["rf.engine.positions"] == pytest.approx(60)
    # only program time counts: 400-500 and 900-1000 are left out
    assert sum(idle.values()) == pytest.approx(800 - 100 - 20 - 2 - 10 - 15 - 10)


def test_idle_readers_split_api_and_engines():
    tr = _trace(WINDOW)
    api_us = 50 + (20 + 20 + 20 + 140)  # presplit: 500-520, 620-640, 700-720, 760-900
    engine_us = 40 + 115 + 120 + 60  # kgram, the passes, k1, positions
    assert read("api.idle_ms_per_call", tr) == pytest.approx(api_us * 1e-3 / 2)
    assert read("engine.idle_ms_per_call", tr) == pytest.approx(engine_us * 1e-3 / 2)


def test_control_waits_leave_out_the_copies_and_time_outside_calls():
    # in calls: 45 (upload), 185, 226 (readback), 390, 650; 950 is outside
    assert read("engine.control_waits_per_call", _trace(WINDOW)) == pytest.approx(3 / 2)


def test_passes_per_chunk():
    # 4 passes over 3 chunks: the k1 chunk of the count took a Jacobi round
    assert read("engine.passes_per_chunk", _trace(WINDOW)) == pytest.approx(4 / 3)
    # a pass outside any chunk span (a batch scan) is not a chunk's
    stray = WINDOW + [E("rf.engine.pass", U, 910.0, 5.0)]
    assert read("engine.passes_per_chunk", _trace(stray)) == pytest.approx(4 / 3)


@pytest.mark.parametrize("name", READERS)
def test_no_program_span_reads_nothing(name):
    """The parent of these spans reads null, not 0."""
    bare = [e for e in WINDOW if not e.name.startswith("rf.")]
    assert read(name, _trace(bare)) is None


def _brute_idle(events, t1):
    """Per microsecond of integer bounds: the innermost program span over
    an idle microsecond, by the shortest span open there."""
    out = {}
    for t in range(int(t1)):
        mid = t + 0.5
        if any(e.cat in T.DEVICE_CATS and e.ts <= mid < e.end for e in events):
            continue
        open_ = [e for e in events if e.name.startswith("rf.") and e.ts <= mid < e.end]
        if open_:
            name = min(open_, key=lambda e: e.dur).name
            out[name] = out.get(name, 0.0) + 1.0
    return out


def _nested(rng, a, b, depth, out):
    """Random properly nested spans with integer bounds inside [a, b)."""
    t = a
    while t < b - 2 and depth < 4:
        s = int(rng.integers(t, b - 1))
        e = int(rng.integers(s + 1, b))
        out.append(E(f"rf.l{depth}.{len(out) % 3}", U, float(s), float(e - s)))
        _nested(rng, s, e, depth + 1, out)
        t = e + int(rng.integers(0, 5))


@pytest.mark.parametrize("seed", range(6))
def test_idle_by_span_against_a_walk_per_microsecond(seed):
    rng = np.random.default_rng(seed)
    events = [E("bench.window", U, 0.0, 300.0)]
    _nested(rng, 0, 300, 0, events)
    for _ in range(12):
        s = int(rng.integers(0, 300))
        events.append(E("k", "kernel", float(s), float(rng.integers(1, 20))))
        events.append(E("cudaLaunchKernel", "cuda_runtime", float(s), 0.0))
    got = S.idle_by_span(T.Trace(events, 0.0, 300.0, 1, 1, 1))
    want = _brute_idle(events, 300)
    assert set(got) == set(want)
    for name in want:
        assert got[name] == pytest.approx(want[name])


def _device_clock(events, clock):
    """The events with every device event read on ``clock``, a function
    of the host's time."""
    return [dataclasses.replace(e, ts=clock(e.ts), dur=clock(e.end) - clock(e.ts))
            if e.cat in T.DEVICE_CATS else e for e in events]


@pytest.mark.parametrize("shift", [5000.0, -3000.0, 0.25])
def test_idle_split_does_not_move_with_the_device_clock(shift):
    """The profiler's device clock may sit any distance off the host's:
    each idle interval is placed by the launch of the work that ends it."""
    want = S.idle_by_span(_trace(WINDOW))
    got = S.idle_by_span(_trace(_device_clock(WINDOW, lambda t: t + shift)))
    assert set(got) == set(want)
    for name in want:
        assert got[name] == pytest.approx(want[name])


def test_each_idle_interval_ends_where_its_launch_begins():
    """A device clock that runs 5 ms early and 2% fast: each
    idle interval keeps its device-clock length and ends at the start of
    the call that enqueued the work ending it; the last keeps the shift
    of the one before it."""
    host = [E("cudaMemcpyAsync", "cuda_runtime", 100.0, 10.0),
            E("cudaLaunchKernel", "cuda_runtime", 150.0, 5.0),
            E("cudaLaunchKernel", "cuda_runtime", 155.0, 5.0),  # queued
            E("cudaMemsetAsync", "cuda_runtime", 400.0, 5.0)]
    true = [E("Memcpy HtoD", "gpu_memcpy", 103.0, 40.0),   # 103-143
            E("k1", "kernel", 153.0, 30.0),                  # 153-183
            E("k2", "kernel", 183.0, 20.0),                  # 183-203
            E("Memset", "gpu_memset", 402.0, 8.0)]           # 402-410
    dev = _device_clock(true, lambda t: t - 5000.0 + 0.02 * t)
    idle = S.idle_on_host(_trace(host + dev))
    # device gaps: before 103; 143-153, read 10.2 long; 203-402, 202.98
    assert idle[0] == (float("-inf"), 100.0)
    assert idle[1] == (pytest.approx(150.0 - 10.2), 150.0)
    assert idle[2] == (pytest.approx(400.0 - 202.98), 400.0)
    assert idle[3][0] == pytest.approx(400.0 + 8.16)  # after the memset
    assert idle[3][1] == float("inf")


def test_enqueued_pairs_each_kind_in_order():
    """A driver call inside a runtime call is one launch."""
    host = [E("cudaLaunchKernel", "cuda_runtime", 10.0, 6.0),
            E("cuLaunchKernel", "cuda_driver", 11.0, 3.0),  # the same launch
            E("cudaMemcpyAsync", "cuda_runtime", 20.0, 4.0),
            E("cuLaunchKernelEx", "cuda_driver", 30.0, 4.0),
            E("cudaStreamSynchronize", "cuda_runtime", 40.0, 30.0)]
    dev = [E("a", "kernel", 1012.0, 5.0), E("copy", "gpu_memcpy", 1025.0, 9.0),
           E("b", "kernel", 1034.0, 5.0)]
    pairs, unknown_to = S.enqueued(_trace(host + dev))
    assert [(d.name, c.name) for d, c in pairs] == [
        ("a", "cudaLaunchKernel"), ("copy", "cudaMemcpyAsync"),
        ("b", "cuLaunchKernelEx")]
    assert unknown_to == float("-inf")
    assert S.enqueued(_trace(host + dev + [E("c", "kernel", 1050.0, 1.0)])) is None
    assert S.enqueued(_trace(host)) is None


def test_records_lost_at_the_start_pair_from_the_end():
    """The profiler lost the first kernel's record: the kernels pair from
    the last back, and the card's state up to the launch left over is
    unknown, so no idle time is placed before it ends."""
    host = [E("cudaLaunchKernel", "cuda_runtime", 10.0, 6.0),   # lost
            E("cudaMemcpyAsync", "cuda_runtime", 20.0, 4.0),
            E("cudaLaunchKernel", "cuda_runtime", 30.0, 4.0),
            E("cudaLaunchKernel", "cuda_runtime", 60.0, 4.0)]
    dev = [E("copy", "gpu_memcpy", 20.0, 5.0), E("b", "kernel", 30.0, 10.0),
           E("c", "kernel", 60.0, 5.0)]
    tr = _trace(host + dev)
    pairs, unknown_to = S.enqueued(tr)
    assert [(d.name, c.ts) for d, c in pairs] == [("copy", 20.0), ("b", 30.0),
                                                   ("c", 60.0)]
    assert unknown_to == 16.0
    assert S.idle_on_host(tr) == [(16.0, 20.0), (25.0, 30.0), (40.0, 60.0),
                                  (65.0, float("inf"))]


def test_waits_are_the_host_waits_readers():
    waits = cells._module(cells.HERE / "metrics" / "api.host_waits_per_call.py",
                          "test_spans_waits").WAITS
    assert S.WAITS == waits


def test_inside_needs_the_whole_event():
    spans = [E("s", U, 10.0, 10.0), E("s", U, 30.0, 10.0)]
    evs = [E("w", "cuda_runtime", 12.0, 3.0), E("w", "cuda_runtime", 18.0, 5.0),
           E("w", "cuda_runtime", 5.0, 1.0), E("w", "cuda_runtime", 39.0, 1.0)]
    assert S.inside(evs, spans) == [True, False, False, True]
