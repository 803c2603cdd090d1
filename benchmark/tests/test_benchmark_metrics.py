"""The per-layer readers and the trace arithmetic on synthetic event lists."""

import pytest

from benchmark import cells
from benchmark import trace as T

E = T.Event


def _trace(events, calls=4, bytes_in=4 * 10**9, bytes_out=0):
    return T.Trace(events, 0.0, 1000.0, calls, bytes_in, bytes_out)


def read(name, tr):
    return cells.metric_reader(name)(tr)


WINDOW = [
    E("bench.window", "user_annotation", 0.0, 1000.0),
    E("api.X.count", "user_annotation", 0.0, 480.0),
    E("api.X.count", "user_annotation", 500.0, 480.0),
    E("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 10.0, 200.0),
    E("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 510.0, 200.0),
    E("kgram_chain_bytes", "kernel", 250.0, 50.0),
    E("kgram_chain_bytes", "kernel", 280.0, 40.0),   # overlaps the one before
    E("dfa_chain_counts", "kernel", 750.0, 50.0),
    E("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 990.0, 20.0),  # cut at 1000
    E("cudaStreamSynchronize", "cuda_runtime", 300.0, 30.0),
    E("cudaStreamSynchronize", "cuda_runtime", 800.0, 30.0),
    E("cudaMemcpyAsync", "cuda_runtime", 10.0, 5.0),
    E("cudaLaunchKernel", "cuda_runtime", 245.0, 4.0),
    E("aten::sum", "cpu_op", 850.0, 100.0),
    E("cudaStreamSynchronize", "cuda_runtime", 1500.0, 30.0),  # after the window
]


def test_union_and_gaps():
    busy = T.union([E("a", "kernel", 5, 10), E("b", "kernel", 10, 10),
                    E("c", "kernel", 40, 5), E("d", "kernel", -5, 7)], 0, 50)
    assert busy == [(0, 2), (5, 20), (40, 45)]
    assert T.gaps(busy, 0, 50) == [(2, 5), (20, 40), (45, 50)]


def test_busy_and_idle():
    tr = _trace(WINDOW)
    # copies 10-210, 510-710, kernels 250-320, 750-800, copy 990-1000
    busy_us = 200 + 200 + 70 + 50 + 10
    assert tr.busy_s() == pytest.approx(busy_us * 1e-6)
    assert read("device.idle_pct", tr) == pytest.approx(100 * (1 - busy_us / 1000))


def test_counts_per_call():
    tr = _trace(WINDOW)
    assert read("engine.kernels_per_call", tr) == pytest.approx(3 / 4)
    assert read("api.host_waits_per_call", tr) == pytest.approx(2 / 4)


def test_roofline_share():
    tr = _trace(WINDOW, bytes_in=67_000_000, bytes_out=32)
    kernel_s = (50 + 40 + 50) * 1e-6  # summed, overlap and all
    bound = (67_000_000 + 32) / T.HBM_BYTES_PER_S
    assert read("kernels.roofline_pct", tr) == pytest.approx(100 * bound / kernel_s)
    assert T.bound_s(3.35e12, 0) == pytest.approx(1.0)


def test_h2d_per_gigabyte():
    tr = _trace(WINDOW, bytes_in=2 * 10**9)
    assert read("device.h2d_ms_per_GB", tr) == pytest.approx(0.4 / 2)


@pytest.mark.parametrize("name", ["api.host_waits_per_call", "engine.kernels_per_call",
                                  "kernels.roofline_pct", "device.idle_pct",
                                  "device.h2d_ms_per_GB"])
def test_nothing_to_read_gives_nothing(name):
    """A share of a roofline is never 0 for want of events: no reading."""
    empty = _trace([E("bench.window", "user_annotation", 0.0, 1000.0),
                    E("aten::sum", "cpu_op", 5.0, 5.0)])
    assert read(name, empty) is None
    assert read(name, _trace(WINDOW, calls=0, bytes_in=0)) is None or name == "device.idle_pct"


def test_breakdown():
    tr = _trace(WINDOW)
    b = T.breakdown(tr)
    ops = dict(b["device_ops"])
    assert ops["Memcpy HtoD (Pageable -> Device)"] == pytest.approx(400e-6)
    assert ops["kgram_chain_bytes"] == pytest.approx(90e-6)
    assert ops["Memcpy DtoH (Device -> Pageable)"] == pytest.approx(10e-6)
    idle = dict(b["idle_gaps"])
    # the gaps 0-10, 210-250, 320-510 and 710-750 fall in a call span alone,
    # 800-990 in an aten::sum: the innermost host event over the middle names it
    assert idle["aten::sum"] == pytest.approx(190e-6)
    assert idle["api.X.count"] == pytest.approx((10 + 40 + 190 + 40) * 1e-6)
    assert sum(idle.values()) == pytest.approx(1e-3 - tr.busy_s())
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_window_from_the_span():
    assert T.window(WINDOW) == (0.0, 1000.0)
    with pytest.raises(ValueError):
        T.window(WINDOW[1:])


def test_chrome_trace_events():
    doc = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 1.5, "dur": 2.0},
        {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 1.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 3.0},
        {"ph": "M", "name": "process_name"},
    ]}
    assert T.events_from_chrome(doc) == [E("k", "kernel", 1.5, 2.0),
                                          E("aten::add", "cpu_op", 3.0, 0.0)]
