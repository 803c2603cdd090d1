"""The port's profiling helpers (regex_fpga_tpu_torch.utils.profiling, on
torch.profiler), mirroring tests/test_profiling.py for the JAX package."""

import json
import os

import numpy as np
import torch

from regex_fpga_tpu_torch.utils.metrics import RunMetrics, Timer
from regex_fpga_tpu_torch.utils.profiling import (profile_to, throughput_probe,
                                                  trace)


def test_throughput_probe():
    with throughput_probe(1000) as p:
        x = torch.arange(10) * 2
    bps = p.stop(force_result=x)
    assert bps > 0 and p.bytes_per_second == bps
    with throughput_probe(10) as q:
        np.arange(10)
    assert q.seconds >= 0 and q.bytes_per_second > 0


def test_trace_and_profile_to(tmp_path):
    with profile_to(str(tmp_path / "prof")):
        with trace("scan-step"):
            (torch.arange(8) * 2).sum()
    path = tmp_path / "prof" / "trace.json"
    assert path.exists() and os.path.getsize(path) > 0
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "scan-step" for e in events)


def test_trace_outside_a_profile():
    with trace("no-profiler"):
        x = torch.ones(3).sum()
    assert float(x) == 3.0


def test_run_metrics_json():
    m = RunMetrics(engine="x", bytes_scanned=10, streams=1, matches=2,
                   wall_seconds=0.5)
    d = json.loads(m.to_json()) if hasattr(m, "to_json") else m.__dict__
    assert d["engine"] == "x" and d["matches"] == 2


def test_timer():
    with Timer() as t:
        sum(range(1000))
    assert t.seconds >= 0
