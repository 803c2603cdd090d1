"""A whole run on the CPU (the look for a card skipped, the port on its
plain versions): the result line's shape, the import guard, the controls,
and each fault a cell can have, planted in the port underneath, read as
not correct."""

import json
import os
import shutil
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch
from conftest import ROOT, SMALL

from benchmark import run

SEED = 2**31 + 4242


def _run(workload, **kw):
    return run.run_cell(workload, SEED, 0.3, kw.pop("trace", False), device="cpu",
                        t0=time.perf_counter(), overrides=SMALL[workload], **kw)


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_sound_run_is_correct(workload, capsys):
    r = _run(workload)
    assert r["correct"] and r["failed"] == 0
    run.emit(r)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["metrics"]) >= {"setup_s", "scan_GBps"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert err.strip().splitlines()[-3:] == [
        "wrong_answers 0 limit 0", "failed_calls 0 limit 0",
        f"answers_checked {line['checks']['answers_checked']['value']} at least 1"]


def test_traced_run_reports_the_per_layer_metrics_it_can_read():
    r = _run("gpt2-pretok-bytes.shard-count", trace=True)
    assert r["correct"]
    assert r["device"]["window_s"] > 0 and "busy_s" in r["device"]
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    # no card, no kernels: every device reading is left out, never 0
    assert "kernels.roofline_pct" not in r["metrics"]


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_control_is_not_correct(workload):
    r = _run(workload, system="control")
    assert not r["correct"] and r["checks"]["wrong_answers"]["value"] > 0


def _state_unchanged_kgram(monkeypatch):
    from regex_fpga_tpu_torch import api

    real = api.dfa_scan_kgram

    def step(ta, data, **kw):
        res = real(ta, data, **kw)
        return res._replace(final_state=torch.tensor(kw["start"]), total=torch.tensor(0))
    monkeypatch.setattr(api, "dfa_scan_kgram", step)


def _altered_kgram(monkeypatch):
    from regex_fpga_tpu_torch import api

    real = api.dfa_scan_kgram
    monkeypatch.setattr(api, "dfa_scan_kgram",
                        lambda ta, data, **kw: (lambda r: r._replace(total=r.total + 1))(
                            real(ta, data, **kw)))


def _half_streams(monkeypatch):
    from regex_fpga_tpu_torch import api

    real = api._as_streams
    monkeypatch.setattr(api, "_as_streams",
                        lambda data: [s[: len(s) // 2] for s in real(data)])


def _mask(monkeypatch, change):
    from regex_fpga_tpu_torch.api import DfaMatcher

    real = DfaMatcher._mask_chunk_device

    def masked(self, chunk, cur, reverse=False):
        mask, nxt = real(self, chunk, cur, reverse)
        return change(mask.clone(), cur, nxt)
    monkeypatch.setattr(DfaMatcher, "_mask_chunk_device", masked)


def _flip_one(mask, cur, nxt):
    mask[len(mask) // 2] ^= True
    return mask, nxt


FAULTS = {
    "gpt2-pretok-bytes.shard-count": {
        "state unchanged": _state_unchanged_kgram,
        "half the batch": _half_streams,
        "answer altered": _altered_kgram,
    },
    "gpt2-pretok-bytes.doc-presplit": {
        "state unchanged": lambda mp: _mask(mp, lambda m, cur, nxt: (m & False, cur)),
        "half the batch": _half_streams,
        "answer altered": lambda mp: _mask(mp, _flip_one),
    },
}


@pytest.mark.parametrize("workload,fault", [(w, f) for w in FAULTS for f in FAULTS[w]])
def test_fault_in_the_port_is_not_correct(workload, fault, monkeypatch):
    FAULTS[workload][fault](monkeypatch)
    r = _run(workload)
    assert not r["correct"], (workload, fault, r["checks"])


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("regex_fpga_tpu_torch.api", "jaxtyping", "flaxen", "jaxlib_x"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "regex_fpga_tpu.ops", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run.forbidden_modules() == ["jax", "regex_fpga_tpu"]


def test_run_refuses_when_jax_is_loaded(monkeypatch):
    monkeypatch.setitem(sys.modules, "flax", types.ModuleType("flax"))
    with pytest.raises(SystemExit, match="flax"):
        _run("gpt2-pretok-bytes.shard-count")


def _loads(request, name):
    """A stand-in for importing ``name``, undone after the test."""
    assert name not in sys.modules
    request.addfinalizer(lambda: sys.modules.pop(name, None))
    return lambda: sys.modules.setdefault(name, types.ModuleType(name))


def test_run_refuses_when_the_reference_loads_jax(monkeypatch, request):
    """The guard is the run's last step: a module that the reference loads
    after the window is seen, and no result comes."""
    from benchmark.reference import tokenizer

    load = _loads(request, "jax")
    real = tokenizer.Reference.count
    monkeypatch.setattr(tokenizer.Reference, "count",
                        lambda self, streams: (load(), real(self, streams))[1])
    with pytest.raises(SystemExit, match="jax"):
        _run("gpt2-pretok-bytes.shard-count")


def test_run_refuses_when_a_metric_reader_loads_jax(monkeypatch, request):
    from benchmark import cells

    load = _loads(request, "regex_fpga_tpu")
    real = cells.metric_reader
    monkeypatch.setattr(cells, "metric_reader",
                        lambda name: (lambda tr: (load(), real(name)(tr))[1]))
    with pytest.raises(SystemExit, match="regex_fpga_tpu"):
        _run("gpt2-pretok-bytes.shard-count", trace=True)


def test_nothing_the_benchmark_runs_loads_jax():
    """Every module of the harness, a whole run and the control, in a fresh
    process: no top-level name is jax, jaxlib, flax or regex_fpga_tpu."""
    code = f"""
import sys, time, pkgutil, importlib
sys.path.insert(0, {str(ROOT)!r}); sys.path.insert(0, {str(ROOT / 'benchmark' / 'tests')!r})
import benchmark
from benchmark import cells, run, control
for m in pkgutil.walk_packages(benchmark.__path__, 'benchmark.'):
    if '.tests' not in m.name:
        importlib.import_module(m.name)
for m in cells.HERE.joinpath('metrics').glob('*.py'):
    cells.metric_reader(m.stem)
from conftest import SMALL
for w in SMALL:
    for system in ('port', 'control'):
        run.run_cell(w, 5, 0.1, False, device='cpu', t0=time.perf_counter(),
                     system=system, overrides=SMALL[w])
print(sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'flax', 'regex_fpga_tpu')))
print(run.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-2:] == ["[]", "[]"]


def test_without_a_card_no_result_and_a_failing_exit():
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "gpt2-pretok-bytes.shard-count",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA card" in out.stderr


def test_alone_in_a_directory_it_fails(tmp_path):
    """Only BENCHMARK.json and the benchmark's files: no port, no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "gpt2-pretok-bytes.shard-count",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=120,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_small_run_on_the_card(workload, card):
    r = run.run_cell(workload, SEED, 1.0, False, device=card,
                     t0=time.perf_counter(), overrides=SMALL[workload])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    c = run.run_cell(workload, SEED, 1.0, False, device=card,
                     t0=time.perf_counter(), system="control",
                     overrides=SMALL[workload])
    assert not c["correct"]
    assert np.isfinite(r["metrics"]["scan_GBps"]["value"])
