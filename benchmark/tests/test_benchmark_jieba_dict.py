"""The ``jieba-dict-349k`` configuration's parts: its words held to jieba's
``dict.txt`` where jieba is installed, its corpus held to its derivation,
its two readers on synthetic traces, and its cell loaded by name and run
on the CPU with the dictionary cut to its 2,000 most frequent lines (the
whole one is a 1.2M-state automaton: a card's size)."""

import dataclasses
import hashlib
import json
import time
from pathlib import Path

import numpy as np
import pytest

from benchmark import cells, gen, run
from benchmark import trace as T
from benchmark.corpora import zh_unigram
from benchmark.reference import dictionary_counts

CELL = "jieba-dict-349k.shard-word-counts"
CONFIG = cells.load(CELL).config
SMALL = {"bytes": 1 << 16, "pool": 2}
SEED = 2**31 + 349046
METRICS = {"engine.pattern_fold_ms_per_call", "kernels.dictionary_roofline_pct"}
E = T.Event
U = "user_annotation"


def test_words_are_jiebas_dict_txt():
    jieba = pytest.importorskip("jieba")
    raw = (Path(jieba.__file__).parent / "dict.txt").read_bytes()
    assert hashlib.sha256(raw).hexdigest() == CONFIG["source_sha256"]
    lines = [line.split(" ") for line in raw.decode("utf-8").splitlines()]
    assert CONFIG["words"] == [w for w, _, _ in lines]
    assert CONFIG["freqs"] == [int(f) for _, f, _ in lines]


def test_configuration_states_the_deployment():
    words = CONFIG["words"]
    assert len(words) == 349_046 and len(set(words)) == 349_045
    assert [i for i, w in enumerate(words) if w == "B超"] == [1, 16]
    assert CONFIG["reduced"] == [] and CONFIG["port"]["entry"] == "compile_literals"
    assert CONFIG["engine"]["scan_backend"] == "device"
    lengths = [len(w.encode("utf-8")) for w in words]
    assert (min(lengths), max(lengths)) == (2, 48)


def test_corpus_is_its_derivation():
    doc = json.loads(zh_unigram.PATH.read_text(encoding="utf-8"))
    assert zh_unigram.PATH.name == f"{CONFIG['corpus']}.json"
    texts = [t for _, t in doc["documents"]]
    assert texts == zh_unigram.documents(CONFIG["words"], CONFIG["freqs"])
    size = sum(len(t.encode("utf-8")) for t in texts)
    assert zh_unigram.TOTAL_BYTES <= size < zh_unigram.TOTAL_BYTES + 200_000
    docs = gen.documents(CONFIG["corpus"])
    assert not any(d.startswith(b"\n") or d.endswith(b"\n") for d in docs)
    assert all(d.endswith("。".encode()) for d in docs)


def test_cell_loads_by_name():
    cell = cells.load(CELL)
    assert cell.chips == 1 and cell.traffic["call"] == "count_patterns"
    assert cell.traffic["bytes"] == 1 << 26 and cell.traffic["pinned"]
    assert cell.traffic["pool"] == 4 and cell.traffic["check_share"] == 1.0
    assert {m["name"] for m in cell.end_to_end} == {"scan_GBps", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == METRICS
    assert cells.reference_class(cell.config) is dictionary_counts.Reference
    bench = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
    (conf,) = [c for c in bench["configs"] if c["name"] == CONFIG["name"]]
    assert conf["reduced"] == CONFIG["reduced"] == []
    for name in ("gpt2-pretok-bytes.shard-count", "gpt2-pretok-bytes.doc-presplit",
                 "cl100k-pretok-utf8.shard-count", "csv-records-rfc4180.shard-count"):
        assert not {m["name"] for m in cells.load(name).per_layer} & METRICS


def _call(t, fold=True, kernels=True):
    """One count_patterns() call at ``t`` (microseconds): a K1 chunk with
    its upload, its speculation's launch, its pass holding (``fold``) the
    fold, and the read; (``kernels``) each launch with its kernel."""
    ev = [E("rf.api.count_patterns", U, t, 800.0),
          E("rf.engine.k1", U, t + 10, 700.0),
          E("rf.device.upload", U, t + 20, 30.0),
          E("rf.engine.pass", U, t + 100, 300.0)]
    launches = [(t + 60, "dfa_chain_kernel"), (t + 120, "dfa_chain_kernel")]
    if fold:
        ev.append(E("rf.engine.pattern_fold", U, t + 200, 40.0))
        launches += [(t + 210, "index_select_kernel"), (t + 225, "index_add_kernel")]
    ev.append(E("rf.device.readback", U, t + 450, 200.0))
    launches.append((t + 900, "after_the_call"))  # outside every span
    if kernels:
        for a, name in launches:
            ev += [E("cudaLaunchKernel", "cuda_runtime", a, 5.0),
                   E(name, "kernel", a + 8, 50.0)]
    return ev


def _trace(events, calls=2):
    return T.Trace([E("bench.window", U, 0.0, 3000.0)] + events, 0.0, 3000.0, calls,
                   calls * 67_108_864, calls * 349_046 * 8)


def test_readers_on_a_synthetic_trace():
    tr = _trace(_call(100.0) + _call(1100.0))
    fold = cells.metric_reader("engine.pattern_fold_ms_per_call")(tr)
    assert fold == pytest.approx(40e-3)
    roof = cells.metric_reader("kernels.dictionary_roofline_pct")(tr)
    busy_s = 2 * 4 * 50e-6  # the chunk's four kernels, not the one after it
    assert roof == pytest.approx(
        100 * T.bound_s(2 * 67_108_864, 2 * 349_046 * 8) / busy_s)


def test_readers_read_nothing_without_the_spans():
    bare = [e for e in _call(100.0) + _call(1100.0)
            if not e.name.startswith("rf.")]
    for name in METRICS:
        read = cells.metric_reader(name)
        assert read(_trace(bare)) is None
        assert read(_trace([])) is None
    # a program that does not fold on the device: the chunk's kernels still read
    no_fold = _trace(_call(100.0, fold=False), calls=1)
    assert cells.metric_reader("engine.pattern_fold_ms_per_call")(no_fold) is None
    assert cells.metric_reader("kernels.dictionary_roofline_pct")(no_fold) > 0
    # spans but no kernel (the CPU's plain versions)
    on_cpu = _trace(_call(100.0, kernels=False), calls=1)
    assert cells.metric_reader("kernels.dictionary_roofline_pct")(on_cpu) is None
    assert cells.metric_reader("engine.pattern_fold_ms_per_call")(on_cpu) == pytest.approx(0.04)


@pytest.fixture
def cut(monkeypatch):
    """The cell with the dictionary cut to its 2,000 most frequent lines,
    in line order."""
    keep = np.sort(np.argsort(CONFIG["freqs"], kind="stable")[-2000:])
    config = dict(CONFIG, words=[CONFIG["words"][i] for i in keep],
                  freqs=[CONFIG["freqs"][i] for i in keep])
    real = cells.load

    def load(name, bench_file=None):
        cell = real(name, bench_file)
        return dataclasses.replace(cell, config=config) if name == CELL else cell
    monkeypatch.setattr(cells, "load", load)
    return config


def _run(**kw):
    return run.run_cell(CELL, SEED, 0.3, kw.pop("trace", False), device=kw.pop("device", "cpu"),
                        t0=time.perf_counter(), overrides=SMALL, **kw)


def test_cell_runs_on_the_cpu(cut):
    r = _run()
    assert r["correct"] and r["failed"] == 0
    assert r["checks"]["answers_checked"]["value"] >= 2
    assert set(r["metrics"]) == {"scan_GBps", "setup_s"}
    c = _run(system="control")
    assert not c["correct"] and c["checks"]["wrong_answers"]["value"] > 0
    t = _run(trace=True)  # no card, no kernels: only the fold's span reads
    assert t["correct"] and set(t["metrics"]) == {"engine.pattern_fold_ms_per_call"}


@pytest.mark.cuda
def test_cell_on_the_card(cut, card):
    r = _run(trace=True, device=card)
    assert r["correct"]
    assert set(r["metrics"]) == METRICS
    assert 0 < r["metrics"]["kernels.dictionary_roofline_pct"]["value"] <= 100
