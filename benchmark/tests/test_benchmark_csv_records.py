"""The ``csv-records-rfc4180`` configuration's parts: its corpus held to its
derivation, its plain reference held to Python's ``csv`` module, its
control, its two readers on synthetic traces, and its cell loaded and run
on the CPU at a small size."""

import csv
import io
import json
import time

import numpy as np
import pytest
import torch

from benchmark import cells, gen, run
from benchmark import trace as T
from benchmark.corpora import csv_reviews
from benchmark.corpora.csv_reviews import row_starts
from benchmark.reference import csv_records

CELL = "csv-records-rfc4180.shard-count"
CONFIG = cells.load(CELL).config
SMALL = {"bytes": 1 << 16, "pool": 2}
SEED = 2**31 + 4180
METRICS = {"kernels.fallback_roofline_pct", "engine.discarded_passes_per_call"}
E = T.Event
U = "user_annotation"


def serial_starts(data: bytes) -> np.ndarray:
    """``pat``'s record starts by a serial walk from byte 0: a quote flips
    the quoted state, an LF outside quotes ends a record with the LFs after
    it, and the next other byte starts one."""
    out, inside, ended = [0] if data else [], False, False
    for i, b in enumerate(data):
        if ended and b != 10:
            out.append(i)
            ended = False
        if b == 34:
            inside = not inside
        elif b == 10 and not inside:
            ended = True
    return np.array(out, np.int64)


@pytest.fixture(scope="module")
def ref():
    return csv_records.Reference(CONFIG, "cpu")


def test_corpus_is_its_derivation():
    path = cells.HERE / "corpora" / f"{CONFIG['corpus']}.json"
    assert path == csv_reviews.PATH
    assert path.read_text(encoding="utf-8") == csv_reviews.document()
    docs = gen.documents(CONFIG["corpus"])
    assert len(docs) == 1392 and not any(b"\n\n" in d for d in docs)
    # the generator's paragraphs are the records, each with its LF and a blank line
    buf, offs, lens = gen.paragraphs(CONFIG["corpus"])
    assert len(lens) == len(docs) and buf.tobytes() == b"".join(d + b"\n\n" for d in docs)
    for d in docs[:50]:
        (row,) = list(csv.reader(io.StringIO(d.decode(), newline="")))
        assert len(row) == 9 and all(len(x) == 22 for x in row[:3])
        assert 1 <= int(row[3]) <= 5 and len(row[4]) == 10


def test_reference_matches_csv_on_the_corpus(ref):
    data = b"".join(d + b"\n\n" for d in gen.documents(CONFIG["corpus"]))
    want = row_starts(data)
    assert len(want) == 1392
    np.testing.assert_array_equal(ref.presplit([data])[0], want)
    assert ref.count([data]) == [1391]


@pytest.mark.parametrize("seed", [SEED, 7, 2**40 + 3])
def test_reference_matches_csv_on_seeded_shards(ref, seed):
    """The pool's first shard starts at a record: Python's ``csv`` reads
    its rows. The generator cuts the others from the same draw wherever a
    shard's bytes end, most inside a quoted field: pat reads them from
    their byte 0, as the serial walk does."""
    pool = gen.make_pool(dict(cells.load(CELL).traffic, **SMALL), CONFIG, seed, "cpu")
    for k, item in enumerate(pool.items):
        want = serial_starts(item.tobytes())
        if k == 0:
            np.testing.assert_array_equal(row_starts(item.tobytes()), want)
        np.testing.assert_array_equal(ref.presplit([item])[0], want)
        assert ref.count([item]) == [len(want) - 1]


@pytest.mark.parametrize("data,starts", [
    (b"", []), (b"\n\n\n", [0]), (b'"', [0]), (b'a\n"b\nc"\n\nd', [0, 2, 9]),
    (b'"x""\n""y"\nz\n', [0, 10]), (b'a"\n"\n\nb\n', [0, 6]), (b"\na\n\nb", [0, 1, 4])])
def test_reference_on_hand_made_streams(ref, data, starts):
    np.testing.assert_array_equal(serial_starts(data), starts)
    np.testing.assert_array_equal(ref.presplit([data])[0], starts)


def test_reference_pattern_is_the_configurations():
    assert csv_records.PAT == CONFIG["pat"]
    with pytest.raises(ValueError):
        csv_records.Reference(dict(CONFIG, pat="x"), "cpu")


@pytest.mark.parametrize("seed", [SEED, 11, 2**33 + 1])
def test_control_reads_wrong_on_corpus_shards(ref, seed):
    pool = gen.make_pool(dict(cells.load(CELL).traffic, **SMALL), CONFIG, seed, "cpu")
    ctl = csv_records.Reference(CONFIG, "cpu", control=True)
    for item in pool.items:
        assert ctl.count([item]) != ref.count([item])


def test_new_cell_loads_by_name():
    cell = cells.load(CELL)
    assert cell.chips == 1 and cell.traffic["call"] == "count"
    assert cell.traffic == cells.load("gpt2-pretok-bytes.shard-count").traffic
    assert {m["name"] for m in cell.end_to_end} == {"scan_GBps", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == METRICS
    assert cells.reference_class(cell.config) is csv_records.Reference
    assert cell.config["engine"]["scan_backend"] == "device"
    bench = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
    (conf,) = [c for c in bench["configs"] if c["name"] == CONFIG["name"]]
    assert conf["source"] == CONFIG["source"]
    for name in ("gpt2-pretok-bytes.shard-count", "gpt2-pretok-bytes.doc-presplit",
                 "cl100k-pretok-utf8.shard-count"):
        assert not {m["name"] for m in cells.load(name).per_layer} & METRICS


def _call(t, rescan=True, fallback=True, stages=True):
    """One count() call at ``t`` (microseconds): two K3 chunks of two and
    three passes, then (``rescan``) the stream again through scan(): a K1
    chunk of three passes whose rounds run out and (``fallback``) the exact
    fallback, its stages (``stages``) each launching a kernel."""
    ev = [E("rf.api.count", U, t, 900.0),
          E("rf.engine.kgram", U, t + 10, 100.0),
          E("rf.engine.pass", U, t + 20, 30.0), E("rf.engine.pass", U, t + 60, 30.0),
          E("rf.engine.kgram", U, t + 120, 150.0)]
    ev += [E("rf.engine.pass", U, t + 130 + 40 * k, 30.0) for k in range(3)]
    if not rescan:
        return ev
    ev += [E("rf.engine.rescan", U, t + 300, 590.0), E("rf.engine.k1", U, t + 310, 570.0)]
    ev += [E("rf.engine.pass", U, t + 320 + 40 * k, 30.0) for k in range(3)]
    if fallback:
        ev.append(E("rf.engine.fallback", U, t + 450, 420.0))
        if stages:
            for k, (stage, kernel) in enumerate([("fns", "dfa_block_fns_kernel"),
                                                 ("combine", "dfa_fn_combine_kernel"),
                                                 ("pass2", "dfa_chain_kernel")]):
                a = t + 470 + 120 * k
                ev += [E(f"rf.engine.fallback.{stage}", U, a, 100.0),
                       E("cudaLaunchKernel", "cuda_runtime", a + 10, 5.0),
                       E(kernel, "kernel", a + 20, 50.0)]
    return ev


def _trace(events, calls=2):
    return T.Trace([E("bench.window", U, 0.0, 3000.0)] + events, 0.0, 3000.0, calls,
                   calls * 67_108_864, calls * 8)


def test_readers_on_a_synthetic_trace():
    tr = _trace(_call(100.0) + _call(1100.0))
    passes = cells.metric_reader("engine.discarded_passes_per_call")(tr)
    assert passes == pytest.approx(2 + 3 + 3)
    roof = cells.metric_reader("kernels.fallback_roofline_pct")(tr)
    busy_s = 2 * 3 * 50e-6  # the stages' kernels, not the K3 or K1 passes'
    assert roof == pytest.approx(100 * T.bound_s(2 * 67_108_864, 16) / busy_s)
    # a converging call beside a diverging one: its K3 passes are kept
    tr = _trace(_call(100.0) + _call(1100.0, rescan=False))
    assert cells.metric_reader("engine.discarded_passes_per_call")(tr) == pytest.approx(8 / 2)
    # a rescan that converged: K3's passes thrown away, K1's kept
    tr = _trace(_call(100.0, fallback=False), calls=1)
    assert cells.metric_reader("engine.discarded_passes_per_call")(tr) == pytest.approx(5)
    assert cells.metric_reader("kernels.fallback_roofline_pct")(tr) is None


def test_readers_read_nothing_without_the_spans():
    for name in METRICS:
        read = cells.metric_reader(name)
        # every call converged: no rescan, no fallback
        assert read(_trace(_call(100.0, rescan=False) + _call(1100.0, rescan=False))) is None
        # the parent: the fallback's own span, but no stage span and no rescan
        bare = [e for e in _call(100.0, stages=False) if e.name != "rf.engine.rescan"]
        assert read(_trace(bare, calls=1)) is None
        assert read(_trace([])) is None
    # stages recorded but no kernel launched (the CPU's plain versions)
    on_cpu = [e for e in _call(100.0) if e.cat not in ("cuda_runtime", "kernel")]
    assert cells.metric_reader("kernels.fallback_roofline_pct")(_trace(on_cpu, 1)) is None
    assert cells.metric_reader("engine.discarded_passes_per_call")(
        _trace(on_cpu, 1)) == pytest.approx(8)


def _run(**kw):
    return run.run_cell(CELL, SEED, 0.3, kw.pop("trace", False), device="cpu",
                        t0=time.perf_counter(), overrides=SMALL, **kw)


def test_cell_runs_on_the_cpu():
    r = _run()
    assert r["correct"] and r["failed"] == 0
    assert r["checks"]["answers_checked"]["value"] >= 1
    assert set(r["metrics"]) == {"scan_GBps", "setup_s"}
    c = _run(system="control")
    assert not c["correct"] and c["checks"]["wrong_answers"]["value"] > 0
    t = _run(trace=True)  # no card, no kernels: only the passes thrown away read
    assert t["correct"] and set(t["metrics"]) == {"engine.discarded_passes_per_call"}
    assert t["metrics"]["engine.discarded_passes_per_call"]["value"] > 16


@pytest.mark.cuda
def test_cell_on_the_card(card):
    r = run.run_cell(CELL, SEED, 1.0, True, device=card, t0=time.perf_counter(),
                     overrides=SMALL)
    assert r["correct"]
    assert r["metrics"]["engine.discarded_passes_per_call"]["value"] > 16
    assert 0 < r["metrics"]["kernels.fallback_roofline_pct"]["value"] <= 100
    assert torch.cuda.is_available()
