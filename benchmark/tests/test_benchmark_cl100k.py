"""The ``cl100k-pretok-utf8`` configuration's parts: its plain reference
held to the ``regex`` module, its control, its two readers on synthetic
traces, and its cell loaded and run on the CPU at a small size."""

import json
import sys
import time
import types
import unicodedata

import numpy as np
import pytest
import regex
import torch

from benchmark import cells, gen, run
from benchmark import trace as T
from benchmark.reference import cl100k

CELL = "cl100k-pretok-utf8.shard-count"
CONFIG = cells.load(CELL).config
SMALL = {"bytes": 1 << 16, "pool": 2}
SEED = 2**31 + 5150
E = T.Event
U = "user_annotation"

#: code points aimed at each rule; those where ``regex`` and the Unicode
#: 15.0.0 ranges disagree are left out below
ALPHABET = ("'\u2019\u017fSsLlVvEeRrTtDdMmaxK0123456789\u0663\u00b2\u2460"
            "\u4e2d\u03bb\u00e9\u0301\U0001f600\r\n\t \u00a0\u3000\u0085"
            "!,.\"()-\u2014\u201c\u2026")


def _in(name, c):
    r = cl100k._ranges()[name]
    return any(a <= c <= b for a, b in r)


CHARS = [ch for ch in ALPHABET
         if (regex.match(r"\p{L}", ch) is not None) == _in("L", ord(ch))
         and (regex.match(r"\p{N}", ch) is not None) == _in("N", ord(ch))
         and (regex.match(r"\s", ch) is not None) == _in("White_Space", ord(ch))]


def truth(data: bytes) -> np.ndarray:
    """``regex.finditer(pat)`` over the valid characters between bytes that
    are no character, at byte offsets; byte 0 starts the first piece."""
    out, seg, offs, at = {0}, [], [], 0

    def flush():
        for m in regex.finditer(CONFIG["pat"], "".join(seg)):
            out.add(offs[m.start()])

    for ch in data.decode("utf-8", "surrogateescape"):
        if 0xDC80 <= ord(ch) <= 0xDCFF:
            flush()
            seg, offs = [], []
            at += 1
            continue
        seg.append(ch)
        offs.append(at)
        at += len(ch.encode("utf-8"))
    flush()
    return np.array(sorted(out), np.int64)


@pytest.fixture(scope="module")
def ref():
    return cl100k.Reference(CONFIG, "cpu")


def test_reference_pattern_is_the_configurations():
    assert cl100k.PAT == CONFIG["pat"]
    with pytest.raises(ValueError):
        cl100k.Reference(dict(CONFIG, pat="x"), "cpu")


def test_reference_ranges_are_unicode_15():
    r = cl100k._ranges()
    assert r["version"] == "15.0.0"
    if unicodedata.unidata_version != "15.0.0":
        pytest.skip(f"unicodedata has {unicodedata.unidata_version}")
    rng = np.random.default_rng(3)
    for c in list(range(0, 0x3000)) + list(rng.integers(0, 0x110000, 20000)):
        c = int(c)
        if 0xD800 <= c <= 0xDFFF:
            continue
        cat = unicodedata.category(chr(c))
        assert _in("L", c) == (cat[0] == "L") and _in("N", c) == (cat[0] == "N"), hex(c)
    assert sum(b - a + 1 for a, b in r["White_Space"]) == 25


def test_reference_matches_regex_on_seeded_strings(ref):
    rng = np.random.default_rng(11)
    strings = []
    for _ in range(2000):
        s = "".join(CHARS[k] for k in rng.integers(0, len(CHARS), rng.integers(1, 30)))
        strings.append(s.encode())
    for s in strings[:300]:
        np.testing.assert_array_equal(ref.presplit([s])[0], truth(s))
    data = b"\xff".join(strings)  # bytes of no character cut the text
    np.testing.assert_array_equal(ref.presplit([data])[0], truth(data))
    assert ref.count([data]) == [len(truth(data)) - 1]


@pytest.mark.parametrize("data", [b"a\xe2\x80b", b"\xe2\x80ab", b"ab\xe2\x80",
                                  b"a\x80\x80b c", b"\xff", b"\xed\xa0\x80y",
                                  b"\xf4\x90\x80\x80z", b"x\xe0\x80y", b""])
def test_reference_invalid_bytes(ref, data):
    want = truth(data) if data else np.zeros(0, np.int64)
    np.testing.assert_array_equal(ref.presplit([data])[0], want)


def test_reference_matches_regex_on_the_corpus(ref):
    data = b"".join(gen.documents(CONFIG["corpus"]))
    np.testing.assert_array_equal(ref.presplit([data])[0], truth(data))


def test_control_reads_wrong_on_corpus_shards(ref):
    pool = gen.make_pool(dict(cells.load(CELL).traffic, **SMALL), CONFIG, SEED, "cpu")
    ctl = cl100k.Reference(CONFIG, "cpu", control=True)
    for item in pool.items:
        assert ctl.count([item]) != ref.count([item])
        assert ref.count([item]) == [len(truth(item.tobytes())) - 1]


def test_new_cell_loads_by_name():
    cell = cells.load(CELL)
    assert cell.chips == 1 and cell.traffic["call"] == "count"
    assert {m["name"] for m in cell.end_to_end} == {"scan_GBps", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "kernels.global_table_roofline_pct", "engine.global_table_passes_per_chunk"}
    assert cells.reference_class(cell.config) is cl100k.Reference
    assert cell.config["engine"]["scan_backend"] == "device"
    assert cell.config["port"]["kwargs"] == {"utf8": True}
    # the GPT-2 cells report neither new metric
    for name in ("gpt2-pretok-bytes.shard-count", "gpt2-pretok-bytes.doc-presplit"):
        names = {m["name"] for m in cells.load(name).per_layer}
        assert not names & {"kernels.global_table_roofline_pct",
                            "engine.global_table_passes_per_chunk"}


# two count() calls (microseconds): the first a chunk on the global route
# whose guess verifies (one pass), the second a chunk whose guess fails (a
# Jacobi round: two passes); a third chunk on a shared route (no span)
GLOBAL = [
    E("bench.window", U, 0.0, 1000.0),
    E("rf.api.count", U, 0.0, 300.0),
    E("rf.engine.k1", U, 10.0, 280.0),
    E("rf.engine.global_table", U, 20.0, 10.0),  # the speculation's K1
    E("cudaLaunchKernel", "cuda_runtime", 22.0, 4.0),
    E("dfa_chain_kernel", "kernel", 30.0, 40.0),
    E("rf.engine.pass", U, 80.0, 200.0),
    E("rf.engine.global_table", U, 90.0, 10.0),  # K2
    E("cudaLaunchKernel", "cuda_runtime", 92.0, 4.0),
    E("dfa_chain_counts_kernel", "kernel", 100.0, 160.0),
    E("cudaLaunchKernel", "cuda_runtime", 262.0, 4.0),  # torch's own
    E("reduce_kernel", "kernel", 265.0, 5.0),
    E("rf.api.count", U, 300.0, 400.0),
    E("rf.engine.k1", U, 310.0, 380.0),
    E("rf.engine.pass", U, 320.0, 100.0),
    E("rf.engine.global_table", U, 330.0, 10.0),
    E("cudaLaunchKernel", "cuda_runtime", 332.0, 4.0),
    E("dfa_chain_counts_kernel", "kernel", 340.0, 60.0),
    E("rf.engine.pass", U, 430.0, 100.0),
    E("rf.engine.global_table", U, 440.0, 10.0),
    E("cudaLaunchKernel", "cuda_runtime", 442.0, 4.0),
    E("dfa_chain_counts_kernel", "kernel", 450.0, 40.0),
    E("rf.api.count", U, 700.0, 200.0),
    E("rf.engine.k1", U, 710.0, 180.0),  # shared route: no global span
    E("rf.engine.pass", U, 720.0, 100.0),
    E("cudaLaunchKernel", "cuda_runtime", 722.0, 4.0),
    E("dfa_chain_counts_kernel", "kernel", 730.0, 20.0),
]


def _trace(events, bytes_in=3 * 67_000_000, bytes_out=24):
    return T.Trace(events, 0.0, 1000.0, 3, bytes_in, bytes_out)


def test_global_table_readers_on_a_synthetic_trace():
    tr = _trace(GLOBAL)
    passes = cells.metric_reader("engine.global_table_passes_per_chunk")(tr)
    assert passes == pytest.approx((1 + 2) / 2)
    roof = cells.metric_reader("kernels.global_table_roofline_pct")(tr)
    busy_us = 40 + 160 + 60 + 40  # not torch's kernel, not the shared route's
    assert roof == pytest.approx(100 * T.bound_s(3 * 67_000_000, 24) / (busy_us * 1e-6))


def test_global_table_readers_read_nothing_without_the_span():
    bare = [e for e in GLOBAL if e.name != "rf.engine.global_table"]
    for name in ("engine.global_table_passes_per_chunk",
                 "kernels.global_table_roofline_pct"):
        assert cells.metric_reader(name)(_trace(bare)) is None
        assert cells.metric_reader(name)(_trace(GLOBAL[:1])) is None


def _run(**kw):
    return run.run_cell(CELL, SEED, 0.3, kw.pop("trace", False), device="cpu",
                        t0=time.perf_counter(), overrides=SMALL, **kw)


def test_cell_runs_on_the_cpu():
    r = _run()
    assert r["correct"] and r["failed"] == 0
    assert r["checks"]["answers_checked"]["value"] >= 2
    assert set(r["metrics"]) == {"scan_GBps", "setup_s"}
    c = _run(system="control")
    assert not c["correct"] and c["checks"]["wrong_answers"]["value"] > 0
    t = _run(trace=True)  # no card, no kernels: the readers leave both out
    assert t["correct"] and set(t["metrics"]) <= {
        "kernels.global_table_roofline_pct", "engine.global_table_passes_per_chunk"}


def test_cell_run_refuses_a_loaded_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(SystemExit, match="jax"):
        _run()


@pytest.mark.cuda
def test_cell_on_the_card(card):
    r = run.run_cell(CELL, SEED, 1.0, True, device=card, t0=time.perf_counter(),
                     overrides=SMALL)
    assert r["correct"]
    assert r["metrics"]["engine.global_table_passes_per_chunk"]["value"] >= 1.0
    assert 0 < r["metrics"]["kernels.global_table_roofline_pct"]["value"] <= 100
    assert torch.cuda.is_available()
    assert json.dumps(r)
