"""The port's own spans (``utils.profiling.trace``) on the DFA main path:
the tree a traced ``count()`` and ``presplit()`` record, the passes and the
exact fallback of an automaton that never synchronizes, the one check a
span costs with no profiler, and (on a card) the device events placed on
the spans' host clock by their launches.

The file imports no JAX, so that its card test runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_trace_spans.py -q
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from regex_fpga_tpu_torch import api
from regex_fpga_tpu_torch.models import CompiledDfa
from regex_fpga_tpu_torch.utils.config import EngineConfig
from regex_fpga_tpu_torch.utils.profiling import trace

#: 64 lanes of at least 16 bytes, chunks of 16 KiB: a 34,800-byte text
#: takes three chunks, the last with a tail shorter than its lanes x k
SMALL = EngineConfig(num_blocks=64, min_block_bytes=16, chunk_bytes=1 << 14)
TEXT = b"Hello world, it's 2024 and we're testing   the tokenizer!\n" * 600


def _events(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X" and "ts" in e]


def _tree(events):
    """The program's spans as nested (name, children) tuples."""
    spans = sorted((e for e in events if e["name"].startswith("rf.")),
                   key=lambda e: (e["ts"], -e.get("dur", 0)))
    root: list = []
    stack: list = []  # (end, children list)
    for e in spans:
        assert e["cat"] == "user_annotation", e
        end = e["ts"] + e.get("dur", 0)
        while stack and stack[-1][0] <= e["ts"]:
            stack.pop()
        kids: list = []
        (stack[-1][1] if stack else root).append((e["name"], kids))
        stack.append((end, kids))
    return _freeze(root)


def _freeze(nodes):
    return tuple((name, _freeze(kids)) for name, kids in nodes)


def _traced(fn, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _events(prof, tmp_path)


UPLOAD = ("rf.device.upload", ())
PASS = ("rf.engine.pass", ())
READBACK = ("rf.device.readback", ())
KGRAM = ("rf.engine.kgram", (UPLOAD, PASS, READBACK))


def test_count_span_tree(tmp_path):
    tok = api.compile_tokenizer(config=SMALL, device="cpu")
    want = tok.count(TEXT)
    got, events = _traced(lambda: tok.count(TEXT), tmp_path)
    assert got == want
    # two whole chunks on K3; the last on K3, then its tail on K2
    k1 = ("rf.engine.k1", (UPLOAD, PASS, READBACK))
    assert _tree(events) == (("rf.api.count", (KGRAM, KGRAM, KGRAM, k1)),)


def test_presplit_span_tree(tmp_path):
    tok = api.compile_tokenizer(config=SMALL, device="cpu")
    text = TEXT[:40_000]
    want = tok.presplit(text)
    got, events = _traced(lambda: tok.presplit(text), tmp_path)
    np.testing.assert_array_equal(got, want)
    chunk = (("rf.engine.k1", (UPLOAD, PASS)), ("rf.engine.positions", ()),
             READBACK)
    assert _tree(events) == (("rf.api.presplit", chunk * 3),)


def test_one_pass_per_chunk_when_the_guess_holds(tmp_path):
    tok = api.compile_tokenizer(config=SMALL, device="cpu")
    _, events = _traced(lambda: (tok.count(TEXT), tok.presplit(TEXT)), tmp_path)
    names = [e["name"] for e in events]
    chunks = sum(n in ("rf.engine.kgram", "rf.engine.k1") for n in names)
    assert chunks == 4 + 3 and names.count("rf.engine.pass") == chunks


def parity_dfa() -> CompiledDfa:
    """Every byte flips the state: it never synchronizes."""
    table = np.zeros((256, 2), dtype=np.int32)
    table[:, 0] = 1
    return CompiledDfa(table=table, accept=np.array([False, True]), start=0,
                       dead=-1)


def test_parity_takes_passes_and_the_fallback(tmp_path):
    """64 lanes of 17 bytes: each lane's guessed entry (the parity of the
    block before it) is wrong on every other lane, the Jacobi rounds run
    out, and the chunk takes the exact fallback."""
    config = EngineConfig(num_blocks=64, min_block_bytes=16,
                          chunk_bytes=1 << 14, scan_backend="device")
    m = api.DfaMatcher(parity_dfa(), config, device="cpu")
    stream = np.random.default_rng(0).integers(0, 256, 64 * 17, dtype=np.uint8)
    rep, events = _traced(lambda: m.scan(stream), tmp_path)
    assert not rep.metrics.converged
    assert rep.total == len(stream) // 2  # state 1 before every other byte
    (k1,) = _tree(events)
    name, kids = k1
    assert name == "rf.engine.k1"
    passes = sum(k == PASS for k in kids)
    assert passes == config.max_iters + 1  # the guess, the rounds, the output
    fallback = [k for k in kids if k[0] == "rf.engine.fallback"]
    # on the chunk's device bytes, no upload: the blocked scan's stages over
    # the one whole 1,024-byte block, the read of its counts and final
    # state, then the serial tail of 64 bytes
    assert fallback == [("rf.engine.fallback",
                         FALLBACK_STAGES + (READBACK, ("rf.engine.fallback.serial", ())))]
    assert sum(k == UPLOAD for k in kids) == 1


FALLBACK_STAGES = tuple((f"rf.engine.fallback.{s}", ()) for s in ("fns", "combine", "pass2"))


def csv_tokenizer():
    """The benchmark's RFC 4180 record pattern: quote parity never
    resynchronizes, so K3 diverges on its records and count() takes the
    exact fallback on each such chunk."""
    from pathlib import Path

    conf = json.loads((Path(__file__).resolve().parents[1] / "benchmark" / "configs"
                       / "csv-records-rfc4180.json").read_text())
    cfg = EngineConfig(num_blocks=64, min_block_bytes=16, chunk_bytes=1 << 12,
                       scan_backend="device")
    return api.compile_tokenizer(conf["pat"], config=cfg, device="cpu")


CSV = (b'r,u,b,4,2020-02-29,"a ""b"",\nc\nd\ne\nf, g\nh",0,1,2\n\n' * 60)[:2048]


def test_diverged_chunk_falls_back_in_place(tmp_path):
    """A count() chunk whose K3 rounds run out takes the exact fallback
    inside its own ``rf.engine.kgram`` span, after its ``max_iters`` passes,
    on the bytes K3 was given: the fallback holds the three stages and the
    one read of its counts and final state, and no upload. No stream is
    scanned again (no ``rf.engine.rescan``), so each chunk has one upload.
    The second stream holds no quote, and every guess of its lanes holds."""
    tok = csv_tokenizer()
    streams = [np.frombuffer(s, np.uint8)
               for s in (CSV, b"x,y\n" * 512, CSV[100:] + CSV[:100])]
    want = tok.count(streams)
    got, events = _traced(lambda: tok.count(streams), tmp_path)
    assert got == want == tok.scan(streams).total
    ((name, kids),) = _tree(events)
    assert name == "rf.api.count"
    assert [k[0] for k in kids] == ["rf.engine.kgram"] * 3
    assert kids[1] == KGRAM
    # K3's guess and its rounds fail on the quoted streams (no output pass
    # after the last), then the fallback over the part's two whole blocks
    fallback = ("rf.engine.fallback", FALLBACK_STAGES + (READBACK,))
    for i in (0, 2):
        assert kids[i][1] == ((UPLOAD,) + (PASS, READBACK) * tok.config.max_iters
                              + (fallback,))
    names = [e["name"] for e in events]
    assert names.count("rf.device.upload") == 3
    assert "rf.engine.rescan" not in names
    gpt2 = api.compile_tokenizer(config=SMALL, device="cpu")
    _, events = _traced(lambda: gpt2.count(TEXT), tmp_path)
    assert "rf.engine.fallback" not in {e["name"] for e in events}


def test_fallback_stages_nest_inside_the_fallback(tmp_path):
    """Each stage span of the exact fallback lies inside its
    ``rf.engine.fallback`` span, once a group of blocks, with no serial tail
    on whole blocks; presplit() takes the same stages."""
    tok = csv_tokenizer()
    data = np.frombuffer(CSV, np.uint8)
    _, events = _traced(lambda: tok.presplit(data), tmp_path)
    falls = []

    def walk(nodes):
        for name, kids in nodes:
            if name == "rf.engine.fallback":
                falls.append(kids)
            walk(kids)

    walk(_tree(events))
    assert falls == [FALLBACK_STAGES]  # on the K1 chunk's device bytes
    names = [e["name"] for e in events]
    assert sum(n.startswith("rf.engine.fallback.") for n in names) == 3


def test_spans_change_no_csv_result(tmp_path):
    tok = csv_tokenizer()
    data = np.frombuffer(CSV, np.uint8)
    untraced = tok.count(data), tok.presplit(data), tok.scan(data).counts
    traced, _ = _traced(lambda: (tok.count(data), tok.presplit(data),
                                 tok.scan(data).counts), tmp_path)
    assert traced[0] == untraced[0]
    np.testing.assert_array_equal(traced[1], untraced[1])
    np.testing.assert_array_equal(traced[2], untraced[2])
    assert not tok.scan(data).metrics.converged


def test_spans_change_no_result(tmp_path):
    tok = api.compile_tokenizer(config=SMALL, device="cpu")
    untraced = tok.count(TEXT), tok.presplit(TEXT)
    traced, _ = _traced(lambda: (tok.count(TEXT), tok.presplit(TEXT)), tmp_path)
    assert traced[0] == untraced[0]
    np.testing.assert_array_equal(traced[1], untraced[1])


def test_trace_off_is_one_check(monkeypatch):
    """With no profiler recording, a span never enters record_function."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert trace("rf.x") is trace("rf.y")  # one shared null context
    with trace("rf.x"):
        with trace("rf.y"):
            pass
    tok = api.compile_tokenizer(config=SMALL, device="cpu")
    assert tok.count(TEXT) > 0 and len(tok.presplit(TEXT)) > 0


def test_trace_on_enters_record_function(monkeypatch):
    seen = []
    real = torch.profiler.record_function

    def spy(name):
        seen.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    with profile(activities=[ProfilerActivity.CPU]):
        with trace("rf.api.x"):
            pass
    assert seen == ["rf.api.x"]


def test_compile_span_wraps_the_build(tmp_path):
    """``rf.compile.tokenizer`` holds the automaton's build, and the
    matcher it builds answers as one built untraced."""
    tok, events = _traced(lambda: api.compile_tokenizer(config=SMALL, device="cpu"),
                          tmp_path)
    assert _tree(events) == (("rf.compile.tokenizer", ()),)
    untraced = api.compile_tokenizer(config=SMALL, device="cpu")
    np.testing.assert_array_equal(tok.tok.table, untraced.tok.table)
    assert tok.count(TEXT) == untraced.count(TEXT)


LITERALS = [b"Hello", b"world", b"test", b"ing", b"the", b"er", b"e", b"the"]


def test_literals_compile_span_wraps_the_build(tmp_path):
    """``rf.compile.literals`` holds the automaton's build and its tables'."""
    lits, events = _traced(lambda: api.compile_literals(LITERALS, config=SMALL,
                                                        device="cpu"), tmp_path)
    assert _tree(events) == (("rf.compile.literals", ()),)
    untraced = api.compile_literals(LITERALS, config=SMALL, device="cpu")
    np.testing.assert_array_equal(lits.count_patterns(TEXT), untraced.count_patterns(TEXT))


def test_count_patterns_span_tree(tmp_path):
    """One ``rf.engine.pattern_fold`` a chunk, inside its chain pass: the
    fold is queued before the verdict's read, which carries its counts."""
    lits = api.compile_literals(LITERALS, config=SMALL, device="cpu")
    want = lits.count_patterns(TEXT)
    got, events = _traced(lambda: lits.count_patterns(TEXT), tmp_path)
    np.testing.assert_array_equal(got, want)
    fold = ("rf.engine.pass", (("rf.engine.pattern_fold", ()),))
    chunk = ("rf.engine.k1", (UPLOAD, fold, READBACK))
    # 34,800 bytes: two whole 16-KiB chunks and a padded tail
    assert _tree(events) == (("rf.api.count_patterns", (chunk,) * 3),)


def test_count_patterns_reads_once_a_chunk(monkeypatch):
    """Where the speculation verifies, a call of one chunk makes one host
    read: the verdict, with the final state and the pattern counts."""
    lits = api.compile_literals(LITERALS, config=SMALL, device="cpu")
    lits.count_patterns(TEXT)  # the table's range is read once, at first use
    reads = []
    real_cpu = torch.Tensor.cpu

    def cpu(self, *args, **kw):
        reads.append(tuple(self.shape))
        return real_cpu(self, *args, **kw)
    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    for data in (TEXT[:16_384], TEXT[:10_001]):
        reads.clear()
        got = lits.count_patterns(data)
        # misses, the final state, its range, the pattern counts
        assert reads == [(1 + 1 + 2 + len(LITERALS),)]
        monkeypatch.setattr(torch.Tensor, "cpu", real_cpu)
        np.testing.assert_array_equal(got, lits.scan_patterns(data).pattern_counts[0])
        monkeypatch.setattr(torch.Tensor, "cpu", cpu)


@pytest.mark.parametrize("mapped", [False, True])
@pytest.mark.parametrize("table", ["global", "shared uint16", "shared uint32"])
def test_global_table_span_follows_the_route(table, mapped, monkeypatch, tmp_path):
    """``rf.engine.global_table`` opens around a K1/K2 launch only where its
    route keeps the table in global memory, asks for the route (of a launch
    given the byte map, or not) once per shape, and costs no route lookup
    with no profiler; ``rf.engine.byte_map`` opens around every launch given
    the map, the table's span inside it."""
    from regex_fpga_tpu_torch.ops import hopper_dfa

    asked = []

    def route(*args):
        asked.append(args)
        return {"table": table}

    monkeypatch.setattr(hopper_dfa, "dfa_chain_route", route)
    hopper_dfa._table_in_global.cache_clear()
    cls = torch.zeros((4, 8), dtype=torch.uint8)
    with hopper_dfa._launch_spans("counts", cls, 110, 1899, 8, mapped=mapped):
        pass
    assert asked == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with hopper_dfa._launch_spans("counts", cls, 110, 1899, 8, mapped=mapped):
                pass
    hopper_dfa._table_in_global.cache_clear()
    assert len(asked) == 1 and asked[0][-1] is mapped
    events = _events(prof, tmp_path)
    names = [e["name"] for e in events]
    assert names.count("rf.engine.global_table") == (3 if table == "global" else 0)
    assert names.count("rf.engine.byte_map") == (3 if mapped else 0)
    if mapped and table == "global":
        table_span = ("rf.engine.global_table", ())
        assert _tree(events) == (("rf.engine.byte_map", (table_span,)),) * 3


def test_k2_count_reads_once_a_chunk(monkeypatch, tmp_path):
    """count() on the cl100k tokenizer (1,899 states: scan()'s K1/K2
    chunks) records one ``rf.device.readback`` a chunk, and each chunk's
    ``rf.engine.k1`` span holds its ``rf.engine.pass`` and the
    ``rf.engine.global_table`` spans of the speculation's and the pass's
    launches, inside the ``rf.engine.byte_map`` span of a launch given the
    byte map where the chunk's lanes divide it. The route is the
    monkeypatched one of ``test_global_table_span_follows_the_route``; on
    the CPU the plain passes stand in for the launches, inside the spans
    the launch opens."""
    from pathlib import Path

    from regex_fpga_tpu_torch.ops import hopper_dfa

    conf = json.loads((Path(__file__).resolve().parents[1] / "benchmark" / "configs"
                       / "cl100k-pretok-utf8.json").read_text())
    cfg = EngineConfig(num_blocks=64, min_block_bytes=16, chunk_bytes=1 << 14,
                       scan_backend="device")
    tok = api.compile_tokenizer(conf["pat"], config=cfg, device="cpu",
                                **conf["port"]["kwargs"])
    assert tok._kgram() is None
    want = tok.count(TEXT)
    finals_pass, counts_pass = hopper_dfa.dfa_chain_plain, hopper_dfa.dfa_chain_counts_plain

    def k1(table, accept, cls_seq, entries, mode, class_of):
        with hopper_dfa._launch_spans(mode, cls_seq, *table.shape, cls_seq.shape[1],
                                      mapped=class_of is not None):
            return finals_pass(table, accept, cls_seq, entries, mode, class_of=class_of)

    def k2(table, accept, cls_seq, entries, num_streams, class_of):
        with hopper_dfa._launch_spans("counts", cls_seq, *table.shape, cls_seq.shape[1],
                                      mapped=class_of is not None):
            return counts_pass(table, accept, cls_seq, entries, num_streams,
                               class_of=class_of)
    monkeypatch.setattr(hopper_dfa, "dfa_chain_route", lambda *a: {"table": "global"})
    monkeypatch.setattr(hopper_dfa, "dfa_chain_plain",
                        lambda *a, class_of=None: k1(*a, class_of))
    monkeypatch.setattr(hopper_dfa, "dfa_chain_counts_plain",
                        lambda *a, class_of=None: k2(*a, class_of))
    hopper_dfa._table_in_global.cache_clear()
    try:
        got, events = _traced(lambda: tok.count(TEXT), tmp_path)
    finally:
        hopper_dfa._table_in_global.cache_clear()
    assert got == want
    def chunk(table):
        return ("rf.engine.k1", (UPLOAD, table, ("rf.engine.pass", (table,)), READBACK))
    table = ("rf.engine.global_table", ())
    mapped = ("rf.engine.byte_map", (table,))
    # two whole 16-KiB chunks on raw bytes, the 2,032-byte tail padded
    assert _tree(events) == (("rf.api.count", (chunk(mapped),) * 2 + (chunk(table),)),)


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inside(e, span) -> bool:
    return span.ts <= e.ts and e.end <= span.end


@pytest.mark.cuda
def test_device_work_is_placed_on_the_host_clock_by_its_launch(cuda, tmp_path):
    """The profiler's device clock may run off the host's: the span
    readers pair each device event with its launch by stream order (the
    pairing the profiler's correlation ids give), and with each idle
    interval placed by its launch, a copy ends while the host waits on
    it."""
    from benchmark import spans as S
    from benchmark import trace as T

    tok = api.compile_tokenizer(device=cuda)
    rng = np.random.default_rng(0)
    words = np.frombuffer(TEXT, np.uint8)
    data = words[rng.integers(0, len(words), 64 << 20)]  # 64 MiB of its bytes
    data = torch.from_numpy(data).pin_memory().numpy()  # as a pinning loader's
    docs = [TEXT[:int(n)] for n in rng.integers(200, 20_000, 50)]
    want = tok.count(data), [tok.presplit(d) for d in docs]  # builds the kernels
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = [tok.count(data) for _ in range(3)], [tok.presplit(d) for d in docs]
        torch.cuda.synchronize()
    assert got[0] == [want[0]] * 3
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    raw = [e for e in doc["traceEvents"] if e.get("ph") == "X" and "ts" in e]
    events = T.events_from_chrome(doc)
    corr = {id(e): r.get("args", {}).get("correlation") for e, r in zip(events, raw)}
    tr = T.Trace(events, min(e.ts for e in events), max(e.end for e in events), 53, 0, 0)

    found = S.enqueued(tr)
    assert found is not None
    pairs, _ = found
    assert len(pairs) >= len(tr.device()) - 100  # all but records lost at the start
    assert all(corr[id(d)] == corr[id(c)] for d, c in pairs)

    # the upload span holds the call that enqueued each shard's copy, and
    # each pass of a K3 chunk launches K3
    spans = S.program(tr)
    uploads = [e for e in spans if e.name == "rf.device.upload"]
    kgram = [e for e in spans if e.name == "rf.engine.kgram"]
    passes = [e for e in spans if e.name == "rf.engine.pass"
              and any(_inside(e, k) for k in kgram)]
    launch = {id(d): c for d, c in pairs}
    h2d = sorted((d for d in tr.of("gpu_memcpy") if "HtoD" in d.name),
                 key=lambda d: -d.dur)[:3]
    for copy in h2d:
        call = launch[id(copy)]
        assert call.name.startswith("cudaMemcpy"), call
        assert sum(_inside(call, u) for u in uploads) == 1
    k3 = [launch[id(d)] for d in tr.of("kernel") if "kgram" in d.name]
    assert len(passes) == 3
    assert all(any(_inside(c, p) for c in k3) for p in passes)

    # placed by the launches, the card's idle time after each 64 MiB copy
    # (over 1 ms on the card) and the work queued behind it (closed by the
    # first launch after the host's next wait) begins between the last
    # launch before that wait and the wait's end. Read on the profiler's
    # raw device clock it need not.
    idle = S.idle_on_host(tr)
    waits = sorted((e for e in tr.of("cuda_runtime") if e.name in S.WAITS),
                   key=lambda e: e.ts)
    calls = sorted((c for _, c in pairs), key=lambda c: c.ts)
    for copy in h2d:
        call = launch[id(copy)]
        wait = next(w for w in waits if w.ts >= call.end)
        last = max((c for c in calls if c.ts < wait.ts), key=lambda c: c.ts)
        after = next(a for a, b in idle if b >= wait.end)
        assert last.ts - 50.0 <= after <= wait.end + 50.0, (copy, last, wait, after)


@pytest.mark.cuda
def test_spans_are_on_under_emit_nvtx(cuda):
    tok = api.compile_tokenizer(device=cuda)
    want = tok.count(TEXT)
    assert trace("rf.x") is trace("rf.y")
    with torch.autograd.profiler.emit_nvtx():
        assert torch.autograd._profiler_enabled()
        assert trace("rf.x") is not trace("rf.y")  # record_function: NVTX ranges
        assert tok.count(TEXT) == want


@pytest.mark.cuda
def test_global_table_span_on_the_card(cuda, tmp_path):
    """On the card every K1/K2 launch of a 1,899-state tokenizer's count()
    and presplit() lies inside ``rf.engine.global_table``, none of the GPT-2
    automaton's does, and the spans change no result."""
    import json as _json

    from benchmark import spans as S
    from benchmark import trace as T

    from pathlib import Path

    conf = _json.loads((Path(__file__).resolve().parents[1] / "benchmark" / "configs"
                        / "cl100k-pretok-utf8.json").read_text())
    big = api.compile_tokenizer(conf["pat"], device=cuda, **conf["port"]["kwargs"],
                                config=EngineConfig(scan_backend="device"))
    small = api.compile_tokenizer(device=cuda)
    text = TEXT * 40
    want = [(m.count(text), m.presplit(text)) for m in (big, small)]
    for m, (count, starts) in zip((big, small), want):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            got = m.count(text), m.presplit(text)
            torch.cuda.synchronize()
        assert got[0] == count
        np.testing.assert_array_equal(got[1], starts)
        path = tmp_path / "trace.json"
        prof.export_chrome_trace(str(path))
        events = T.events_from_chrome(_json.loads(path.read_text()))
        tr = T.Trace(events, min(e.ts for e in events), max(e.end for e in events), 2, 0, 0)
        marks = [e for e in S.program(tr) if e.name == "rf.engine.global_table"]
        pairs, _ = S.enqueued(tr)
        chain = [c for d, c in pairs if d.cat == "kernel" and "dfa_chain" in d.name]
        assert chain
        inside = S.inside(chain, marks)
        assert all(inside) if m is big else not any(inside) and not marks
