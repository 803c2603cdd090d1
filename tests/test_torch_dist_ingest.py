"""The port's chunked ingest (regex_fpga_tpu_torch.parallel.ingest) against
the JAX package's: the cases of tests/test_dist_ingest.py and
tests/test_ingest_cli.py (the host utilities, resume at a chunk boundary,
non-convergence raised and not retried, no leak from an abandoned prefetch,
order and worker errors, retries and checkpoints), at world size 1 in this
process and on 4 gloo ranks on the CPU in one spawn ((2, 2) and (1, 4)).
Tolerance: none; carries are integers."""

import threading
import time

import numpy as np
import jax
import pytest

import regex_fpga_tpu_torch.parallel.ingest as tingest
import torch_dist_ranks as R
from regex_fpga_tpu.models import build_tokenizer_dfa
from regex_fpga_tpu.ops import build_dfa_tables
from regex_fpga_tpu.ops.kgram import build_kgram
from regex_fpga_tpu.parallel import make_mesh
from regex_fpga_tpu.parallel.ingest import (dist_resilient_scan,
                                            iter_batch_chunks)
from regex_fpga_tpu_torch.ops.tables import build_dfa_tables as tbuild
from regex_fpga_tpu_torch.parallel import make_mesh as tmesh
from regex_fpga_tpu_torch.parallel.multihost import spawn_ranks

TOK = build_tokenizer_dfa()


def _corpus(rng, batch, length):
    text = b"GET /index.html HTTP/1.1 Host: example.com 2026 !! " * 64
    reps = np.frombuffer(text * (length // len(text) + 1), np.uint8)[:length]
    out = np.stack([np.roll(reps, 17 * i) for i in range(batch)])
    noise = rng.integers(0, 256, size=out.shape)
    mask = rng.random(out.shape) < 0.1
    return np.where(mask, noise, out).astype(np.uint8)


def _cycle5():
    table = np.zeros((256, 5), dtype=np.int32)
    for s in range(5):
        table[:, s] = (s + 1) % 5
    return table, np.array([False, True, False, False, False])


def _cases(shapes, seed):
    rng = np.random.default_rng(seed)
    cases = []
    for nd, ns in shapes:
        for levels in (0, 2):
            k = 4 if levels else 1
            chunk = ns * 4 * 16 * k
            cases.append(("ingest", dict(
                n_data=nd, n_seq=ns, table=TOK.table, accept=TOK.accept,
                streams=_corpus(rng, 2 * nd, 3 * chunk), chunk_len=chunk, bps=4,
                start=int(TOK.start), levels=levels)))
        table, accept = _cycle5()
        cases.append(("ingest", dict(  # 64 x ns blocks >> max_iters 16
            n_data=nd, n_seq=ns, table=table, accept=accept,
            streams=np.zeros((nd, ns * 64 * 16), np.uint8),
            chunk_len=ns * 64 * 16, bps=64, start=0)))
    return cases


CASES1 = _cases([(1, 1)], 1)
CASES4 = _cases([(2, 2), (1, 4)], 4)


def _jax(kw):
    nd, ns = kw["n_data"], kw["n_seq"]
    mesh = make_mesh(nd, ns, devices=jax.devices()[:nd * ns])
    dt = build_dfa_tables(kw["table"], kw["accept"])
    kg = build_kgram(dt, levels=kw["levels"]) if kw.get("levels") else None
    try:
        carry = dist_resilient_scan(
            mesh, dt, iter_batch_chunks(kw["streams"], kw["chunk_len"]),
            kgram=kg, blocks_per_shard=kw["bps"], start=kw["start"],
            max_retries=0, retry_delay=0.0)
    except RuntimeError as e:
        return ("raised", type(e).__name__, str(e))
    return carry


def _check(kw, got):
    want = _jax(kw)
    if isinstance(want, tuple):  # non-convergence: the same error
        assert tuple(got) == want
        return
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
        assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype, key


@pytest.mark.parametrize("i", range(len(CASES1)))
def test_world_size_one_matches_jax(i):
    _check(CASES1[i][1], R.run_cases([CASES1[i]])[0])


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The cases, then a run that dies after two chunks and one resumed from
    its checkpoint (a path every rank shares)."""
    store = str(tmp_path_factory.mktemp("ingest") / "carry.npz")
    kw = dict(CASES4[0][1])
    resume = [("ingest", dict(kw, stop_after=2, store=store)),
              ("ingest", dict(kw, store=store))]
    return spawn_ranks(R.run_cases, 4, device="cpu", args=(CASES4 + resume,))


@pytest.mark.parametrize("i", range(len(CASES4)))
def test_four_gloo_ranks_match_jax(four_ranks, i):
    for r in four_ranks:
        _check(CASES4[i][1], r[i])


def test_four_gloo_ranks_resume_at_a_chunk_boundary(four_ranks):
    kw = CASES4[0][1]
    n = len(CASES4)
    for r in four_ranks:
        assert int(r[n]["offset"]) == 2 * kw["chunk_len"]
        _check(kw, r[n + 1])


def test_resume_at_chunk_boundary(tmp_path):
    """The run dies at a chunk boundary (ingest raises after two chunks); a
    fresh run with the same store resumes from the boundary, exactly."""
    rng = np.random.default_rng(2)
    dt = tbuild(TOK.table, TOK.accept)
    chunk_len = 4 * 64
    streams = _corpus(rng, 2, 4 * chunk_len)
    store = tingest.CheckpointStore(str(tmp_path / "carry.npz"))

    def dying_chunks():
        for i, item in enumerate(tingest.iter_batch_chunks(streams, chunk_len)):
            if i == 2:
                raise OSError("simulated host death at chunk boundary")
            yield item

    with pytest.raises(OSError):
        tingest.dist_resilient_scan(tmesh(1, 1), dt, dying_chunks(),
                                    blocks_per_shard=4, start=TOK.start,
                                    store=store, max_retries=0)
    assert int(store.load()["offset"]) == 2 * chunk_len
    carry = tingest.dist_resilient_scan(
        tmesh(1, 1), dt, tingest.iter_batch_chunks(streams, chunk_len),
        blocks_per_shard=4, start=TOK.start, store=store)
    _check(dict(n_data=1, n_seq=1, table=TOK.table, accept=TOK.accept,
                streams=streams, chunk_len=chunk_len, bps=4,
                start=int(TOK.start)), carry)


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_prefetch_depth_does_not_change_the_carry(depth):
    rng = np.random.default_rng(depth)
    dt = tbuild(TOK.table, TOK.accept)
    streams = _corpus(rng, 2, 3 * 256)
    kw = dict(blocks_per_shard=4, start=TOK.start)
    a = tingest.dist_resilient_scan(
        tmesh(1, 1), dt, tingest.iter_batch_chunks(streams, 256),
        prefetch_depth=depth, **kw)
    b = dist_resilient_scan(make_mesh(1, 1, devices=jax.devices()[:1]),
                            build_dfa_tables(TOK.table, TOK.accept),
                            iter_batch_chunks(streams, 256), **kw)
    for key in b:
        np.testing.assert_array_equal(a[key], np.asarray(b[key]))


def test_nonconvergence_not_retried(monkeypatch):
    """Deterministic non-convergence surfaces at once: no retry sleeps."""
    table, accept = _cycle5()
    dt = tbuild(table, accept)
    streams = np.zeros((2, 64 * 64), np.uint8)
    sleeps = []
    monkeypatch.setattr(tingest.time, "sleep", sleeps.append)
    with pytest.raises(tingest.NonRetryableScanError, match="did not converge"):
        tingest.dist_resilient_scan(
            tmesh(1, 1), dt, tingest.iter_batch_chunks(streams, streams.shape[1]),
            blocks_per_shard=64, max_iters=4, max_retries=5)
    assert sleeps == []


def test_prefetch_abandoned_consumer_no_leak():
    before = threading.active_count()

    def chunks():
        for i in range(100):
            yield i, np.zeros(8, np.uint8)

    gen = tingest.prefetch_chunks(chunks(), depth=1)
    next(gen)
    gen.close()
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_prefetch_chunks_preserves_order_and_values(tmp_path):
    path = tmp_path / "data.bin"
    data = np.arange(4096, dtype=np.int64).astype(np.uint8)
    data.tofile(path)
    plain = list(tingest.iter_file_chunks(str(path), 512))
    pre = list(tingest.prefetch_chunks(tingest.iter_file_chunks(str(path), 512),
                                       prepare=lambda c: c * 2))
    assert [o for o, _ in pre] == [o for o, _ in plain]
    for (_, a), (_, b) in zip(pre, plain):
        np.testing.assert_array_equal(a, b * 2)


def test_prefetch_chunks_propagates_worker_error():
    def bad_iter():
        yield 0, np.zeros(4, np.uint8)
        raise RuntimeError("ingest failed")

    it = tingest.prefetch_chunks(bad_iter())
    next(it)
    with pytest.raises(RuntimeError, match="ingest failed"):
        list(it)


def test_iter_file_chunks_and_shard_files(tmp_path):
    from regex_fpga_tpu.parallel.ingest import iter_file_chunks, shard_files

    path = tmp_path / "data.bin"
    np.arange(1000, dtype=np.uint8).tofile(path)
    got = list(tingest.iter_file_chunks(str(path), 256, offset=3))
    want = list(iter_file_chunks(str(path), 256, offset=3))
    assert [o for o, _ in got] == [o for o, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    paths = []
    for i, size in enumerate([10, 500, 300, 50, 70]):
        p = tmp_path / f"f{i}.bin"
        p.write_bytes(b"x" * size)
        paths.append(str(p))
    for host in range(2):
        assert tingest.shard_files(paths, host, 2) == shard_files(paths, host, 2)


def test_resilient_scan_retries_and_checkpoints(tmp_path):
    store = tingest.CheckpointStore(str(tmp_path / "ckpt.npz"))
    failures = {"left": 2}

    def scan_chunk(chunk, carry):
        if failures["left"] > 0 and chunk[0] == 100:
            failures["left"] -= 1
            raise RuntimeError("injected fault")
        total = (carry["total"] if carry else 0) + int(chunk.sum())
        return {"total": np.int64(total)}

    data = np.arange(200, dtype=np.uint8)
    chunks = [(0, data[:100]), (100, data[100:])]
    carry = tingest.resilient_scan(scan_chunk, chunks, store=store,
                                   retry_delay=0.0)
    assert int(carry["total"]) == int(data.sum())
    assert failures["left"] == 0
    carry2 = tingest.resilient_scan(scan_chunk, chunks, store=store,
                                    retry_delay=0.0)
    assert int(carry2["total"]) == int(data.sum())
    assert int(store.load()["offset"]) == 200


def test_resilient_scan_persistent_failure():
    def scan_chunk(chunk, carry):
        raise RuntimeError("always fails")

    with pytest.raises(RuntimeError, match="always fails"):
        tingest.resilient_scan(scan_chunk, [(0, np.zeros(10, np.uint8))],
                               max_retries=1, retry_delay=0.0)


def test_public_names_match_jax():
    import regex_fpga_tpu.parallel as jp
    import regex_fpga_tpu.parallel.comm_model as jc
    import regex_fpga_tpu.parallel.ingest as ji
    import regex_fpga_tpu_torch.parallel as tp
    import regex_fpga_tpu_torch.parallel.comm_model as tc

    assert set(jp.__all__) <= set(tp.__all__)
    assert set(ji.__all__) <= set(tingest.__all__)
    for name in ji.__all__:
        assert hasattr(tingest, name)
    # the TPU's link constants do not come across
    assert set(jc.__all__) - set(tc.__all__) == {"V5E_ICI_LINK_BPS",
                                                 "COLLECTIVE_LATENCY_S"}
