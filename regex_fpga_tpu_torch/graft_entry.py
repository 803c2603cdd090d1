"""Single-card entry point and a multi-rank dry run of the torch port.

The counterpart of the repository's ``__graft_entry__.py``. ``entry()``
returns a function and its arguments: one scan of the fast DFA engine (K1's
chain pass) over the GPT-2 pre-split tokenizer DFA.

``dryrun_multichip(n)`` starts n ranks (``spawn_ranks``: NCCL on n cards,
or gloo on the CPU when the caller passes ``device="cpu"``), builds a (data x seq) mesh over them and
runs every distributed engine once on small shapes, each held to a serial
reference: the fast and the k-gram DFA scans, chunked ingest with a
checkpoint resumed across a chunk boundary, the data-parallel NFA scan on the
l7-filter ruleset (when the reference fixtures are present), the
tensor-parallel NFA scan on a 600-state automaton and the ruleset-parallel
scan on n rulesets of unequal sizes.
"""

from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np
import torch

__all__ = ["dryrun_multichip", "entry"]


def entry(device=None):
    """(fn, args): ``fn(*args)`` runs one fast scan of 4,096 random class
    ids in 16 blocks on ``device`` (default: the card) and returns the
    final state."""
    from .models import build_tokenizer_dfa
    from .ops.dfa_fast import dfa_scan_fast
    from .ops.tables import build_dfa_tables, resolve_device

    dev = resolve_device(device)
    tok = build_tokenizer_dfa()
    dt = build_dfa_tables(tok.table, tok.accept, device=dev)
    rng = np.random.default_rng(0)
    classes = torch.as_tensor(
        rng.integers(0, dt.num_classes, size=4096, dtype=np.int32), device=dev)

    def fn(tables, classes):
        return dfa_scan_fast(tables, classes, num_blocks=16).final_state

    return fn, (dt, classes)


def _uneven_nfa(seed: int):
    from .models import CsrAutomaton

    r = np.random.default_rng(seed)
    ns = 17 + 4 * seed  # unequal state counts exercise the padding
    ne = 6 * ns
    src = np.sort(r.integers(0, ns - 3, size=ne))
    return CsrAutomaton(
        offsets=np.searchsorted(src, np.arange(ns + 1)).astype(np.int64),
        trans_char=r.integers(0, 256, size=ne).astype(np.uint8),
        trans_target=r.integers(0, ns, size=ne).astype(np.int32),
    )


def _dryrun_rank(n_devices: int, device: str, work: str) -> str:
    """One rank of ``dryrun_multichip``; returns its summary line."""
    from .models import CsrAutomaton, build_tokenizer_dfa, load_coe, nfa_scan
    from .models.csr import prefix_automaton
    from .ops.dfa_engine import dfa_scan_serial
    from .ops.kgram import build_kgram, map_kgram_classes
    from .ops.tables import build_dfa_tables, build_nfa_csr, build_nfa_tables
    from .parallel import (dfa_scan_fast_dist, dfa_scan_kgram_dist, make_mesh,
                           make_tp_mesh, multi_ruleset_scan, nfa_scan_dist,
                           nfa_scan_tp, stack_nfa_tables)
    from .parallel.ingest import (CheckpointStore, dist_resilient_scan,
                                  iter_batch_chunks)
    from .utils.traces import reference_root

    dev = torch.device(device)
    n_data = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    n_seq = n_devices // n_data
    mesh = make_mesh(n_data, n_seq)
    rng = np.random.default_rng(0)

    # sequence- and data-parallel fast scan: 32 blocks of 2,048 bytes a seq
    # shard, 2 streams a data shard
    tok = build_tokenizer_dfa()
    dt = build_dfa_tables(tok.table, tok.accept, device=dev)
    batch = 2 * n_data
    length = n_seq * 32 * 2048
    streams = rng.integers(0, 256, size=(batch, length)).astype(np.uint8)
    classes = dt.class_of[torch.as_tensor(streams, device=dev).long()]
    finals, counts, converged = dfa_scan_fast_dist(
        mesh, dt, classes, blocks_per_shard=32, start=tok.start)
    assert converged, "seam fixpoint must converge at this scale"
    for i in range(batch):
        ser = dfa_scan_serial(dt, streams[i], start=tok.start)
        assert int(finals[i]) == int(ser.final_state)
        assert int(counts[i]) == int(ser.counts.sum())

    # the k-gram counting engine on the same mesh
    kg = build_kgram(dt, levels=2)
    lk = n_seq * 32 * 512  # k-gram steps a stream, 4 bytes each
    kstreams = rng.integers(0, 256, size=(batch, lk * kg.k)).astype(np.uint8)
    ck = torch.stack([map_kgram_classes(kg, s) for s in kstreams]).to(dev)
    kfinals, ktotals, kconv = dfa_scan_kgram_dist(
        mesh, torch.as_tensor(kg.table, device=dev),
        torch.as_tensor(kg.acc_table, device=dev), ck, blocks_per_shard=32,
        start=tok.start, acc_bound=kg.k)
    assert kconv, "k-gram seam fixpoint must converge at this scale"
    for i in range(batch):
        ser = dfa_scan_serial(dt, kstreams[i], start=tok.start)
        assert int(kfinals[i]) == int(ser.final_state)
        assert int(ktotals[i]) == int(ser.counts.sum())

    # chunked ingest x mesh scan x checkpoint: 2 chunks, a checkpoint after
    # chunk 1, and a resume across the boundary equal to the unbroken run
    chunk_len = n_seq * 32 * 2048
    corpus = rng.integers(0, 256, size=(batch, 2 * chunk_len)).astype(np.uint8)
    store = os.path.join(work, "carry.npz")
    dist_resilient_scan(mesh, dt, iter_batch_chunks(corpus[:, :chunk_len],
                                                    chunk_len),
                        blocks_per_shard=32, start=tok.start,
                        store=CheckpointStore(store))
    resumed = dist_resilient_scan(mesh, dt, iter_batch_chunks(corpus, chunk_len),
                                  blocks_per_shard=32, start=tok.start,
                                  store=CheckpointStore(store))
    unbroken = dist_resilient_scan(mesh, dt, iter_batch_chunks(corpus, chunk_len),
                                   blocks_per_shard=32, start=tok.start)
    assert int(resumed["offset"]) == 2 * chunk_len
    np.testing.assert_array_equal(resumed["counts"], unbroken["counts"])
    np.testing.assert_array_equal(resumed["states"], unbroken["states"])

    # data-parallel NFA scan on the l7-filter ruleset, held to the oracle
    coe = os.path.join(reference_root(), "Block_Mem/CSR_BlockMem.coe")
    nfa_shape = "skipped (no reference)"
    aut = load_coe(coe) if os.path.exists(coe) else None
    if aut is not None:
        nfa_len = 16384
        nfa_streams = rng.integers(0, 256, size=(n_data * n_seq, nfa_len)) \
            .astype(np.uint8)
        per_stream, _ = nfa_scan_dist(mesh, build_nfa_csr(aut, device=dev),
                                      nfa_streams)
        for i in range(nfa_streams.shape[0]):
            np.testing.assert_array_equal(per_stream[i].cpu().numpy(),
                                          nfa_scan(aut, nfa_streams[i]))
        nfa_shape = f"S={aut.num_states} x {nfa_len} B/stream, oracle-exact"

    # tensor-parallel: the states sharded over the model axis, on a
    # ruleset prefix of 600 states (a synthetic one without the reference)
    rng2 = np.random.default_rng(1)
    if aut is not None:
        tp_aut = prefix_automaton(aut, 600)
    else:
        ns, ne = 600, 3600
        src = np.sort(rng2.integers(0, ns - 5, size=ne))
        tp_aut = CsrAutomaton(
            offsets=np.searchsorted(src, np.arange(ns + 1)).astype(np.int64),
            trans_char=rng2.integers(0, 256, size=ne).astype(np.uint8),
            trans_target=rng2.integers(0, ns, size=ne).astype(np.int32),
        )
    tp_mesh = make_tp_mesh(n_model=n_seq, n_data=n_data)
    tp_len = 2048
    tp_streams = rng2.integers(0, 256, size=(n_data, tp_len)).astype(np.uint8)
    tp_counts, _ = nfa_scan_tp(tp_mesh, build_nfa_csr(tp_aut, device=dev),
                               tp_streams)
    for i in range(n_data):
        np.testing.assert_array_equal(tp_counts[i].cpu().numpy(),
                                      nfa_scan(tp_aut, tp_streams[i]))

    # ruleset parallelism: n rulesets of unequal sizes over every rank
    ep_auts = [_uneven_nfa(s) for s in range(n_devices)]
    stacked = stack_nfa_tables([build_nfa_tables(a, device=dev)
                                for a in ep_auts])
    ep_len = 4096
    ep_stream = rng.integers(0, 256, size=ep_len).astype(np.uint8)
    ep_counts = multi_ruleset_scan(mesh, stacked, ep_stream).cpu().numpy()
    for r_i, a in enumerate(ep_auts):
        np.testing.assert_array_equal(ep_counts[r_i, : a.num_states],
                                      nfa_scan(a, ep_stream))
    sizes = sorted({a.num_states for a in ep_auts})
    return (f"dryrun_multichip ok: mesh={n_data}x{n_seq} "
            f"({torch.distributed.get_backend()} on {device}), "
            f"dfa converged={converged}, kgram converged={kconv}, "
            f"bytes/rank={length * batch // n_devices} (fast/kgram/chunked), "
            f"axes=dp+sp fast DFA, dp+sp k-gram, chunked dist_resilient_scan "
            f"(2 chunks, checkpoint resume across the boundary, exact vs "
            f"unbroken), dp NFA [{nfa_shape}], tp NFA [S={tp_aut.num_states} "
            f"x {tp_len} B, oracle-exact], ep {n_devices}-ruleset [unequal "
            f"S={sizes[0]}..{sizes[-1]}, {ep_len} B, oracle-exact]")


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """Run the dry run on ``n_devices`` ranks: NCCL, a card a rank, by
    default (raises when fewer cards are visible); gloo on the CPU when
    ``device="cpu"``. Prints rank 0's summary."""
    from .parallel.multihost import spawn_ranks

    if n_devices < 1:
        raise ValueError("the dry run needs at least one rank")
    device = torch.device(device).type
    if device == "cuda":
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_devices > visible:
            raise RuntimeError(f"dryrun_multichip({n_devices}) needs {n_devices} "
                               f"CUDA cards, {visible} visible; pass "
                               f"device='cpu' for gloo ranks on the CPU")
        backend = "nccl"
    elif device == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no dry run on {device}")
    work = tempfile.mkdtemp(prefix="dryrun_")
    try:
        lines = spawn_ranks(_dryrun_rank, n_devices, backend, device,
                            args=(n_devices, device, work))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(lines[0])


if __name__ == "__main__":
    fn, args = entry()
    print("entry:", int(fn(*args)))
    dryrun_multichip(torch.cuda.device_count())
