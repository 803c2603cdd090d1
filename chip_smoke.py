#!/usr/bin/env python3
"""Smoke test of the torch port (regex_fpga_tpu_torch) on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py [--out DIR]

Phases, each printing its own lines; any failure raises and exits non-zero:

1. device: needs a CUDA card; prints the card's name and power limit as
   nvidia-smi reports them, then builds the Hopper kernels from
   regex_fpga_tpu_torch/csrc with nvcc and the native host walker from
   native/golden_scan.cpp with g++, and prints the build times;
2. kernels: K1 (dfa_chain, all three modes), K2 (dfa_chain_counts, single
   and per-stream, on random class ids and on real text) and K3
   (kgram_chain over class ids and kgram_chain_bytes over raw text) against
   their plain PyTorch versions on the card at the main path's shapes, bit
   for bit, with the time, the bound, the chain floor (steps x the measured
   latency of a dependent shared-memory load) and the route (table
   placement and narrowing, histogram, lanes per CTA) of each; then K1/K2
   on a lazy-DFA snapshot of the Snort-corpus NFA (the narrowed shared
   table; and padded to 2,049 columns, the global-memory table that the
   warmed main path launches) and K4 (nfa_active_scan) on both of its
   routes: the l7-corpus NFA (CSR in shared memory, a forced overflow
   included) and a Snort-corpus prefix (CSR in global memory); then K4
   alone on the main path's 64 flows of 1 MiB; then the package surface:
   every name of the package-level __all__ lists (ops, utils, models,
   parallel) and of utils.native resolves with no JAX loaded, and
   ops.dfa_scan_blocked (Aho-Corasick over 64 MiB of keyword traffic, its
   K6, combine and K1 launches counted from 0) and
   utils.native.nfa_match_positions_native (the l7-corpus NFA over 128 KiB)
   equal a serial native walk and the oracle's trace;
3. DFA main path: the tokenizer and a 300-keyword Aho-Corasick matcher
   through the port's API at a 64 MiB chunk and 65,536 lanes, each call
   timed as the median of REPEATS runs; every result is held to the same
   call on the CPU (the plain path) or to a host walk, and the launch
   counts show that each kernel ran;
4. NFA main path: compile_ruleset on the 35,259-state Snort-corpus content
   NFA ("lazy-device" over one 64 MiB stream, "lazy" over it and over 64
   flows of 1 MiB) and on the 722-state l7-corpus NFA ("active-set" over 64
   flows of 1 MiB), each timed as the median of REPEATS runs and held
   bit for bit to the host walk of the portable native build (and a
   prefix to the Python oracle); the launch counts show that K1, K2 and K4
   ran;
5. spans and the matcher surface, each call timed as the median of REPEATS
   runs with the kernels it launched: compile_regex(...).finditer_arrays over
   64 MiB of Snort-corpus traffic (three patterns, one with groups; held to
   the CPU path over 64 MiB and to Python re, search, sub and groups over 1
   MiB), a 300-keyword literal set (scan_patterns over 64 MiB, held to the
   native host walk folded per pattern; finditer over 4 MiB, held to a
   bytes.find loop), the l7 corpus as a mixed anchored rule set
   ("lazy-device" over 64 MiB, "active-set" over 64 flows of 1 MiB, and
   prefiltered on "active-set" over 64 flows of 64 KiB that hold different
   literals; each held to the "lazy" host walk's per-rule counts), the host
   matchers (a \b pattern over 4 MiB, a backreference over 1 MiB; held to
   the CPU path and to Python re) and re_compat (count over 64 MiB on the
   k-gram engine, held to the native host walk; findall over 1 MiB, held to
   re.findall); the launch counts show that K1, K2, K3 and K4 ran;
6. the IDS front door, each call timed as the median of IDS_REPEATS runs:
   compile_snort over the 3,000-rule community-scale corpus and 4,000
   payloads of its traffic (the route of K2 for each prefilter automaton,
   GB/s, the split between stage 1 on the card and the host verify, the
   candidate and alert counts; every planted sid alerts, stage 1 equals a
   native walk of every payload, and alerts, candidates and the enforcement
   report equal the CPU path), then K2 at that shape against its plain
   version; compile_l7 over the 110 l7-corpus .pat files under
   "lazy-device" (8 MiB), "active-set" (8 flows of 1 MiB) and prefiltered
   (8 flows of 64 KiB), each held to compile_regex_set's per-rule counts;
   and the CLI (python -m regex_fpga_tpu_torch) as subprocesses: grep -c
   over 64 MiB, grep, acgrep, rgrep, snort, snort --coverage, compile-rules
   --scan, scan, gen-corpus and presplit, each held to the in-process API
   and to the JAX CLI's exit code, with its wall time;
7. the engine router and the exact fallback: 55 counting calls that the
   priors' fit uses (the tokenizer, 300- and 1,500-keyword Aho-Corasick
   automata and the two Snort prefilter automata; 4 KiB, 1 MiB and 64 MiB
   in 1, 4 and 64 streams, one stream of 256 KiB, and the Snort batch of
   4,000 payloads), 20 held-out single streams of sizes no fit uses (6, 12,
   64 and 128 KiB), and a contested 4 x 64 MiB batch that probes both
   engines, all under "device", "host" and "auto", each held to a serial
   native walk (counts and final states), with the median GB/s of both
   engines, the route "auto" took and its rate against the better engine's,
   and the router's model beside them; the Snort call under "auto" and
   "device"; K6 pass 1 (dfa_block_fns) against its plain version on the
   parity and reversed (aa)*b automata over 16 and 64 MiB and on the
   Aho-Corasick table and a permutation automaton of its shape (no two
   chains ever meet) over 64 MiB, with its route and two floors (the
   shared-load floor of all S x B loads a block, and the merging design's: one
   chain of B dependent loads, or the loads this data's merging needs at
   the issue rate); K6's combine (dfa_fn_combine) against the doubling at
   S = 2, 3 and 836 in dfa_scan_blocked's groups, from a start other than
   0, constant functions mixed in; the combine's contract on the card
   (dfa_engine.block_entry_states raises the CPU's ValueError on a function
   entry or a tensor start outside [0, S), before any launch); the
   DfaMatcher calls that take the exact fallback (one combine a group, and
   no range check inside them), each with its GB/s and a split of its time (class map,
   pass 1, combine, pass 2, counts; CUDA events); the k-gram gate sweep (K2 and K3 at
   k = 2, 4 and 8 for S = 23, 32, 67, 107, 836 and 4,008); and the
   router's priors fitted from this run beside the committed ones;
8. parallel/ on torch.distributed and K5 (nfa_tp_scan): K5 against its
   plain version on the l7-corpus NFA (4 x 16 KiB) and the Snort-corpus NFA
   (4 x 2 KiB), two chunks against one run; K5 and its step on random NFAs
   of 1,023, 1,024 and 1,025 states (both bitmap routes) and one with every
   state active on every byte, over 301 streams of 333 bytes and 5 of 0
   bytes; K5's sharded step (nfa_tp_step, the multi-rank route) on l7 (4 x
   4 KiB) against K5 and its plain version; each with its route; then, counting the launches of the main path's own
   calls only (not their references), the CLI's corpus as a subprocess over 1 GiB of synthetic text
   and a 12,345-byte tail (held to a native serial walk); in process with
   an NCCL group of one rank, dist_resilient_scan over 4 streams x 256 MiB
   in chunks of 64 MiB (k=1 and k-gram, prefetch depths 2 and 0, a run
   stopped after chunk 2 and resumed from its checkpoint; GB/s beside
   count()'s, the host copy's share), dfa_scan_fast_dist and
   dfa_scan_kgram_dist over 4 x 64 MiB (against one device and the native
   walk), nfa_scan_dist over 64 flows of 1 MiB of l7 traffic,
   multi_ruleset_scan over four l7 rulesets and nfa_scan_tp (K5) over the
   l7 flows (held to K4 and the lazy walk) and over 132 flows of 64 KiB of
   Snort traffic (held to the native lazy walk); K5's time at both shapes
   beside the first design's, its bound and its floor (bytes x one
   dependent shared load and the barrier of one warp, csrc/smem_chase.cu's
   sync_chase); and last two ranks on the one card over gloo (fast and
   k-gram scans on a (1, 2) seq mesh, the multi-rank nfa_scan_tp on a (1, 2)
   model mesh: a launch of K5's step and an all_reduce a byte), each equal
   to world size 1;
9. the kernels JSON line, then {"ok": true, "device": ...} as the last line.

``--out DIR`` also writes nvcc's report and the results there.
``--tp-ranks N`` runs only phase 1 and phase 8's multi-rank scans (rank_program)
on N NCCL ranks, a card each, against world size 1 (on a machine with N
cards).
``--profile`` adds, after phase 6, one torch.profiler run of each API call
that uses the card (device time in copies and in kernels, and the idle share
of the call's wall time) and the host-to-device copy of 64 MiB from pageable
and from pinned memory. The script imports torch, numpy and the port, and nothing
of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

MIB = 1 << 20
ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
REPEATS = 5  # timed runs per API call in phases 3-5; the median is reported

# bench.py's synthetic text: word-like structure, so the tokenizer DFA does
# real work
FRAG = (b"The quick brown fox jumps over 1234 lazy dogs, it's 99.5% fine!  "
        b"pre-split   benchmark text \xc3\xa9t\xc3\xa9 2026... ")

# bench.py's keyword list for its Aho-Corasick size sweep
WORDS = [w % i for i in range(300)
         for w in (b"error%04d", b"warning%03d", b"GET /path%d HTTP",
                   b"user-agent: bot%d", b"fail%dure")]

KERNELS = {  # name -> (route, source, the TPU kernel it replaces)
    "dfa_chain": ("cuda", "regex_fpga_tpu_torch/csrc/dfa_chain.cu",
                  "regex_fpga_tpu/ops/pallas_dfa.py:126"),
    "dfa_chain_counts": ("cuda", "regex_fpga_tpu_torch/csrc/dfa_chain.cu",
                         "regex_fpga_tpu/ops/pallas_dfa.py:196"),
    "kgram_chain": ("cuda", "regex_fpga_tpu_torch/csrc/kgram_chain.cu",
                    "regex_fpga_tpu/ops/pallas_kgram.py:65"),
    "kgram_chain_bytes": ("cuda", "regex_fpga_tpu_torch/csrc/kgram_chain.cu",
                          "regex_fpga_tpu/ops/pallas_kgram.py:65"),
    "nfa_active_scan": ("cuda", "regex_fpga_tpu_torch/csrc/nfa_active.cu",
                        "regex_fpga_tpu/ops/nfa_engine.py:43"),
    "dfa_block_fns": ("cuda", "regex_fpga_tpu_torch/csrc/dfa_block_fns.cu",
                      "regex_fpga_tpu/ops/dfa_engine.py:78"),
    "dfa_fn_combine": ("cuda", "regex_fpga_tpu_torch/csrc/dfa_block_fns.cu",
                       "regex_fpga_tpu/ops/dfa_engine.py:94"),
    "nfa_tp_scan": ("cuda", "regex_fpga_tpu_torch/csrc/nfa_tp_scan.cu",
                    "regex_fpga_tpu/parallel/tp_scan.py:65"),
    "nfa_tp_step": ("cuda", "regex_fpga_tpu_torch/csrc/nfa_tp_scan.cu",
                    "regex_fpga_tpu/parallel/tp_scan.py:122"),
}
# no single PyTorch call computes a chain pass or an active-set step, so
# there is no library call to time beside the kernels
LIBRARY_MS = None
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate (NVIDIA data sheet)
DFA_PATH = ("dfa_chain", "dfa_chain_counts", "kgram_chain", "kgram_chain_bytes")
NFA_PATH = ("dfa_chain", "dfa_chain_counts", "nfa_active_scan")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def event_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def wall_ms(fn, reps: int) -> list[float]:
    """Host-clock milliseconds of ``reps`` runs of ``fn``, each ended by a
    device synchronize."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def max_abs_err(got, want) -> int:
    err = 0
    for g, w in zip(got, want):
        check((g is None) == (w is None), "output presence")
        if g is not None:
            check(g.shape == w.shape, f"shape {tuple(g.shape)} vs {tuple(w.shape)}")
            d = (g.long() - w.long()).abs()
            err = max(err, int(d.max()) if d.numel() else 0)
    return err


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound_ms(inputs, outputs) -> float:
    """The least time the card could take: every input read once and every
    output written once at the device-memory rate. A chain pass does one
    dependent table lookup per byte and no arithmetic worth a peak rate, so
    the bytes bound it."""
    return (nbytes(*inputs) + nbytes(*outputs)) / HBM_BYTES_PER_S * 1e3


def chase_ns(entry_bytes: int, spread: bool = True) -> float:
    """The measured latency of a dependent shared-memory load, nanoseconds:
    one warp follows a cycle of table entries (csrc/smem_chase.cu), its 32
    lanes in 32 banks (``spread``) or all in one bank; the difference of two
    step counts, so that launch and fill cancel."""
    from regex_fpga_tpu_torch import _build

    lib = _build.library()
    out = torch.empty(32, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run(steps):
        return lambda: _build.check(
            lib.smem_chase(entry_bytes, steps, int(spread), out.data_ptr(), stream),
            "smem_chase")
    return (event_ms(run(8192), 20) - event_ms(run(4096), 20)) / 4096 * 1e6


def launch_counters() -> dict:
    """Every kernel wrapper's launch counter, by kernel name."""
    from regex_fpga_tpu_torch.ops import hopper_dfa, hopper_kgram, hopper_nfa

    return {**hopper_dfa.LAUNCHES, **hopper_kgram.LAUNCHES,
            **hopper_nfa.LAUNCHES}


def reset_launches() -> None:
    from regex_fpga_tpu_torch.ops import hopper_dfa, hopper_kgram, hopper_nfa

    for launches in (hopper_dfa.LAUNCHES, hopper_kgram.LAUNCHES,
                     hopper_nfa.LAUNCHES):
        for k in launches:
            launches[k] = 0


@contextlib.contextmanager
def counted(into: dict):
    """Adds the kernel launches made inside the block to ``into``: a main
    path's own calls go in such a block, their references outside it."""
    before = launch_counters()
    try:
        yield
    finally:
        for k, v in launch_counters().items():
            into[k] = into.get(k, 0) + v - before[k]


def forced(m, backend: str):
    """A copy of matcher ``m`` whose counting scans take ``backend``
    ("device" or "host") instead of the engine router's choice."""
    import copy
    import dataclasses

    out = copy.copy(m)
    out.config = dataclasses.replace(m.config, scan_backend=backend)
    return out


def tiled(data: bytes, n: int) -> np.ndarray:
    return np.resize(np.frombuffer(data, np.uint8), n)


def host_walk(table, class_of, accept, data: np.ndarray, start: int):
    """Independent reference: a per-byte Python walk. Returns per-state
    accept-visit counts and the final state."""
    counts = np.zeros(table.shape[1], dtype=np.int64)
    s = start
    for b in data.tolist():
        if accept[s]:
            counts[s] += 1
        s = int(table[class_of[b], s])
    return counts, s


# ---------------------------------------------------------------- phase 1


def phase_device(out_dir):
    from regex_fpga_tpu_torch import _build, native

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"device: {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} card(s), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    info = _build.build()
    _build.library()
    print(f"build: nvcc {info.seconds:.2f} s, build and load "
          f"{time.perf_counter() - t0:.2f} s -> {os.path.relpath(info.path)}",
          flush=True)
    t0 = time.perf_counter()
    lib = native.library()
    print(f"build: native walker (g++ {' '.join(native.GXX_FLAGS)}) built and "
          f"loaded in {time.perf_counter() - t0:.2f} s -> "
          f"{os.path.relpath(lib._name)}", flush=True)
    if out_dir:
        with open(os.path.join(out_dir, "nvcc_report.txt"), "w") as f:
            f.write(info.log)


# ---------------------------------------------------------------- phase 2


def phase_kernels(dev, tok_tables, tok_start, ac_tables):
    """Each kernel against its plain version on the card. Returns per-kernel
    {"max_abs_err", "ms", "plain_ms"} at the main path's shapes."""
    from regex_fpga_tpu_torch.ops import hopper_dfa as hd
    from regex_fpga_tpu_torch.ops import hopper_kgram as hk
    from regex_fpga_tpu_torch.ops.kgram import (build_kgram, kgram_maps,
                                                map_kgram_classes, pack_ta)
    from regex_fpga_tpu_torch.ops.tables import tables_from_numpy

    rng = np.random.default_rng(SEED)
    # a random DFA whose (256, 1024) int32 table (1 MiB) exceeds shared memory
    big_t = rng.integers(0, 1024, size=(256, 1024)).astype(np.int32)
    big = tables_from_numpy(big_t, np.arange(256), rng.random(1024) < 0.2,
                            1024, device=dev)
    check(not hd.dfa_chain_route("finals", 256, 1024)["table_smem"],
          "the random table takes the global-memory route")
    nb = 65536
    cases = [  # name, tables, steps, class dtype, block-major storage
        ("tokenizer", tok_tables, 1024, torch.uint8, True),
        ("aho-corasick", ac_tables, 1024, torch.int32, False),
        ("random-global", big, 256, torch.uint8, True),
    ]
    errs = {name: 0 for name in DFA_PATH}
    routes = {}
    for name, t, b, dtype, block_major in cases:
        c, s = t.table.shape
        shape = (nb, b) if block_major else (b, nb)
        cls = torch.as_tensor(rng.integers(0, c, size=shape, dtype=np.int64),
                              device=dev).to(dtype)
        cls_seq = cls.T if block_major else cls
        ent = torch.as_tensor(rng.integers(0, s, size=nb).astype(np.int32),
                              device=dev)
        route = routes[name] = hd.dfa_chain_route("counts", c, s, nb, 64, dtype)
        for mode in hd.MODES:
            e = max_abs_err(hd.dfa_chain(t.table, t.accept, cls_seq, ent, mode),
                            hd.dfa_chain_plain(t.table, t.accept, cls_seq, ent, mode))
            errs["dfa_chain"] = max(errs["dfa_chain"], e)
        for streams in (None, 64):
            e = max_abs_err(
                hd.dfa_chain_counts(t.table, t.accept, cls_seq, ent, streams),
                hd.dfa_chain_counts_plain(t.table, t.accept, cls_seq, ent, streams))
            errs["dfa_chain_counts"] = max(errs["dfa_chain_counts"], e)
        torch.cuda.synchronize()
        print(f"kernels: {name} S={s} C={c} {nb}x{b} {str(dtype)[6:]} "
              f"{'block' if block_major else 'time'}-major, table "
              f"{route['table']}, accept bit "
              f"{'in the entry' if route['accept_folded'] else 'loaded'}, "
              f"histogram {route['hist']}, staging ring of {route['ring']} "
              f"windows, {route['lanes_per_cta']} lanes per CTA: K1 x3 modes, K2 single "
              f"and 64 streams bit-exact against plain (tolerance 0)", flush=True)

    # K3 at the tokenizer's level-2 k-gram shape: 64 MiB of text = 2^24 steps
    kg = build_kgram(tok_tables, levels=2)
    kg_ta = pack_ta(torch.as_tensor(kg.table), torch.as_tensor(kg.acc_table)).to(dev)
    kg_maps = kgram_maps(kg).to(dev)
    ck = torch.as_tensor(rng.integers(0, kg.table.shape[0], size=(nb, 256))
                         .astype(np.int32), device=dev)
    ent = torch.as_tensor(rng.integers(0, kg.num_states, size=nb)
                          .astype(np.int32), device=dev)
    errs["kgram_chain"] = max_abs_err(hk.kgram_chain(kg_ta, ck.T, ent),
                                      hk.kgram_chain_plain(kg_ta, ck.T, ent))
    ac_c, ac_s = ac_tables.table.shape
    big_cls = torch.as_tensor(rng.integers(0, ac_c, size=(4096, 256))
                              .astype(np.int16), device=dev)
    ent_ac = torch.zeros(4096, dtype=torch.int32, device=dev)
    k3_routes = [hk.kgram_chain_route(kg_ta, num_lanes=nb)["table"]]
    # an Aho-Corasick-sized table with counts up to 4 (the uint16 form) and
    # up to 300 (no narrow form: the wide table in global memory)
    for top in (4, 300):
        big_acc = torch.as_tensor(rng.integers(0, top + 1, size=(ac_c, ac_s))
                                  .astype(np.int32), device=dev)
        big_ta = pack_ta(ac_tables.table, big_acc)
        k3_routes.append(hk.kgram_chain_route(big_ta, class_dtype=torch.int16)
                         ["table"])
        errs["kgram_chain"] = max(errs["kgram_chain"], max_abs_err(
            hk.kgram_chain(big_ta, big_cls.T, ent_ac),
            hk.kgram_chain_plain(big_ta, big_cls.T, ent_ac)))
    check(k3_routes == ["shared uint16", "shared uint16", "global"],
          f"K3 routes {k3_routes}")
    # raw text in: the real text, block-major as DfaMatcher.count cuts it
    text = torch.as_tensor(np.resize(np.frombuffer(FRAG, np.uint8), nb * 1024),
                           device=dev)
    text3 = text.reshape(nb, 256, 4).transpose(0, 1)
    check(hk.kgram_chain_route(kg_ta, kg_maps)["table"] == "shared uint16",
          "kgram_chain_bytes keeps table and maps in shared memory")
    got_b = hk.kgram_chain_bytes(kg_ta, kg_maps, text3, ent)
    errs["kgram_chain_bytes"] = max(
        max_abs_err(got_b, hk.kgram_chain_bytes_plain(kg_ta, kg_maps, text3, ent)),
        max_abs_err(got_b, hk.kgram_chain(
            kg_ta, map_kgram_classes(kg, text).reshape(nb, 256).T, ent)))
    torch.cuda.synchronize()
    print(f"kernels: K3 tokenizer k=4 C_k={kg.table.shape[0]} S={kg.num_states} "
          f"{nb}x256: class ids int32 (table {k3_routes[0]}, staging ring of "
          f"{hk.kgram_chain_route(kg_ta, num_lanes=nb)['ring']} windows) and raw text "
          f"{nb}x256x4 uint8 (table and {kg_maps.size} map entries in shared "
          f"memory); AC-sized S={ac_s} int16 ids, counts to 4 (table "
          f"{k3_routes[1]}) and to 300 (table {k3_routes[2]}): bit-exact "
          f"against plain (tolerance 0)", flush=True)
    # K2 on real text, every lane from the tokenizer's start state: a
    # quarter of the steps count, on 11 of 23 states
    text_cls = torch.index_select(tok_tables.class_of, 0, text.int()) \
        .to(torch.uint8).reshape(nb, 1024).T
    ent0 = torch.full((nb,), tok_start, dtype=torch.int32, device=dev)
    for streams in (None, 64):
        want = hd.dfa_chain_counts_plain(tok_tables.table, tok_tables.accept,
                                         text_cls, ent0, streams)
        errs["dfa_chain_counts"] = max(errs["dfa_chain_counts"], max_abs_err(
            hd.dfa_chain_counts(tok_tables.table, tok_tables.accept, text_cls,
                                ent0, streams), want))
    hit_share = float(want[1].sum()) / text.numel()
    check(hit_share > 0.1, f"real text counts on {hit_share:.1%} of its steps")
    print(f"kernels: K2 tokenizer on real text {nb}x1024, single and 64 "
          f"streams, {hit_share:.1%} of the steps count: bit-exact against "
          f"plain (tolerance 0)", flush=True)
    for name, e in errs.items():
        check(e == 0, f"{name} differs from its plain version by {e}")

    # times at the main path's shape: the tokenizer over one 64 MiB chunk
    c, s = tok_tables.table.shape
    cls = torch.as_tensor(rng.integers(0, c, size=(nb, 1024)).astype(np.uint8),
                          device=dev).T
    ent = torch.zeros(nb, dtype=torch.int32, device=dev)
    tt, ta = tok_tables.table, tok_tables.accept
    timing = {
        "dfa_chain": lambda: hd.dfa_chain(tt, ta, cls, ent, "finals"),
        "dfa_chain_counts": lambda: hd.dfa_chain_counts(tt, ta, cls, ent),
        "kgram_chain": lambda: hk.kgram_chain(kg_ta, ck.T, ent),
        "kgram_chain_bytes":
            lambda: hk.kgram_chain_bytes(kg_ta, kg_maps, text3, ent),
    }
    plain = {
        "dfa_chain": lambda: hd.dfa_chain_plain(tt, ta, cls, ent, "finals"),
        "dfa_chain_counts": lambda: hd.dfa_chain_counts_plain(tt, ta, cls, ent),
        "kgram_chain": lambda: hk.kgram_chain_plain(kg_ta, ck.T, ent),
        "kgram_chain_bytes":
            lambda: hk.kgram_chain_bytes_plain(kg_ta, kg_maps, text3, ent),
    }
    # the same chunk through the other modes, and the other tables: the
    # Aho-Corasick DFA (shared memory above 48 KB) and the random table
    # (global memory)
    ac_cls = torch.as_tensor(rng.integers(0, ac_tables.table.shape[0],
                                          size=(nb, 1024)).astype(np.uint8),
                             device=dev).T
    rnd_cls = torch.as_tensor(rng.integers(0, 256, size=(nb, 1024))
                              .astype(np.uint8), device=dev).T
    at, aa, bt, ba = ac_tables.table, ac_tables.accept, big.table, big.accept
    extra = {
        "dfa_chain[full]": lambda: hd.dfa_chain(tt, ta, cls, ent, "full"),
        "dfa_chain[mask]": lambda: hd.dfa_chain(tt, ta, cls, ent, "mask"),
        "dfa_chain_counts[64 streams]":
            lambda: hd.dfa_chain_counts(tt, ta, cls, ent, 64),
        "dfa_chain_counts[real text]":
            lambda: hd.dfa_chain_counts(tt, ta, text_cls, ent0),
        "dfa_chain_counts[real text, 64 streams]":
            lambda: hd.dfa_chain_counts(tt, ta, text_cls, ent0, 64),
        "kgram_chain[raw text through map_kgram_classes]":
            lambda: hk.kgram_chain(
                kg_ta, map_kgram_classes(kg, text).reshape(nb, 256).T, ent),
        "dfa_chain[aho-corasick S=836]":
            lambda: hd.dfa_chain(at, aa, ac_cls, ent, "finals"),
        "dfa_chain_counts[aho-corasick S=836]":
            lambda: hd.dfa_chain_counts(at, aa, ac_cls, ent),
        "dfa_chain[random S=1024, global table]":
            lambda: hd.dfa_chain(bt, ba, rnd_cls, ent, "finals"),
        "dfa_chain_counts[random S=1024, global table]":
            lambda: hd.dfa_chain_counts(bt, ba, rnd_cls, ent),
    }
    fin = torch.empty(nb, dtype=torch.int32, device=dev)
    bounds = {
        "dfa_chain": bound_ms((cls, tt, ta, ent), (fin,)),
        "dfa_chain_counts": bound_ms((cls, tt, ta, ent), (fin, torch.empty(
            tt.shape[1], dtype=torch.int32, device=dev))),
        "kgram_chain": bound_ms((ck, kg_ta.narrow, ent), (fin, fin)),
        "kgram_chain_bytes": bound_ms((text, kg_ta.narrow, kg_maps.packed, ent),
                                      (fin, fin)),
    }
    # the floor under a chain: steps x the latency of one dependent load
    # from shared memory, at the entry width of the route taken
    latency = {2: chase_ns(2), 4: chase_ns(4)}
    print(f"time: dependent shared-memory load {latency[2]:.2f} ns (uint16 "
          f"entries), {latency[4]:.2f} ns (uint32); with the warp's 32 lanes "
          f"in one bank {chase_ns(2, False):.2f} and {chase_ns(4, False):.2f} ns",
          flush=True)
    floors = {"dfa_chain": 1024 * latency[4], "dfa_chain_counts": 1024 * latency[4],
              "kgram_chain": 256 * latency[2], "kgram_chain_bytes": 256 * latency[2]}
    results = {"latency_ns": latency}
    for name in DFA_PATH:
        ms = event_ms(timing[name], 20)
        plain_ms = event_ms(plain[name], 2)
        k3 = name.startswith("kgram")
        results[name] = {"max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bounds[name], "bound_by": "bytes",
                         "library_ms": LIBRARY_MS,
                         "chain_floor_ms": floors[name] / 1e6,
                         "shape": "tokenizer (S=23), 65,536 lanes x "
                                  + ("256 k-gram steps" if k3 else "1,024 steps")
                                  + (" of 4 raw bytes" if name.endswith("bytes")
                                     else "")}
        print(f"time: {name} {ms:.4f} ms, plain {plain_ms:.2f} ms, bound "
              f"{bounds[name]:.4f} ms, chain floor {floors[name] / 1e6:.4f} ms "
              f"({64 * MIB / ms / 1e6:.1f} GB/s of text)", flush=True)
    results["extra_ms"] = {}
    for name, fn in extra.items():
        ms = results["extra_ms"][name] = event_ms(fn, 20)
        print(f"time: {name} {ms:.4f} ms ({64 * MIB / ms / 1e6:.1f} GB/s of text)",
              flush=True)
    return results


def one_run_ms(fn) -> tuple[object, float]:
    """(result, device milliseconds) of one run of ``fn``, CUDA events."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def phase_nfa_kernels(dev, snort_ld, snort_aut, snort_bytes, l7_aut, l7_bytes,
                      results):
    """K1/K2 at the lazy-device path's shape (1,024 lanes x 4,096 steps of a
    4 MiB chunk) on the snapshot of the warmed Snort-corpus lazy DFA, and K4
    on the l7-corpus NFA (4 streams of 16 KiB; bound 128, and bound 4, which
    overflows; CSR in shared memory) and on a Snort-corpus prefix (CSR in
    global memory), each against its plain version, bit for bit; then K4
    alone on the main path's 64 flows of 1 MiB. Adds the lazy shape to K1's
    and K2's entries of ``results`` and K4's entry."""
    from regex_fpga_tpu_torch.ops import hopper_dfa as hd
    from regex_fpga_tpu_torch.ops import hopper_nfa as hn
    from regex_fpga_tpu_torch.ops.lazy_scan import _pad_for
    from regex_fpga_tpu_torch.ops.nfa_engine import initial_active
    from regex_fpga_tpu_torch.ops.tables import build_nfa_csr

    rng = np.random.default_rng(SEED + 4)
    table_np, unknown, n_acc = snort_ld.snapshot(pad_to=_pad_for(snort_ld))
    accept_np = n_acc > 0
    accept_np[unknown] = True
    table = torch.as_tensor(table_np, device=dev)
    accept = torch.as_tensor(accept_np, device=dev)
    c, m1 = table.shape
    nb, b = 1024, 4096
    cls = torch.as_tensor(snort_ld.class_of[snort_bytes[: nb * b]].astype(np.uint8),
                          device=dev).reshape(nb, b).T
    ent = torch.as_tensor(rng.integers(0, m1, size=nb).astype(np.int32),
                          device=dev)
    err = 0
    for mode in hd.MODES:
        err = max(err, max_abs_err(hd.dfa_chain(table, accept, cls, ent, mode),
                                   hd.dfa_chain_plain(table, accept, cls, ent, mode)))
    err = max(err, max_abs_err(hd.dfa_chain_counts(table, accept, cls, ent),
                               hd.dfa_chain_counts_plain(table, accept, cls, ent)))
    check(err == 0, f"K1/K2 on the lazy table differ from plain by {err}")
    route = hd.dfa_chain_route("finals", c, m1, nb)
    croute = hd.dfa_chain_route("counts", c, m1, nb)
    fin = torch.empty(nb, dtype=torch.int32, device=dev)
    hist = torch.empty(m1, dtype=torch.int32, device=dev)
    lazy_times = {
        "dfa_chain": (lambda: hd.dfa_chain(table, accept, cls, ent),
                      lambda: hd.dfa_chain_plain(table, accept, cls, ent),
                      bound_ms((cls, table, accept, ent), (fin,))),
        "dfa_chain_counts": (lambda: hd.dfa_chain_counts(table, accept, cls, ent),
                             lambda: hd.dfa_chain_counts_plain(table, accept, cls, ent),
                             bound_ms((cls, table, accept, ent), (fin, hist))),
    }
    print(f"kernels: lazy-DFA snapshot of the Snort-corpus NFA, table "
          f"({c}, {m1}) int32 stored {route['table']} (counts: "
          f"{croute['table']}, accept bit "
          f"{'in the entry' if croute['accept_folded'] else 'loaded'}, "
          f"histogram {croute['hist']}, staging ring of {croute['ring']} "
          f"windows; finals: ring of {route['ring']}), "
          f"{route['lanes_per_cta']} lanes per CTA, {nb}x{b} uint8 "
          f"block-major: K1 x3 modes and K2 bit-exact against plain "
          f"(tolerance 0)", flush=True)
    for name, (fn, plain, bound) in lazy_times.items():
        ms = event_ms(fn, 20)
        _, plain_ms = one_run_ms(plain)
        floor = b * results["latency_ns"][2] / 1e6  # uint16 entries
        results[name]["lazy"] = {"shape": f"lazy table ({c}, {m1}), {nb} lanes "
                                          f"x {b} steps",
                                 "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                                 "chain_floor_ms": floor}
        print(f"time: {name}[lazy table ({c}, {m1}), {nb}x{b}] {ms:.4f} ms, "
              f"plain {plain_ms:.2f} ms, bound {bound:.5f} ms, chain floor "
              f"{floor:.4f} ms ({nb * b / ms / 1e6:.2f} GB/s of text)", flush=True)
    # once the lazy DFA outgrows 1,024 states its snapshot is padded to
    # 2,049 columns, which no shared-memory form holds: the warmed main path
    # launches K1 and K2 on that table, from global memory
    wide_t = torch.nn.functional.pad(table, (0, 1024)).contiguous()
    wide_a = torch.nn.functional.pad(accept, (0, 1024)).contiguous()
    check(not hd.dfa_chain_route("counts", c, 2049, nb)["table_smem"],
          "the padded snapshot takes the global-memory route")
    err = max(max_abs_err(hd.dfa_chain(wide_t, wide_a, cls, ent),
                          hd.dfa_chain_plain(wide_t, wide_a, cls, ent)),
              max_abs_err(hd.dfa_chain_counts(wide_t, wide_a, cls, ent),
                          hd.dfa_chain_counts_plain(wide_t, wide_a, cls, ent)))
    check(err == 0, f"K1/K2 on the padded lazy table differ from plain by {err}")
    for name, fn, plain in (
            ("dfa_chain", hd.dfa_chain, hd.dfa_chain_plain),
            ("dfa_chain_counts", hd.dfa_chain_counts, hd.dfa_chain_counts_plain)):
        ms = event_ms(lambda: fn(wide_t, wide_a, cls, ent), 20)
        _, plain_ms = one_run_ms(lambda: plain(wide_t, wide_a, cls, ent))
        results[name]["lazy_global"] = {
            "shape": f"lazy table padded to ({c}, 2049), global memory, {nb} lanes x {b} steps",
            "ms": ms, "plain_ms": plain_ms}
        print(f"time: {name}[lazy table padded to ({c}, 2049), global memory, {nb}x{b}] "
              f"{ms:.4f} ms, plain {plain_ms:.2f} ms, bit-exact against plain",
              flush=True)
    # the fixed cost of a launch (table fill, first window): one window
    short = cls[:32]
    ms = event_ms(lambda: hd.dfa_chain(table, accept, short, ent), 20)
    print(f"time: dfa_chain[lazy table ({c}, {m1}), {nb}x32] {ms:.4f} ms "
          f"(table fill and one window)", flush=True)

    err = 0
    k4 = {}
    # (label, automaton, bytes, streams, bytes each, {bound: whether the
    # streams overflow: "none", "some" or "any"}); the Snort-corpus lists
    # outgrow 128 states on its traffic
    for label, aut, corpus, n, size, bounds in (
            ("l7-corpus", l7_aut, l7_bytes, 4, 16 * 1024, {128: "none", 4: "some"}),
            ("Snort-corpus", snort_aut, snort_bytes, 2, 1024, {128: "any"})):
        csr = build_nfa_csr(aut, device=dev)
        s = aut.num_states
        data = torch.as_tensor(np.array(corpus[: 64 * size]), device=dev)
        starts = rng.integers(0, 63 * size, size=n)
        lens = np.full(n, size)
        for bound, must in bounds.items():
            kr = hn.nfa_active_route(csr, n, bound)
            act = initial_active(s, bound, n, dev)
            cnt = torch.zeros((n, s + 1), dtype=torch.int32, device=dev)
            got = hn.nfa_active_scan(csr, data, starts, lens, act, cnt)
            want, plain_ms = one_run_ms(
                lambda: hn.nfa_active_scan_plain(csr, data, starts, lens, act, cnt))
            err = max(err, max_abs_err(got, want))
            overflowed = int(want[2].sum())
            check(must == "any" or (overflowed == 0) == (must == "none"),
                  f"K4 {label} bound {bound}: {overflowed} streams overflowed")
            ms = event_ms(lambda: hn.nfa_active_scan(csr, data, starts, lens, act, cnt), 10)
            sel = data[: n * size]  # the bytes read, for the bound
            k4[(label, bound)] = {
                "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms((sel, csr.offsets, csr.targets, csr.class_of,
                                      csr.accept, act, cnt), (cnt, act, want[2])),
                "shape": f"{label} NFA, {n} streams x {size // 1024} KiB, bound {bound}"}
            print(f"kernels: K4 {label} NFA S={s} C={csr.num_classes} "
                  f"E={csr.targets.shape[0]}, CSR "
                  f"{'shared (uint16)' if kr['csr_smem'] else 'global'}, counts "
                  f"{'shared' if kr['counts_smem'] else 'global'}, "
                  f"{kr['streams_per_cta']} stream(s) per CTA; {n} streams x "
                  f"{size // 1024} KiB, bound {bound}: {overflowed} overflowed, "
                  f"counts, lists and flags bit-exact against plain (tolerance 0); "
                  f"{ms:.4f} ms, plain {plain_ms:.2f} ms", flush=True)
    check(err == 0, f"nfa_active_scan differs from its plain version by {err}")

    # K4 alone at the main path's shape (the plain version would take hours)
    csr = build_nfa_csr(l7_aut, device=dev)
    s = l7_aut.num_states
    flows = torch.as_tensor(np.array(l7_bytes), device=dev)
    starts = rng.integers(0, 63 * MIB, size=64)
    lens = np.full(64, MIB)
    act = initial_active(s, 128, 64, dev)
    cnt = torch.zeros((64, s + 1), dtype=torch.int32, device=dev)
    kr = hn.nfa_active_route(csr, 64, 128)
    out = hn.nfa_active_scan(csr, flows, starts, lens, act, cnt)
    check(not bool(out[2].any()), "K4 64 x 1 MiB: no overflow")
    ms = event_ms(lambda: hn.nfa_active_scan(csr, flows, starts, lens, act, cnt), 3)
    big_bound = bound_ms((flows[: 64 * MIB], csr.offsets, csr.targets, csr.class_of,
                          csr.accept, act, cnt), (cnt, act, out[2]))
    print(f"time: nfa_active_scan[l7-corpus NFA, 64 flows x 1 MiB, bound 128, "
          f"{kr['streams_per_cta']} stream(s) per CTA] {ms:.2f} ms, bound "
          f"{big_bound:.4f} ms ({ms / MIB * 1e6:.1f} ns per byte per stream)",
          flush=True)
    main = k4[("l7-corpus", 128)]
    return {"max_abs_err": err, "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": "bytes",
            "library_ms": LIBRARY_MS, "shape": main["shape"],
            "main_path": {"shape": "l7-corpus NFA, 64 flows x 1 MiB, bound 128",
                          "ms": ms, "bound_ms": big_bound},
            "other_routes": [dict(v) for k, v in k4.items()
                             if k != ("l7-corpus", 128)]}


# ---------------------------------------------------------------- phase 3


def phase_surface(dev, ac_tables, l7_aut, l7_bytes) -> dict:
    """The port's package-level surface on the card's machine, where there
    is no JAX: every name of the ``__all__`` lists of ``ops``, ``utils``,
    ``models``, ``parallel`` and ``utils.native`` resolves, and no module
    of JAX or of the JAX package is loaded. Then two calls through those
    names on real inputs: ``ops.dfa_scan_blocked`` (the exact blocked scan:
    K6 pass 1, its combine, K1's full mode) with the 300-keyword
    Aho-Corasick DFA over 64 MiB of keyword traffic, held to a serial walk
    of the native host walker (counts, final state, match mask); and
    ``utils.native.nfa_match_positions_native`` with the l7-corpus NFA over
    128 KiB of l7 traffic, held to the oracle's serial trace of active sets.
    Returns the kernel launches of the blocked scan, counted from 0 just
    before it and read just after."""
    import importlib

    counts = {}
    for pkg in ("ops", "utils", "models", "parallel", "utils.native"):
        mod = importlib.import_module(f"regex_fpga_tpu_torch.{pkg}")
        missing = [n for n in mod.__all__ if not hasattr(mod, n)]
        check(not missing, f"regex_fpga_tpu_torch.{pkg} exports {missing}")
        counts[pkg] = len(mod.__all__)
    jax_mods = sorted(k for k in sys.modules if k == "jax" or k.startswith("jax.")
                      or k.split(".")[0] == "regex_fpga_tpu")
    check(not jax_mods, f"modules of JAX or the JAX package loaded: {jax_mods}")
    print(f"surface: package-level names {json.dumps(counts)} all resolve; "
          f"no module of JAX or of the JAX package is loaded", flush=True)

    from regex_fpga_tpu_torch import native
    from regex_fpga_tpu_torch.models import nfa_scan_trace
    from regex_fpga_tpu_torch.ops import build_nfa_tables, dfa_scan_blocked
    from regex_fpga_tpu_torch.utils.native import nfa_match_positions_native

    rng = np.random.default_rng(SEED + 11)
    vocab = FRAG.split(b" ") + WORDS[:300]
    picks = rng.integers(0, len(vocab), size=64 * MIB // 6)
    text = np.frombuffer(b" ".join(vocab[i] for i in picks.tolist()),
                         np.uint8)[:64 * MIB].copy()
    stream = torch.as_tensor(text, device=dev)
    start = 5
    reset_launches()
    res = dfa_scan_blocked(ac_tables, stream, start=start)
    torch.cuda.synchronize()
    launches = launch_counters()
    ms = float(np.median(wall_ms(lambda: dfa_scan_blocked(ac_tables, stream,
                                                           start=start), 3)))
    t = ac_tables
    t0 = time.perf_counter()
    want_c, want_m, want_f = native.dfa_scan(
        t.table.cpu().numpy(), t.class_of.cpu().numpy(), t.accept.cpu().numpy(),
        text, start=start)
    walk_s = time.perf_counter() - t0
    check(np.array_equal(res.counts.cpu().numpy(), want_c),
          "dfa_scan_blocked counts equal the serial walk")
    check(int(res.final_state) == want_f, "dfa_scan_blocked final state")
    check(np.array_equal(res.match_mask.cpu().numpy(), want_m),
          "dfa_scan_blocked match mask equals the serial walk")
    used = {k: v for k, v in launches.items() if v}
    check(all(used.get(k, 0) > 0 for k in ("dfa_block_fns", "dfa_fn_combine",
                                           "dfa_chain")),
          "dfa_scan_blocked ran K6 pass 1, its combine and K1")
    print(f"surface: ops.dfa_scan_blocked, Aho-Corasick (36, 836) over 64 MiB of "
          f"keyword traffic from state {start}: {text.size / ms / 1e6:.3f} GB/s "
          f"(median of 3: {ms:.2f} ms, data on the card), {int(want_c.sum())} "
          f"matches; counts, final state and mask equal the native serial walk "
          f"({walk_s:.2f} s); launched {json.dumps(used)}", flush=True)

    nt = build_nfa_tables(l7_aut)
    flow = l7_bytes[:128 << 10]
    t0 = time.perf_counter()
    got = nfa_match_positions_native(nt.delta.numpy(), nt.class_of.numpy(),
                                     nt.accept.numpy(), flow)
    pos_s = time.perf_counter() - t0
    accepting = set(np.nonzero(l7_aut.out_degree == 0)[0].tolist())
    history = nfa_scan_trace(l7_aut, flow)
    want = [i for i in range(flow.size) if history[i] & accepting]
    check(np.array_equal(got, np.asarray(want, dtype=np.int64)),
          "nfa_match_positions_native equals the oracle's trace")
    print(f"surface: utils.native.nfa_match_positions_native, l7-corpus NFA over "
          f"{flow.size} bytes of l7 traffic (active_cap 1024): {len(got)} match "
          f"offsets in {pos_s * 1e3:.2f} ms, equal to the oracle's serial trace",
          flush=True)
    return launches


def phase_main_path(dev):
    """The port's API at full size. Returns the kernel launch counts, the
    calls, as (label, zero-argument function, bytes) for the profile, and the
    keyword traffic of the Aho-Corasick matcher."""
    from regex_fpga_tpu_torch import api
    from regex_fpga_tpu_torch.models import CompiledDfa, build_aho_corasick
    from regex_fpga_tpu_torch.ops.kgram import dfa_scan_kgram, map_kgram_classes

    rng = np.random.default_rng(SEED + 1)
    cfg = api.EngineConfig(scan_backend="device")  # chunk 64 MiB, 65536 lanes
    check(cfg.chunk_bytes == 64 * MIB and cfg.num_blocks == 65536,
          "default chunk and lane count")
    text = np.frombuffer(FRAG * (64 * MIB // len(FRAG) + 1), np.uint8)[:64 * MIB]
    noise = rng.integers(0, 256, size=64 * MIB, dtype=np.uint8)
    batch = noise.reshape(64, MIB)
    lens = rng.integers(1024, 2 * MIB + 1, size=64)
    offs = rng.integers(0, 64 * MIB - 2 * MIB, size=64)
    ragged = [np.concatenate([text[o:o + n // 2], noise[o:o + n - n // 2]])
              for o, n in zip(offs, lens)]
    ac = build_aho_corasick(WORDS[:300])
    # keyword traffic for the Aho-Corasick matcher: seeded words of the
    # synthetic text and of its keyword list, space-separated
    vocab = FRAG.split(b" ") + WORDS[:300]
    picks = rng.integers(0, len(vocab), size=64 * MIB // 6)
    ac_text = np.frombuffer(b" ".join(vocab[i] for i in picks.tolist()),
                            np.uint8)[:64 * MIB]
    check(ac_text.size == 64 * MIB, "keyword traffic fills 64 MiB")

    card = {"tok": api.compile_tokenizer(config=cfg, device=dev),
            "ac": api.DfaMatcher(ac.dfa, cfg, device=dev)}
    cpu = {"tok": api.compile_tokenizer(config=cfg, device="cpu"),
           "ac": api.DfaMatcher(ac.dfa, cfg, device="cpu")}
    t16 = text[:16 * MIB]
    calls = [  # label, matcher, method, args, bytes
        ("tokenizer scan counts 64 MiB", "tok", "scan", (text,), text.size),
        ("tokenizer count (k-gram, raw text in) 64 MiB", "tok", "count", (text,),
         text.size),
        ("tokenizer dfa_scan_kgram over class ids 64 MiB", "tok", "kgram_ids",
         (text,), text.size),
        ("tokenizer scan positions 16 MiB", "tok", "scan_positions", (t16,),
         t16.size),
        ("tokenizer presplit 16 MiB", "tok", "presplit", (t16,), t16.size),
        ("tokenizer batch 64 x 1 MiB", "tok", "scan", (batch,), batch.size),
        ("tokenizer ragged 64 flows 1 KiB-2 MiB", "tok", "scan", (ragged,),
         int(lens.sum())),
        (f"aho-corasick S={card['ac'].num_states} scan counts 64 MiB", "ac",
         "scan", (ac_text,), ac_text.size),
    ]

    def run(m, method, args):
        if method == "scan_positions":
            return m.scan(*args, collect_positions=True)
        if method == "kgram_ids":
            # the class-id entry point of the k-gram engine: the text is
            # mapped to k-gram classes by tensor passes, then scanned
            kg, ta, _ = m._kgram()
            ids = map_kgram_classes(kg, m._upload(args[0]))
            res = dfa_scan_kgram(ta, ids, num_blocks=cfg.num_blocks, start=m.start,
                                 max_iters=cfg.max_iters)
            return [int(res.total), int(res.final_state), int(res.converged)]
        return getattr(m, method)(*args)

    reset_launches()
    got = {}
    for label, who, method, args, nbytes in calls:
        got[label] = run(card[who], method, args)  # warm-up: lazy tables
        ms = wall_ms(lambda: run(card[who], method, args), REPEATS)
        med = float(np.median(ms))
        r = got[label]
        note = ""
        if hasattr(r, "metrics"):
            check(r.metrics.converged, f"{label}: converged")
            note = f", iterations={r.metrics.iterations}, total={r.total}"
        print(f"main: {label}: {nbytes / med / 1e6:.3f} GB/s (median of "
              f"{REPEATS}: {med:.2f} ms; min {min(ms):.2f}, max {max(ms):.2f})"
              f"{note}", flush=True)
    ids_total, ids_final, ids_converged = got[calls[2][0]]
    check(ids_converged and got[calls[1][0]] == ids_total
          + int(card["tok"]._accept_eof[ids_final]),
          "count from raw text equals the scan over class ids")
    launches = launch_counters()
    print(f"main: launches {json.dumps(launches)}", flush=True)
    for name in DFA_PATH:
        check(launches[name] > 0, f"{name} launched on the DFA main path")

    # the same calls on the plain path (CPU tensors)
    t0 = time.perf_counter()
    for label, who, method, args, _ in calls:
        want = run(cpu[who], method, args)
        r = got[label]
        if hasattr(want, "counts"):
            check(np.array_equal(r.counts, want.counts), f"{label}: counts")
            check(r.metrics.iterations == want.metrics.iterations,
                  f"{label}: iterations")
            if want.match_positions is not None:
                for g, w in zip(r.match_positions, want.match_positions):
                    check(np.array_equal(g, w), f"{label}: positions")
        else:
            check(np.array_equal(np.asarray(r), np.asarray(want)), label)
    print(f"main: every call equals the plain path on the CPU "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # an independent host walk over a 1 MiB prefix
    for who, corpus in (("tok", text), ("ac", ac_text)):
        m = card[who]
        prefix = corpus[:MIB]
        want, final = host_walk(m.tables.table.cpu().numpy(),
                                m.tables.class_of.cpu().numpy(),
                                m.tables.accept.cpu().numpy(), prefix, m.start)
        if m._accept_eof[final]:
            want[final] += 1
        check(np.array_equal(m.scan(prefix).counts[0], want),
              f"{who}: 1 MiB scan against the host walk")
        check(m.count(prefix) == int(want.sum()),
              f"{who}: 1 MiB count against the host walk")
    print("main: 1 MiB prefixes equal a per-byte host walk", flush=True)

    # a parity automaton never converges: the exact fallback must answer
    ptable = np.zeros((256, 2), dtype=np.int32)
    ptable[:, 0] = 1
    parity = CompiledDfa(table=ptable, accept=np.array([False, True]),
                         start=0, dead=0)
    pcfg = api.EngineConfig(scan_backend="device", num_blocks=1024,
                            min_block_bytes=1)
    pm = api.DfaMatcher(parity, pcfg, device=dev)
    # 512 lanes of 131 bytes for the fast engine (too many for its Jacobi
    # budget); 65 blocks of 1024 bytes for the exact blocked scan and a
    # 512-byte tail for the serial one
    pdata = rng.integers(0, 256, size=1024 * 65 + 512, dtype=np.uint8)
    rep = pm.scan(pdata)
    want, final = host_walk(ptable, np.arange(256), parity.accept, pdata, 0)
    if parity.accept[final]:
        want[final] += 1
    check(not rep.metrics.converged, "parity automaton reported unconverged")
    check(np.array_equal(rep.counts[0], want), "parity: exact fallback counts")
    check(pm.count(pdata) == int(want.sum()), "parity: exact fallback count")
    print(f"main: parity automaton: converged=False, exact fallback total "
          f"{rep.total} equals the host walk", flush=True)
    return launches, [(label, (lambda m=card[who], me=method, a=args:
                               run(m, me, a)), nbytes)
                      for label, who, method, args, nbytes in calls], ac_text


# ---------------------------------------------------------------- phase 4


def phase_nfa_path(dev, snort_aut, snort_bytes, l7_aut, l7_bytes):
    """compile_ruleset through all three strategies at full size. Returns
    the kernel launch counts and the calls for the profile."""
    from regex_fpga_tpu_torch import api
    from regex_fpga_tpu_torch.models import nfa_scan

    rng = np.random.default_rng(SEED + 3)
    cfg = api.EngineConfig(scan_backend="device")
    check(cfg.active_bound == 128, "default active bound")
    snort_flows = [snort_bytes[o:o + MIB]
                   for o in rng.integers(0, 63 * MIB, size=64).tolist()]
    l7_flows = np.stack([l7_bytes[o:o + MIB]
                         for o in rng.integers(0, 63 * MIB, size=64).tolist()])
    m = {"snort-dev": api.compile_ruleset(snort_aut, cfg, "lazy-device", dev),
         "snort-host": api.compile_ruleset(snort_aut, cfg, "lazy", dev),
         "l7-dev": api.compile_ruleset(l7_aut, cfg, "active-set", dev),
         "l7-host": api.compile_ruleset(l7_aut, cfg, "lazy", dev)}
    calls = [  # label, matcher, data, bytes
        (f"snort S={snort_aut.num_states} lazy-device 64 MiB", "snort-dev",
         snort_bytes, snort_bytes.size),
        (f"snort S={snort_aut.num_states} lazy 64 MiB", "snort-host",
         snort_bytes, snort_bytes.size),
        (f"snort S={snort_aut.num_states} lazy 64 flows x 1 MiB", "snort-host",
         snort_flows, 64 * MIB),
        (f"l7 S={l7_aut.num_states} active-set 64 flows x 1 MiB", "l7-dev",
         l7_flows, l7_flows.size),
    ]
    reset_launches()
    got = {}
    for label, who, data, nbytes in calls:
        got[label] = m[who].scan(data)  # warm-up: tables, lazy DFA states
        ms = wall_ms(lambda: m[who].scan(data), REPEATS)
        med = float(np.median(ms))
        print(f"main: {label}: {nbytes / med / 1e6:.3f} GB/s (median of "
              f"{REPEATS}: {med:.2f} ms; min {min(ms):.2f}, max {max(ms):.2f}), "
              f"total={got[label].total}, engine={got[label].metrics.engine}",
              flush=True)
    launches = launch_counters()
    print(f"main: NFA launches {json.dumps(launches)}", flush=True)
    for name in NFA_PATH:
        check(launches[name] > 0, f"{name} launched on the NFA main path")

    # references: serial host walks of the portable native build, and the
    # Python oracle on prefixes
    t0 = time.perf_counter()
    ld = m["snort-host"].lazy_dfa
    ref, _, _ = ld.host_scan(snort_bytes)
    for label, _, data, _ in calls[:2]:
        check(np.array_equal(got[label].counts[0], ref), f"{label}: counts")
    flows_ref = np.stack([ld.host_scan(f)[0] for f in snort_flows])
    check(np.array_equal(got[calls[2][0]].counts, flows_ref),
          f"{calls[2][0]}: counts against per-flow serial walks")
    l7_ref, _ = m["l7-host"].lazy_dfa.host_scan_batch(list(l7_flows))
    check(np.array_equal(got[calls[3][0]].counts, l7_ref),
          f"{calls[3][0]}: counts against the lazy host walk")
    for label, *_ in calls:
        check(got[label].total > 0, f"{label}: matches found")
    print(f"main: every NFA call equals the portable native host walk "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    pre = snort_bytes[:16 * 1024]
    check(np.array_equal(m["snort-dev"].scan(pre).counts[0],
                         nfa_scan(snort_aut, pre)), "snort 16 KiB: oracle")
    pre = l7_flows[0][:64 * 1024]
    check(np.array_equal(m["l7-dev"].scan(pre).counts[0], nfa_scan(l7_aut, pre)),
          "l7 64 KiB: oracle")
    print(f"main: the 16 KiB Snort and 64 KiB l7 prefixes equal the Python "
          f"oracle ({time.perf_counter() - t0:.1f} s)", flush=True)
    return launches, [(label, (lambda mm=m[who], d=data: mm.scan(d)), nbytes)
                      for label, who, data, nbytes in calls
                      if m[who].strategy != "lazy"]


# ---------------------------------------------------------------- phase 5

SPAN_PATH = ("dfa_chain", "dfa_chain_counts", "kgram_chain_bytes",
             "nfa_active_scan")


def native_walk(tables, data: np.ndarray, start: int):
    """Per-state accept-visit counts and the final state of a serial host
    walk (the port's native build of ``dfa_scan``), an independent reference
    for the device scans."""
    from regex_fpga_tpu_torch import native

    counts, _, final = native.dfa_scan(
        tables.table.cpu().numpy(), tables.class_of.cpu().numpy(),
        tables.accept.cpu().numpy(), data, start, want_mask=False)
    return counts, final


def literal_occurrences(patterns, data: bytes) -> list:
    """Every (start, end, pattern id) occurrence, overlapping ones
    included, by a ``bytes.find`` loop per pattern."""
    out = []
    for pid, p in enumerate(patterns):
        i = data.find(p)
        while i >= 0:
            out.append((i, i + len(p), pid))
            i = data.find(p, i + 1)
    return out


def prefilter_flows(n: int) -> list:
    """``n`` flows of 64 KiB in 8 groups, each holding the planted payloads
    of other l7 rules: their literal sets differ."""
    from regex_fpga_tpu_torch.models import gen_l7_patterns, gen_l7_traffic

    l7_pats = gen_l7_patterns()
    payloads, planted = gen_l7_traffic()
    noise = [payloads[i] for i in range(len(payloads)) if i not in planted]
    flows = []
    for k in range(n):
        own = [l7_pats[r][3] for r in range((k % 8) * 13, (k % 8) * 13 + 13)]
        pick = [own[j % 13] if j % 3 == 0 else noise[(j * 7 + k) % len(noise)]
                for j in range(64)]
        flows.append(tiled(b"".join(pick), MIB // 16))
    return flows


def phase_spans(dev, snort_bytes, l7_bytes, ac_text):
    """Span extraction and the matcher surface through the port's API at the
    sizes a user scans (64 MiB calls at the JAX defaults): regex spans,
    literal sets, rule sets, the host matchers and re_compat, each timed as
    the median of REPEATS runs after a warm-up and held to a reference.
    Returns the kernel launch counts and the device calls for the profile."""
    import re

    from regex_fpga_tpu_torch import api, native, re_compat
    from regex_fpga_tpu_torch.models import gen_l7_patterns
    from regex_fpga_tpu_torch.ops.tables import host_to_device

    rng = np.random.default_rng(SEED + 5)
    cfg = api.EngineConfig(scan_backend="device")
    prefix = snort_bytes[:MIB].tobytes()

    # the reverse pass reads the stream back to front: a reversed copy on
    # the host, or the stream uploaded as it lies and flipped on the device
    t_copy = wall_ms(lambda: host_to_device(snort_bytes[::-1], dev), REPEATS)
    t_flip = wall_ms(lambda: torch.flip(host_to_device(snort_bytes, dev), (0,)),
                     REPEATS)
    print(f"spans: reversing 64 MiB: reversed host copy and upload "
          f"{np.median(t_copy):.2f} ms (min {min(t_copy):.2f}, max "
          f"{max(t_copy):.2f}); upload and device flip {np.median(t_flip):.2f} "
          f"ms (min {min(t_flip):.2f}, max {max(t_flip):.2f})", flush=True)

    # regex spans on Snort-corpus traffic; greedy patterns without
    # prefix-ordered alternations, so that leftmost-longest spans are the
    # leftmost-first spans of Python re
    span_patterns = {"dotted number": rb"[0-9]+(\.[0-9]+)+",
                     "Host header": rb"Host: [a-z0-9.-]+",
                     "request line (2 groups)": rb"(GET|POST) (/[a-z0-9/._-]*)"}
    card = {k: api.compile_regex(p, config=cfg, device=dev)
            for k, p in span_patterns.items()}
    # literal sets on phase 3's keyword traffic
    lits = api.compile_literals(WORDS[:300], cfg, device=dev)
    ac4 = ac_text[:4 * MIB]
    # rule sets: the l7 corpus, anchored and unanchored rules (two
    # partitions), case-insensitive where its pattern file says so
    l7_pats = gen_l7_patterns()
    rules = [("(?i)" + p) if icase else p for _, p, icase, _ in l7_pats]
    check(any(p.startswith("^") for p in rules)
          and not all(p.startswith("^") for p in rules), "a mixed rule set")
    l7_flows = np.stack([l7_bytes[o:o + MIB]
                         for o in rng.integers(0, 63 * MIB, size=64).tolist()])
    pre_flows = prefilter_flows(64)
    rule_dev = api.compile_regex_set(rules, cfg, "lazy-device", device=dev)
    rule_act = api.compile_regex_set(rules, cfg, "active-set", device=dev)
    rule_host = api.compile_regex_set(rules, cfg, "lazy", device=dev)
    pre = api.compile_regex_set_prefiltered(rules, cfg, "active-set",
                                            device=dev)
    # host matchers
    host_pats = {"boundary": rb"\b(?:GET|POST) /[a-z0-9/._-]*",
                 "backreference": rb"([a-z])\1[0-9]"}
    host = {k: api.compile_regex(p, config=cfg, device=dev)
            for k, p in host_pats.items()}
    check(type(host["boundary"]).__name__ == "HostRegexMatcher"
          and type(host["backreference"]).__name__ == "HostBacktrackMatcher",
          "host matcher routing")
    host4 = snort_bytes[:4 * MIB].tobytes()
    count_pat = rb"[0-9]+\.[0-9]+"
    findall_pat = rb"(GET|POST) (/[a-z0-9/._-]*)"
    check(re_compat.compile(count_pat, device=dev)._m._kgram() is not None,
          "re_compat.count takes the k-gram engine (S <= 32)")

    calls = {  # key: (label, zero-argument function, bytes)
        **{("spans", k): (f"finditer_arrays {k} 64 MiB",
                          (lambda m=m: m.finditer_arrays(snort_bytes)),
                          snort_bytes.size)
           for k, m in card.items()},
        "lit_counts": ("literal set (300 keywords) scan_patterns 64 MiB",
                       lambda: lits.scan_patterns(ac_text), ac_text.size),
        "lit_iter": ("literal set (300 keywords) finditer 4 MiB",
                     lambda: lits.finditer(ac4), ac4.size),
        "rule_dev": (f"rule set ({len(rules)} l7 rules) lazy-device 64 MiB",
                     lambda: rule_dev.scan(l7_bytes), l7_bytes.size),
        "rule_act": (f"rule set ({len(rules)} l7 rules) active-set 64 flows "
                     f"x 1 MiB", lambda: rule_act.scan(l7_flows), l7_flows.size),
        "pre": ("prefiltered rule set active-set 64 flows x 64 KiB",
                lambda: pre.scan(pre_flows), 64 * MIB // 16),
        ("host", "boundary"): ("host matcher \\b finditer 4 MiB",
                               lambda: host["boundary"].finditer(host4),
                               len(host4)),
        ("host", "backreference"): (
            "host matcher backreference finditer 1 MiB",
            lambda: host["backreference"].finditer(prefix), len(prefix)),
        "count": ("re_compat.count 64 MiB",
                  lambda: re_compat.count(count_pat, snort_bytes, device=dev),
                  snort_bytes.size),
        "findall": ("re_compat.findall 1 MiB",
                    lambda: re_compat.findall(findall_pat, prefix, device=dev),
                    len(prefix)),
    }
    reset_launches()
    got, device_calls = {}, []
    for key, (label, fn, nbytes) in calls.items():
        before = launch_counters()
        got[key] = fn()  # warm-up: reversed and anchored automata, lazy DFAs
        ms = wall_ms(fn, REPEATS)
        med = float(np.median(ms))
        after = launch_counters()
        used = {k: after[k] - before[k] for k in after if after[k] > before[k]}
        print(f"spans: {label}: {nbytes / med / 1e6:.3f} GB/s (median of "
              f"{REPEATS}: {med:.2f} ms; min {min(ms):.2f}, max {max(ms):.2f}), "
              f"launches {json.dumps(used)}", flush=True)
        if used:
            device_calls.append((label, fn, nbytes))
    launches = launch_counters()
    print(f"spans: launches {json.dumps(launches)}", flush=True)
    for name in SPAN_PATH:
        check(launches[name] > 0, f"{name} launched on the span path")

    # where a span call's time goes: the device stage (upload, K1 passes,
    # compaction, download), then the host stage
    def split(label, device_stage, host_stage, items):
        dev_ms = float(np.median(wall_ms(device_stage, REPEATS)))
        host_ms = float(np.median(wall_ms(host_stage, REPEATS)))
        print(f"spans: {label}: device stage {dev_ms:.2f} ms, host stage "
              f"{host_ms:.2f} ms ({items}; medians of {REPEATS})", flush=True)

    for k, m in card.items():
        starts = m._match_starts(snort_bytes)
        table, accept, dead, eof = m._anchored_np
        split(f"finditer_arrays {k}", lambda m=m: m._match_starts(snort_bytes),
              lambda m=m, t=table, a=accept, d=dead, e=eof, st=starts:
              native.anchored_spans(t, a, e, m._anchored_start, d, snort_bytes,
                                    st),
              f"backward pass; native forward walk from {len(starts)} starts")
    ends, states = lits._scan_match_states(ac4)
    split("literal set finditer", lambda: lits._scan_match_states(ac4),
          lambda: [(e, s_) for e, s_ in zip(ends.tolist(), states.tolist())
                   for _ in lits.ac.outputs[s_]],
          f"K1 full mode and the gather; the Python list of "
          f"{len(got['lit_iter'])} tuples")
    hm = host["boundary"]
    host4_np = np.frombuffer(host4, np.uint8)
    cand = hm._candidate_starts(host4_np)
    split("host matcher \\b finditer",
          lambda: hm._candidate_starts(host4_np),
          lambda: [hm._prog.longest_end_at(host4, s0) for s0 in cand.tolist()],
          f"envelope backward pass; the Pike VM at {len(cand)} candidates")

    # references
    t0 = time.perf_counter()
    for k, p in span_patterns.items():
        spans = got[("spans", k)]
        want = api.compile_regex(p, config=cfg, device="cpu").finditer_arrays(
            snort_bytes)
        check(np.array_equal(spans, want), f"{k}: 64 MiB spans equal the CPU path")
        check(len(spans) > 1000, f"{k}: {len(spans)} spans")
        m = card[k]
        ref = list(re.finditer(p, prefix))
        check(m.finditer_arrays(prefix).tolist() == [list(r.span()) for r in ref],
              f"{k}: 1 MiB spans equal re.finditer")
        check([g.regs for g in m.finditer_matches(prefix)]
              == [r.regs for r in ref], f"{k}: groups equal re.finditer's")
        s, r = m.search(prefix, 1000), re.compile(p).search(prefix, 1000)
        check(r is not None and s.regs == r.regs, f"{k}: search equals re.search")
        check(m.sub(b"<>", prefix) == re.sub(p, b"<>", prefix),
              f"{k}: sub equals re.sub")
    print(f"spans: every span call equals the CPU path over 64 MiB and "
          f"Python re over 1 MiB ({time.perf_counter() - t0:.1f} s)", flush=True)

    t0 = time.perf_counter()
    counts, final = native_walk(lits.tables, ac_text, lits.start)
    if lits._accept_eof[final]:
        counts[final] += 1
    per = got["lit_counts"].pattern_counts[0]
    check(np.array_equal(per, lits.ac.pattern_counts(counts[None])[0]),
          "literal set: per-pattern counts equal the host walk's fold")
    occ = got["lit_iter"]
    check(sorted(occ) == sorted(literal_occurrences(WORDS[:300], ac4.tobytes())),
          "literal set: 4 MiB occurrences equal a bytes.find loop")
    print(f"spans: literal set: {int(per.sum())} occurrences over 64 MiB equal "
          f"the native host walk folded per pattern, and {len(occ)} over 4 MiB "
          f"a bytes.find loop ({time.perf_counter() - t0:.1f} s)", flush=True)

    t0 = time.perf_counter()
    for key, data in (("rule_dev", l7_bytes), ("rule_act", l7_flows),
                      ("pre", pre_flows)):
        want = rule_host.scan(data).rule_counts
        check(np.array_equal(got[key].rule_counts, want),
              f"{calls[key][0]}: per-rule counts equal the lazy host walk")
        check(int(want.sum()) > 0, f"{calls[key][0]}: rules matched")
    subsets = len(pre._subs)
    check(1 < subsets <= pre.max_cached_subsets, f"{subsets} candidate subsets")
    print(f"spans: rule sets: lazy-device, active-set and the prefiltered set "
          f"({pre.num_prefiltered} of {len(rules)} rules behind literals, "
          f"{subsets} candidate subsets) equal the lazy host walk's per-rule "
          f"counts ({time.perf_counter() - t0:.1f} s)", flush=True)

    t0 = time.perf_counter()
    for k, data in (("boundary", host4), ("backreference", prefix)):
        spans = got[("host", k)]
        cpu = api.compile_regex(host_pats[k], config=cfg,
                                device="cpu").finditer(data)
        check(spans == cpu, f"{k}: spans equal the CPU path")
        check(spans == [r.span() for r in re.finditer(host_pats[k], data)],
              f"{k}: spans equal re.finditer")
        check(len(spans) > 0, f"{k}: matches found")
    m = re_compat.compile(count_pat, device=dev)._m
    counts, final = native_walk(m.tables, snort_bytes, m.start)
    check(got["count"] == int(counts.sum()) + int(bool(m._accept_eof[final])),
          "re_compat.count equals the native host walk")
    check(got["findall"] == re.findall(findall_pat, prefix),
          "re_compat.findall equals re.findall")
    print(f"spans: host matchers equal the CPU path and re.finditer; "
          f"re_compat.count ({got['count']}) equals the native host walk and "
          f"re_compat.findall re.findall ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    return launches, device_calls


# ---------------------------------------------------------------- phase 6

IDS_PATH = ("dfa_chain", "dfa_chain_counts", "nfa_active_scan")
IDS_REPEATS = 3  # timed runs per phase-6 call: the Snort call takes seconds


@contextlib.contextmanager
def recorded_k2():
    """Keeps the arguments of every K2 launch that the fast DFA engines make
    inside the block, so that the kernel can be held to its plain version
    at the shape the main path gave it."""
    from regex_fpga_tpu_torch.ops import dfa_fast

    real, calls = dfa_fast.dfa_chain_counts, []

    def hook(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    dfa_fast.dfa_chain_counts = hook
    try:
        yield calls
    finally:
        dfa_fast.dfa_chain_counts = real


def alert_rows(report) -> list:
    return [[(a.rule_index, a.sid, a.msg, a.pcre_checked) for a in alerts]
            for alerts in report.alerts]


def run_cli(args) -> tuple[int, bytes, bytes, float]:
    """``python -m regex_fpga_tpu_torch ARGS`` from the repository root:
    (exit code, stdout, stderr, wall seconds, the import and the kernels'
    load included)."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "regex_fpga_tpu_torch", *args],
                         capture_output=True, timeout=300, cwd=ROOT)
    return out.returncode, out.stdout, out.stderr, time.perf_counter() - t0


def phase_ids(dev, snort_bytes, l7_bytes, kernel_times):
    """The IDS front door at full size: compile_snort over the 3,000-rule
    community-scale corpus and 4,000 payloads of its traffic (stage 1 on the
    card, the verify on the host), compile_l7 over a directory of the 110
    l7-corpus protocols under "lazy-device", "active-set" and prefiltered,
    and the CLI as subprocesses. Each call is timed as the median of
    IDS_REPEATS runs after a warm-up and held to a reference. Adds K2's time
    at the Snort prefilter shape to ``kernel_times``. Returns the kernel
    launch counts and the device calls for the profile."""
    from regex_fpga_tpu_torch import api, native
    from regex_fpga_tpu_torch.models import (gen_community_rules,
                                             gen_l7_patterns, gen_traffic,
                                             write_pat_dir)
    from regex_fpga_tpu_torch.ops import hopper_dfa as hd

    work = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(os.path.join(work, "l7"))
    t0 = time.perf_counter()
    rules_text = gen_community_rules()
    ids = api.compile_snort(rules_text, device=dev)
    payloads, planted = gen_traffic(n_payloads=4000)
    streams = [np.frombuffer(p, np.uint8) for p in payloads]
    lows = [ids._lower_lut[s_] for s_ in streams]
    n_bytes = sum(map(len, payloads))
    # the l7 corpus as .pat files, and phase 5's rule set over the same
    # patterns (the l7 traffic is phase 5's, cut: 8 MiB, 8 flows of 1 MiB,
    # 8 flows of 64 KiB)
    write_pat_dir(os.path.join(work, "l7"))
    l7 = {"lazy-device": api.compile_l7(os.path.join(work, "l7"),
                                        strategy="lazy-device", device=dev),
          "active-set": api.compile_l7(os.path.join(work, "l7"),
                                       strategy="active-set", device=dev),
          "prefiltered": api.compile_l7(os.path.join(work, "l7"),
                                        strategy="active-set", prefilter=True,
                                        device=dev)}
    names = [name for name, *_ in gen_l7_patterns()]
    rules = [("(?i)" + p) if icase else p for _, p, icase, _ in gen_l7_patterns()]
    ref = api.compile_regex_set(rules, strategy="lazy", device=dev)
    l7_cut, l7_flows = l7_bytes[:8 * MIB], l7_bytes[:8 * MIB].reshape(8, MIB)
    pre_flows = prefilter_flows(8)
    print(f"ids: Snort corpus of {ids.num_rules} rules compiled on the card, "
          f"{len(payloads)} payloads of {n_bytes} bytes ({len(planted)} with a "
          f"planted attack); l7: {len(l7['lazy-device'].rule_names)} .pat files "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    check(len(l7["lazy-device"].rule_names) == len(names) == 110
          and sorted(l7["lazy-device"].rule_names) == sorted(names),
          "compile_l7 reads the 110 protocols")

    # stage 1's K2 shapes: each automaton with the stall class, over the
    # ragged batch (lanes = payloads x blocks, a histogram row per payload)
    k2_args = {}
    # (on the device: under "auto" the router sends stage 1 to the host)
    for name, m, data in (("exact", ids._exact, streams),
                          ("case-folded", ids._fold, lows)):
        with recorded_k2() as calls:
            forced(m, "device").scan_patterns(data)
        check(len(calls) >= 1, f"{name}: stage 1 launched K2")
        k2_args[name] = calls[-1]
        (table, _, cls_seq, _), kw = calls[-1]
        route = hd.dfa_chain_route("counts", table.shape[0], table.shape[1],
                                   cls_seq.shape[1], kw["num_streams"],
                                   cls_seq.dtype)
        print(f"ids: Snort prefilter {name}: Aho-Corasick S={m.num_states} over "
              f"{m.num_patterns} literals; K2 {len(calls)} pass(es) of table "
              f"({table.shape[0]}, {table.shape[1]}) stored {route['table']}, "
              f"accept bit {'in the entry' if route['accept_folded'] else 'loaded'}, "
              f"histogram {route['hist']} ({kw['num_streams']} rows), "
              f"{cls_seq.shape[1]} lanes x {cls_seq.shape[0]} steps "
              f"{str(cls_seq.dtype)[6:]}, {route['lanes_per_cta']} lanes per "
              f"CTA", flush=True)

    calls = {  # key: (label, zero-argument function, bytes)
        "snort": (f"compile_snort ({ids.num_rules} rules) scan {len(payloads)} "
                  f"payloads", lambda: ids.scan(payloads), n_bytes),
        "l7_dev": ("compile_l7 lazy-device 8 MiB",
                   lambda: l7["lazy-device"].scan(l7_cut), l7_cut.size),
        "l7_act": ("compile_l7 active-set 8 flows x 1 MiB",
                   lambda: l7["active-set"].scan(l7_flows), l7_flows.size),
        "l7_pre": ("compile_l7 prefiltered active-set 8 flows x 64 KiB",
                   lambda: l7["prefiltered"].scan(pre_flows), 8 * MIB // 16),
    }
    reset_launches()
    got, device_calls, medians = {}, [], {}
    for key, (label, fn, nbytes) in calls.items():
        before = launch_counters()
        got[key] = fn()
        ms = wall_ms(fn, IDS_REPEATS)
        med = medians[key] = float(np.median(ms))
        after = launch_counters()
        used = {k: after[k] - before[k] for k in after if after[k] > before[k]}
        print(f"ids: {label}: {nbytes / med / 1e6:.3f} GB/s (median of "
              f"{IDS_REPEATS}: {med:.2f} ms; min {min(ms):.2f}, max "
              f"{max(ms):.2f}), launches {json.dumps(used)}", flush=True)
        device_calls.append((label, fn, nbytes))
    launches = launch_counters()
    print(f"ids: launches {json.dumps(launches)}", flush=True)
    for name in IDS_PATH:
        check(launches[name] > 0, f"{name} launched on the IDS path")

    # where the Snort call's time goes: stage 1 (uploads, K2, readback) on
    # the card, the rest (URI carve, gate, verify, pcre) on the host
    stage1 = float(np.median(wall_ms(lambda: ids._prefilter_counts(streams),
                                     IDS_REPEATS)))
    rep = got["snort"]
    n_cand = sum(map(len, rep.prefilter_candidates))
    n_alerts = sum(map(len, rep.alerts))
    print(f"ids: Snort split: stage 1 (uploads, K2, readback) {stage1:.2f} "
          f"ms, host stage {medians['snort'] - stage1:.2f} ms (the call's "
          f"median less stage 1's, medians of {IDS_REPEATS}); {n_cand} prefilter "
          f"candidates ({n_cand / len(payloads):.1f} rules a payload), "
          f"{n_alerts} alerts", flush=True)

    # references
    t0 = time.perf_counter()
    for i, sid in planted.items():
        check(sid in rep.sids(i), f"payload {i}: planted sid {sid} alerts")
    ecs, fcs = ids._prefilter_counts(streams)
    for name, m, data, pc in (("exact", ids._exact, streams, ecs),
                              ("case-folded", ids._fold, lows, fcs)):
        t = [x.cpu().numpy() for x in (m.tables.table, m.tables.class_of,
                                       m.tables.accept)]
        counts = np.zeros((len(data), m.num_states), np.int64)
        for i, s_ in enumerate(data):
            counts[i], _, final = native.dfa_scan(*t, s_, m.start,
                                                  want_mask=False)
            if len(s_) and m._accept_eof[final]:
                counts[i, final] += 1
        check(np.array_equal(pc, m.ac.pattern_counts(counts)),
              f"stage 1 {name}: per-payload counts equal the native walk's")
    cpu = api.compile_snort(rules_text, device="cpu")
    want = cpu.scan(payloads)
    check(alert_rows(rep) == alert_rows(want), "Snort alerts equal the CPU path")
    check(rep.prefilter_candidates == want.prefilter_candidates,
          "Snort candidates equal the CPU path")
    check(ids.enforcement_report() == cpu.enforcement_report(),
          "Snort enforcement report equals the CPU path")
    print(f"ids: Snort: every planted sid alerts; stage 1 equals a native walk "
          f"of every payload; alerts, candidates and the enforcement report "
          f"equal the CPU path ({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    for key, strategy, data in (("l7_dev", "lazy-device", l7_cut),
                                ("l7_act", "active-set", l7_flows),
                                ("l7_pre", "prefiltered", pre_flows)):
        cols = [names.index(n) for n in l7[strategy].rule_names]
        want = ref.scan(data).rule_counts[:, cols]
        check(np.array_equal(got[key].rule_counts, want),
              f"{calls[key][0]}: per-rule counts equal compile_regex_set's")
        check(int(want.sum()) > 0, f"{calls[key][0]}: rules matched")
    print(f"ids: compile_l7 under lazy-device, active-set and prefiltered "
          f"equals compile_regex_set's lazy host walk, rule by rule "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # K2 at the Snort prefilter shape, against its plain version
    snort_k2 = {}
    for name, (args, kw) in k2_args.items():
        out = hd.dfa_chain_counts(*args, **kw)
        err = max_abs_err(out, hd.dfa_chain_counts_plain(*args, **kw))
        check(err == 0, f"K2 at the Snort {name} shape differs by {err}")
        ms = event_ms(lambda: hd.dfa_chain_counts(*args, **kw), 20)
        _, plain_ms = one_run_ms(lambda: hd.dfa_chain_counts_plain(*args, **kw))
        table, accept, cls_seq, entries = args
        bound = bound_ms((cls_seq, table, accept, entries), out)
        snort_k2[name] = {"shape": f"table ({table.shape[0]}, {table.shape[1]}), "
                                   f"{cls_seq.shape[1]} lanes x {cls_seq.shape[0]} "
                                   f"steps, {kw['num_streams']} histogram rows",
                          "ms": ms, "plain_ms": plain_ms, "bound_ms": bound}
        print(f"time: dfa_chain_counts[Snort prefilter {name}, "
              f"{snort_k2[name]['shape']}] {ms:.4f} ms, plain {plain_ms:.2f} ms, "
              f"bound {bound:.4f} ms, bit-exact against plain (tolerance 0)",
              flush=True)
    kernel_times["dfa_chain_counts"]["snort_prefilter"] = snort_k2

    check_cli(dev, work, ids, rules_text, payloads, snort_bytes, l7_bytes)
    shutil.rmtree(work, ignore_errors=True)
    return launches, device_calls, ids, payloads, (medians["snort"], rep)


def check_cli(dev, work, ids, rules_text, payloads, snort_bytes, l7_bytes):
    """The CLI as subprocesses, each held to the in-process API on the same
    files and to the JAX CLI's exit code for that input (0: something
    found; 1: nothing), with its wall time."""
    from regex_fpga_tpu_torch import api
    from regex_fpga_tpu_torch.models import gen_l7_patterns

    f = {k: os.path.join(work, v) for k, v in (
        ("big", "snort64.bin"), ("small", "snort1.bin"), ("l7", "l7.bin"),
        ("rules", "community.rules"),
        ("l7_rules", "l7_rules.txt"), ("coe", "l7.coe"), ("text", "text.txt"),
        ("gen", "gen.rules"))}
    snort_bytes.tofile(f["big"])
    snort_bytes[:MIB].tofile(f["small"])
    l7_bytes[:MIB].tofile(f["l7"])
    with open(f["rules"], "w") as fh:
        fh.write(rules_text)
    # the first 40 payloads (4 with a planted attack), a file each: the
    # CLI scans each file as one stream
    traffic = [os.path.join(work, f"payload{i:02d}.bin") for i in range(40)]
    for path, p in zip(traffic, payloads):
        with open(path, "wb") as fh:
            fh.write(p)
    unanchored = [(("(?i)" + p) if icase else p).encode("latin1")
                  for _, p, icase, _ in gen_l7_patterns() if not p.startswith("^")]
    with open(f["l7_rules"], "wb") as fh:
        fh.write(b"# the unanchored l7-corpus patterns\n" + b"\n".join(unanchored))
    text = tiled(FRAG, MIB)
    text.tofile(f["text"])
    small = snort_bytes[:MIB]

    def lines(rows) -> bytes:
        return "".join(f"{r}\n" for r in rows).encode("latin1")

    def status(found) -> int:
        return 0 if found else 1

    count_pat = r"[0-9]+\.[0-9]+"
    n = api.compile_regex(count_pat, device=dev).count([snort_bytes])
    ends = api.compile_regex(r"Host: [a-z0-9.-]+", device=dev).findall_ends(small)
    lits = [b"GET ", b"Host: ", b"cmd.exe", b"zzzz"]
    per_lit = api.compile_literals(lits, device=dev).scan_patterns([small]) \
        .pattern_counts[0]
    pats = [rb"GET /[a-z]+", rb"Host: [a-z]+", rb"^GET", rb"zzzz[0-9]"]
    per_rule = api.compile_regex_set_prefiltered(pats, device=dev).scan([small]) \
        .rule_counts[0]
    snort_out = [
        f"{path}: sid={a.sid if a.sid is not None else '-'} {a.msg}"
        + ("" if a.pcre_checked else
           " [content-only]" if ids.rules[a.rule_index].pcre else "")
        for path, p in zip(traffic, payloads) for a in ids.scan([p]).alerts[0]]
    rs = api.compile_regex_set(unanchored, device=dev)
    rs_counts = rs.scan([l7_bytes[:MIB]]).rule_counts[0]
    tok = api.compile_tokenizer(device=dev)
    cli = [  # name, arguments, expected stdout (or None), expected exit code
        ("grep -c 64 MiB", ["grep", "-c", count_pat, f["big"]],
         lines([f"{f['big']}:{n}"]), status(n)),
        ("grep 1 MiB", ["grep", r"Host: [a-z0-9.-]+", f["small"]],
         lines([f"{f['small']}:{e}" for e in ends.tolist()]), status(len(ends))),
        ("acgrep 1 MiB", ["acgrep", *[a for lit in lits for a in ("-e", lit.decode())],
                          f["small"]],
         lines([f"{f['small']}:{lits[i].decode()}:{c}"
                for i, c in enumerate(per_lit.tolist()) if c]),
         status(per_lit.sum())),
        ("rgrep 1 MiB", ["rgrep", *[a for p in pats for a in ("-e", p.decode())],
                         f["small"]],
         lines([f"{f['small']}:{pats[i].decode()}:{c}"
                for i, c in enumerate(per_rule.tolist()) if c]),
         status(per_rule.sum())),
        ("snort 40 payloads", ["snort", f["rules"], *traffic], lines(snort_out),
         status(snort_out)),
        ("snort --coverage", ["snort", f["rules"], "--coverage"],
         lines([json.dumps(r) for r in ids.enforcement_report()["rules"]]), 0),
        ("compile-rules --scan", ["compile-rules", f["l7_rules"], "-o", f["coe"],
                                  "--scan", f["l7"]],
         lines([f"{len(unanchored)} rules -> {rs.automaton.num_states} states, "
                f"{len(rs.automaton.trans_char)} transitions -> {f['coe']}"]
               + [f"rule {i} ({p.decode('latin1')}): {int(c)} matches"
                  for i, (p, c) in enumerate(zip(unanchored, rs_counts))]), 0),
        ("scan", ["scan", "--coe", f["coe"], f["l7"]], None, 0),
        ("gen-corpus", ["gen-corpus", "snort", f["gen"]], b"", 0),
        ("presplit 1 MiB", ["presplit", f["text"]],
         b"".join(p + b"\n" for p in tok.pieces(text.tobytes())), 0),
    ]
    for name, args, want_out, want_rc in cli:
        rc, out, err, wall = run_cli(args)
        check(rc == want_rc, f"cli {name}: exit code {rc}, expected {want_rc}:\n"
                             f"{err.decode(errors='replace')[-2000:]}")
        if name == "scan":
            # the histogram of the .coe that compile-rules wrote, then the
            # metrics line (its wall-clock fields differ run to run)
            hist = api.compile_ruleset(f["coe"], device=dev).scan(
                [l7_bytes[:MIB]])
            rows = out.decode().splitlines()
            check(rows[:-1] == [f"# stream 0: {f['l7']}"]
                  + [f"state {s_}: {c}" for s_, c in sorted(hist.histogram(0).items())],
                  "cli scan: the histogram equals the API's")
            check(json.loads(rows[-1])["total"] == hist.total > 0,
                  "cli scan: the total equals the API's")
        else:
            check(out == want_out, f"cli {name}: stdout differs from the API's")
        if name == "gen-corpus":
            with open(f["gen"]) as fh:
                check(fh.read() == rules_text, "cli gen-corpus: the rules file")
        n_lines = out.count(b"\n")
        print(f"ids: cli {name}: exit {rc}, {wall:.2f} s wall (import and "
              f"kernel load included), stdout equals the API ({n_lines} "
              f"lines)", flush=True)


# ---------------------------------------------------------------- phase 7

FIT_SPEC_BYTES = 256 << 10  # with 1 MiB: the host's speculative walk
HELD_OUT_BYTES = (6 << 10, 12 << 10, 64 << 10, 128 << 10)  # near the modeled crossover
# timed runs per case and engine (3 for the Snort batch)
ROUTER_REPEATS = {n: 5 for n in (4096, FIT_SPEC_BYTES, MIB, *HELD_OUT_BYTES)}
ROUTER_REPEATS.update({64 * MIB: 2, 256 * MIB: 2})
GATE_STATES = (23, 32, 67, 107)


def oracle_scan(m, streams):
    """Counts (n, S) and final states of a serial native walk of each
    stream, the end-of-stream match included: the host oracle of phase 7."""
    from regex_fpga_tpu_torch import native

    t = [x.cpu().numpy() for x in (m.tables.table, m.tables.class_of,
                                   m.tables.accept)]
    counts = np.zeros((len(streams), m.num_states), np.int64)
    finals = np.zeros(len(streams), np.int64)
    for i, s_ in enumerate(streams):
        counts[i], _, finals[i] = native.dfa_scan(*t, s_, m.start,
                                                  want_mask=False)
        if len(s_) and m._accept_eof[finals[i]]:
            counts[i, finals[i]] += 1
    return counts, finals


def device_finals(m, streams):
    """The final states the device engines reach on ``streams`` (the path
    that ``scan`` takes for this batch shape)."""
    if len(streams) == 1:
        m._scan_stream_counts(streams[0])
        return np.array([m._last_final])
    if len({len(s_) for s_ in streams}) == 1:
        return m._scan_batch_counts(np.stack(streams))[3]
    return m._scan_ragged_counts(streams)[3]


def gate_automata():
    """(S, tables) of the k-gram gate sweep: the tokenizer and Aho-Corasick
    automata of 32, 67 and 107 states over the keyword list."""
    from regex_fpga_tpu_torch.models import build_aho_corasick, build_tokenizer_dfa
    from regex_fpga_tpu_torch.ops.tables import build_dfa_tables

    tok = build_tokenizer_dfa()
    out = [build_dfa_tables(tok.table, tok.accept)]
    for words in ([b"error0000", b"warning000", b"fail0ure", b"GET "],
                  WORDS[:8], WORDS[:24]):
        dfa = build_aho_corasick(words).dfa
        out.append(build_dfa_tables(dfa.table, dfa.accept))
    check([t.num_states for t in out] == list(GATE_STATES),
          f"gate automata of {[t.num_states for t in out]} states")
    return out


def phase_gate(dev, text, big):
    """The k-gram gate sweep (ops/kgram.py's KGRAM_SWEEP): over one 64 MiB
    chunk of text at 65,536 lanes, K2 (level 0) and K3 at k = 2, 4 and 8
    bytes a step (levels 1-3), for the automata of GATE_STATES over
    ``text`` and the larger tables of ``big`` ((tables, traffic) pairs) over
    their traffic; K3 over raw text where the kernel takes the table with
    its maps, else the level's map of the bytes to class ids and K3 over
    them. K2 takes the class ids that every device scan maps (timed apart).
    The K2 against K3 (k = 4) crossover is KGRAM_MAX_STATES."""
    from regex_fpga_tpu_torch.ops import hopper_dfa as hd
    from regex_fpga_tpu_torch.ops import hopper_kgram as hk
    from regex_fpga_tpu_torch.ops.kgram import (KGRAM_MAX_STATES, build_kgram,
                                                choose_kgram_level,
                                                kgram_maps, kgram_step_cost,
                                                pack_ta)

    nb = 64 * MIB // 1024  # 65,536 lanes of 1,024 bytes
    ent = torch.zeros(nb, dtype=torch.int32, device=dev)
    rows, classes = [], {}
    for t, data in [(g, text) for g in gate_automata()] + list(big):
        t = t.to(dev)
        raw = torch.as_tensor(data[:64 * MIB], device=dev)
        s, c = t.num_states, t.num_classes
        lut = t.class_of.to(torch.uint8)
        cls = torch.index_select(lut, 0, raw.int()).reshape(nb, 1024).T
        ms = event_ms(lambda: hd.dfa_chain_counts(t.table, t.accept, cls, ent), 20)
        # the scan pipeline's byte-class map (DfaMatcher._classes), apart
        map_ms = event_ms(lambda: torch.index_select(lut, 0, raw.int()), 20)
        route = hd.dfa_chain_route("counts", c, s, num_lanes=nb)["table"]
        rows.append({"S": s, "level": 0, "C_l": c, "route": route,
                     "input": "class ids", "ms": ms, "class_map_ms": map_ms})
        classes[s] = [c]
        for lv in (1, 2, 3):
            kg = build_kgram(t, levels=lv)
            if kg is None:
                print(f"router: gate S={s} level {lv}: the composed classes "
                      f"exceed build_kgram's limits", flush=True)
                break
            c_l, k = kg.level_classes[-1], kg.k
            classes[s].append(c_l)
            ta = pack_ta(torch.as_tensor(kg.table),
                         torch.as_tensor(kg.acc_table)).to(dev)
            maps = kgram_maps(kg).to(dev)
            if hk.kgram_bytes_supported(ta, maps):
                src = raw.reshape(nb, 1024 // k, k).transpose(0, 1)
                ms = event_ms(lambda: hk.kgram_chain_bytes(ta, maps, src, ent), 20)
                how, route = "raw text", hk.kgram_chain_route(ta, maps, num_lanes=nb)
            else:  # the level's own map from the bytes counts with it
                dtype = torch.int16 if c_l < 1 << 15 else torch.int32
                ms = event_ms(lambda: hk.kgram_chain(
                    ta, hk.map_classes(maps, raw.reshape(nb, 1024)).T.to(dtype),
                    ent), 20)
                how, route = "bytes mapped to class ids", hk.kgram_chain_route(
                    ta, None, class_dtype=dtype, num_lanes=nb)
            rows.append({"S": s, "level": lv, "C_l": c_l, "route": route["table"],
                         "input": how, "ms": ms})
    for r in rows:
        r["model_ms"] = kgram_step_cost(r["S"], r["C_l"], r["level"]) * 64 * MIB * 1e3
        extra = (f"; the scan pipeline's byte-class map {r['class_map_ms']:.4f} ms"
                 if "class_map_ms" in r else "")
        print(f"router: gate S={r['S']} level {r['level']} C_l={r['C_l']} "
              f"({r['route']}, {r['input']}): {r['ms']:.4f} ms per 64 MiB "
              f"(committed model {r['model_ms']:.4f}){extra}", flush=True)
    by = {(r["S"], r["level"]): r["ms"] for r in rows}
    card = 0
    for s in GATE_STATES:
        if by.get((s, 2), float("inf")) >= by[(s, 0)]:
            break
        card = s
    sweep = {lv: [(r["S"], r["C_l"], r["route"], round(r["ms"], 4))
                  for r in rows if r["level"] == lv] for lv in (0, 1, 2, 3)}
    levels = {s: choose_kgram_level(s, cl) for s, cl in classes.items()
              if len(cl) > 1}
    print(f"router: gate: K3 (k = 4) wins up to S={card} of {list(GATE_STATES)}; "
          f"KGRAM_MAX_STATES = {KGRAM_MAX_STATES}; level classes "
          f"{json.dumps(classes)}; choose_kgram_level under the committed "
          f"model {json.dumps(levels)}", flush=True)
    print(f"router: gate: KGRAM_SWEEP of this run {json.dumps(sweep)}", flush=True)
    return {"rows": rows, "card_max_states": card, "sweep": sweep,
            "level_classes": classes, "choose_kgram_level": levels,
            "KGRAM_MAX_STATES": KGRAM_MAX_STATES}


def merge_loads(table, cls, checks: int) -> int:
    """The table loads that K6 pass 1's merging route needs on these blocks:
    every start state walks to the first check (8 bytes), then the distinct
    states of each block at that check to the next (16, 32, ...), the last
    of them to the end of the block (a plain walk of all S chains on the
    card, counting the distinct states of each block at every check)."""
    nb, b = cls.shape
    c_dim, s_dim = table.shape
    flat = table.reshape(-1)
    states = torch.arange(s_dim, dtype=torch.int64, device=cls.device).expand(nb, s_dim)
    live = torch.full((nb,), s_dim, dtype=torch.int64, device=cls.device)
    loads = torch.zeros((), dtype=torch.int64, device=cls.device)
    at, done = 8, 0
    for t in range(b):
        c = cls[:, t:t + 1].long()
        ok = c < c_dim
        states = torch.where(ok, torch.take(flat, torch.where(ok, c, 0) * s_dim + states), 0)
        loads += live.sum()
        if t + 1 == at and done < checks:
            srt = torch.sort(states, dim=1).values
            live = (srt[:, 1:] != srt[:, :-1]).sum(1) + 1
            at, done = at * 2, done + 1
    return int(loads)


def combine_groups(fns, start, combine) -> tuple:
    """``combine`` over ``fns`` in the groups dfa_scan_blocked makes (at most
    FN_GROUP_BYTES of functions each), each group entered in the final state
    of the one before: (entry states, final state)."""
    from regex_fpga_tpu_torch.ops.dfa_engine import FN_GROUP_BYTES

    group = max(1, FN_GROUP_BYTES // (4 * fns.shape[1]))
    cur = torch.tensor([start], dtype=torch.int32, device=fns.device)
    entries = []
    for g0 in range(0, fns.shape[0], group):
        entry, cur = combine(fns[g0:g0 + group], cur)
        entries.append(entry)
    return torch.cat(entries), cur.reshape(())


def combine_contract(dev, fns) -> None:
    """The combine's contract on the card: ``dfa_engine.block_entry_states``
    with an entry of ``fns`` outside [0, S), or with a tensor start outside
    it, raises the CPU's ``ValueError``, message and all, and launches no
    combine; in range it equals the CPU's doubling."""
    from regex_fpga_tpu_torch.ops import hopper_dfa as hd
    from regex_fpga_tpu_torch.ops.dfa_engine import block_entry_states

    s = fns.shape[1]
    one = torch.tensor([1], dtype=torch.int32)
    got = block_entry_states(fns, one.to(dev))
    want = block_entry_states(fns.cpu(), one)
    check(all(torch.equal(g.cpu(), w) for g, w in zip(got, want)),
          "block_entry_states on the card equals the CPU's")
    cases = []
    for value in (-1, s):
        bad = fns.clone()
        bad[fns.shape[0] // 2, 1] = value
        cases.append((f"entry {value}", bad, one))
        cases.append((f"start {value}", fns,
                      torch.tensor([value], dtype=torch.int32)))
    for name, f, start in cases:
        messages = []
        for i, where in enumerate((dev, torch.device("cpu"))):
            before = hd.LAUNCHES["dfa_fn_combine"]
            try:
                block_entry_states(f.to(where), start.to(where))
            except ValueError as err:
                messages.append(str(err))
            check(len(messages) == i + 1,
                  f"block_entry_states raises on {name} ({where})")
            check(hd.LAUNCHES["dfa_fn_combine"] == before,
                  f"no combine launched on {name} ({where})")
        check(messages[0] == messages[1],
              f"{name}: the card's error {messages[0]!r} is the CPU's "
              f"{messages[1]!r}")
        print(f"fallback: combine contract, {name} of S = {s}: block_entry_states "
              f"raises ValueError({messages[0]!r}) on the card as on the CPU, "
              f"before any launch", flush=True)


def phase_fallback(dev, ac_tables, rng):
    """K6 against its plain versions, bit for bit (tolerance 0): pass 1
    (dfa_block_fns) on the reversed (aa)*b automaton and a parity automaton
    over 16 MiB and 64 MiB, and on the 300-keyword Aho-Corasick table and a
    seeded permutation automaton of the same shape (36, 836; no two chains
    ever meet) over 64 MiB, with its time, bound, route and both floors;
    then the combine (dfa_fn_combine) at S = 2, 3 and 836, in the groups
    dfa_scan_blocked makes, from a start other than 0 and with constant
    functions mixed in, against the doubling. Returns the kernel-line
    entries of pass 1 and the combine, and the fallback calls' automata."""
    from regex_fpga_tpu_torch.models import CompiledDfa, compile_pattern
    from regex_fpga_tpu_torch.ops import hopper_dfa as hd
    from regex_fpga_tpu_torch.ops.tables import build_dfa_tables

    # the parity of the bytes below 0x80: on random bytes a block's entry
    # state is a coin flip that no replay of the bytes before it predicts
    ptable = np.zeros((256, 2), dtype=np.int32)
    ptable[:128] = [1, 0]
    ptable[128:] = [0, 1]
    parity = CompiledDfa(table=ptable, accept=np.array([False, True]),
                         start=0, dead=0)
    rev = compile_pattern(r"(aa)*b", anchored=False, reverse=True)
    autos = {"parity": parity, "reversed (aa)*b": rev}
    tabs = {k: build_dfa_tables(d.table, d.accept, device=dev)
            for k, d in autos.items()}
    tabs["aho-corasick"] = ac_tables
    c_ac, s_ac = ac_tables.table.shape
    perm = np.stack([rng.permutation(s_ac) for _ in range(c_ac)]).astype(np.int32)
    # byte b takes class b % C: random bytes spread over all C permutations
    tabs["permutation"] = build_dfa_tables(perm[np.arange(256) % c_ac],
                                           np.zeros(s_ac, bool), device=dev)
    # runs of a's and b's for (aa)*b, random bytes for the others
    ab = np.where(rng.random(64 * MIB) < 0.9999, ord("a"), ord("b")).astype(np.uint8)
    noise = rng.integers(0, 256, size=64 * MIB, dtype=np.uint8)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_hz = 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    issue = sms * 32 * clock_hz  # shared-memory loads a second: 32 a clock an SM
    chase = chase_ns(2)  # a dependent uint16 shared load, the latency under a chain
    err, times, fns = 0, {}, {}
    for name, t in tabs.items():
        data = ab if name.startswith("reversed") else noise
        lut = t.class_of.to(torch.uint8)
        for size in (16 * MIB, 64 * MIB):
            if name in ("aho-corasick", "permutation") and size == 16 * MIB:
                continue
            cls = torch.take(lut, torch.as_tensor(data[:size], device=dev).long()) \
                .reshape(-1, 1024)
            got = hd.dfa_block_fns(t.table, cls)
            want, plain_ms = one_run_ms(lambda: hd.dfa_block_fns_plain(t.table, cls))
            e = max_abs_err((got,), (want,))
            err = max(err, e)
            ms = event_ms(lambda: hd.dfa_block_fns(t.table, cls), 5)
            c, s = t.table.shape
            nb, b = cls.shape
            route = hd.dfa_block_fns_route(c, s, nb, b)
            bound = bound_ms((cls, t.table), (got,))
            loads = nb * b * s
            # a design that walks every start state of every block: at most
            # 32 shared-memory loads a clock an SM, at the top clock
            floor = loads / issue * 1e3
            # this design: the loads its merging needs on this data, and no
            # less than one chain of B dependent loads
            needed = (merge_loads(t.table, cls, route["merge_checks"])
                      if route["merge_checks"] else loads)
            new_floor = max(b * chase * 1e-6, needed / issue * 1e3)
            times[(name, size)] = {
                "shape": f"{name} ({c}, {s}), {nb} blocks x {b}", "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound, "loads": loads,
                "smem_load_floor_ms": floor, "merge_loads": needed,
                "merge_floor_ms": new_floor, "pass1_route": route}
            print(f"time: dfa_block_fns[{name} S={s} C={c}, {nb} blocks x {b}, "
                  f"route {json.dumps(route)}] {ms:.4f} ms, plain {plain_ms:.2f} ms, "
                  f"bound {bound:.4f} ms; floors: every start state walked {floor:.4f} ms "
                  f"({loads} loads at {issue / 1e12:.2f} T a second: {sms} SMs x 32 "
                  f"a clock at {clock_hz / 1e6:.0f} MHz), this design's "
                  f"{new_floor:.4f} ms (max of one chain of {b} loads x {chase:.2f} "
                  f"ns and {needed} loads its merging needs at that rate); "
                  f"bit-exact against plain (max_abs_err {e}, tolerance 0)", flush=True)
            if size == 64 * MIB:
                fns[name] = got
    check(err == 0, f"dfa_block_fns differs from its plain version by {err}")

    # the combine: the groups that dfa_scan_blocked makes, a start other
    # than 0, constant functions mixed in
    cerr, ctimes = 0, {}
    three = rng.integers(0, 3, size=(20_000, 3)).astype(np.int32)
    combine_fns = {
        "S=2 parity": fns["parity"].clone(),
        "S=3 random": torch.as_tensor(three, device=dev),
        "S=836 aho-corasick": fns["aho-corasick"],
        "S=836 permutation": fns["permutation"],
    }
    for name, f in combine_fns.items():
        s = f.shape[1]
        if s < 836:  # every fifth function constant (the permutation's: none)
            f[::5] = f[::5, :1]
        start = s // 2 + 1 if s > 2 else 1
        got = combine_groups(f, start, hd.dfa_fn_combine)
        want, plain_ms = one_run_ms(lambda: combine_groups(f, start, hd.dfa_fn_combine_plain))
        e = max_abs_err(got, want)
        cerr = max(cerr, e)
        ms = event_ms(lambda: combine_groups(f, start, hd.dfa_fn_combine), 5)
        plain_ms = event_ms(lambda: combine_groups(f, start, hd.dfa_fn_combine_plain), 2)
        bound = bound_ms((f,), (got[0],))
        n_const = int((f == f[:, :1]).all(1).sum())
        ctimes[name] = {"shape": f"{name}, {f.shape[0]} functions", "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound,
                        "constant_functions": n_const}
        print(f"time: dfa_fn_combine[{name}, {f.shape[0]} functions ({n_const} "
              f"constant), start {start}, groups of at most "
              f"{max(1, (64 << 20) // (4 * s))}] {ms:.4f} ms, the doubling (plain) "
              f"{plain_ms:.4f} ms, bound {bound:.4f} ms; entries and final state "
              f"bit-exact against the doubling (max_abs_err {e}, tolerance 0)",
              flush=True)
    check(cerr == 0, f"dfa_fn_combine differs from the doubling by {cerr}")
    combine_contract(dev, combine_fns["S=3 random"])

    def entry(main, others):
        return {"max_abs_err": main.get("max_abs_err", 0), "ms": main["ms"],
                "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                "bound_by": "bytes", "library_ms": LIBRARY_MS,
                **{k: v for k, v in main.items()
                   if k not in ("ms", "plain_ms", "bound_ms")},
                "other_shapes": [dict(v) for v in others]}

    main = dict(times[("aho-corasick", 64 * MIB)], max_abs_err=err)
    k6 = entry(main, [v for k, v in times.items() if k != ("aho-corasick", 64 * MIB)])
    comb = entry(dict(ctimes["S=836 aho-corasick"], max_abs_err=cerr),
                 [v for k, v in ctimes.items() if k != "S=836 aho-corasick"])
    return k6, comb, {"parity": parity, "rev": rev, "ab": ab, "noise": noise}


def fallback_split(m, data: np.ndarray) -> dict:
    """Device milliseconds of the exact fallback's stages over ``data`` (a
    whole number of 1,024-byte blocks) on matcher ``m``'s tables, CUDA
    events around each stage as dfa_scan_blocked runs them: the class map,
    pass 1 (K6), the combine, pass 2 (K1's full mode), the counts, and the
    mask and states that the call returns."""
    from regex_fpga_tpu_torch.ops import hopper_dfa as hd
    from regex_fpga_tpu_torch.ops.dfa_engine import FN_GROUP_BYTES

    t = m.tables
    s, block = t.num_states, 1024
    stream = torch.as_tensor(data, device=t.device)
    nb = stream.shape[0] // block
    marks = []

    def timed(stage, fn):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        marks.append((stage, a, b))
        return out

    torch.cuda.synchronize()
    classes = timed("class map", lambda: torch.take(
        t.class_of.to(torch.uint8), stream.long()).reshape(nb, block))
    group = max(1, FN_GROUP_BYTES // (4 * s))
    counts = torch.zeros(s, dtype=torch.int64, device=t.device)
    cur = torch.tensor([m.start], dtype=torch.int32, device=t.device)
    masks, states = [], []
    for g0 in range(0, nb, group):
        cls_g = classes[g0:g0 + group]
        f = timed("pass 1", lambda: hd.dfa_block_fns(t.table, cls_g))
        entry, cur = timed("combine", lambda: hd.dfa_fn_combine(f, cur))
        _, visited, acc = timed("pass 2", lambda: hd.dfa_chain(
            t.table, t.accept, cls_g.T, entry, mode="full"))
        visited, acc = visited.T.reshape(-1), acc.T.reshape(-1)
        timed("counts", lambda: counts.add_(
            torch.bincount(visited[acc].long(), minlength=s)[:s]))
        masks.append(acc)
        states.append(visited)
    timed("mask and states", lambda: (torch.cat(masks), torch.cat(states)))
    torch.cuda.synchronize()
    split = {}
    for stage, a, b in marks:
        split[stage] = split.get(stage, 0.0) + a.elapsed_time(b)
    return split


def phase_router(dev, ids, payloads, snort_auto, ac_text, snort_bytes,
                 kernel_times, out_dir):
    """The engine router and the exact fallback through the API: every case
    of S x workload x batch shape under "device", "host" and "auto", each
    held to the host oracle (the fit's cases, the held-out ones and the
    probed one); the Snort call under "auto" and "device"; the k-gram gate;
    K6 against its plain version and the DfaMatcher calls that take the
    fallback. ``snort_auto`` is phase 6's
    median and report of the Snort call under "auto". Returns the launch counts of
    the main-path run (the routed calls and the fallback calls)."""
    from regex_fpga_tpu_torch import api, native
    from regex_fpga_tpu_torch.models import build_aho_corasick
    from regex_fpga_tpu_torch.ops import router

    rng = np.random.default_rng(SEED + 7)
    text = np.frombuffer(FRAG * (64 * MIB // len(FRAG) + 1), np.uint8)[:64 * MIB]
    cfg = api.EngineConfig()
    check(cfg.scan_backend == "auto", "the default backend is auto")
    ac_global = build_aho_corasick(WORDS).dfa
    autos = {  # label: (matcher, traffic)
        "tokenizer": (api.compile_tokenizer(config=cfg, device=dev), text),
        "aho-corasick": (api.DfaMatcher(build_aho_corasick(WORDS[:300]).dfa,
                                        cfg, device=dev), ac_text),
        "snort exact": (ids._exact, snort_bytes),
        "snort case-folded": (ids._fold, snort_bytes),
        "aho-corasick 1,500 keywords": (api.DfaMatcher(ac_global, cfg, device=dev),
                                        ac_text),
    }
    routes = {}
    for label, (m, _) in autos.items():
        check(m.config.scan_backend == "auto", f"{label}: auto backend")
        s, c = m.num_states, m.tables.num_classes
        routes[label] = router.device_route(s, c)
    check(routes["aho-corasick 1,500 keywords"] == "global",
          "the 1,500-keyword automaton takes K2's global route")
    print(f"router: automata {json.dumps({k: [m.num_states, m.tables.num_classes, routes[k]] for k, (m, _) in autos.items()})}; "
          f"native walker on {os.cpu_count()} cores", flush=True)

    # the fit's cases (fit_priors), then held-out single streams of sizes
    # that no fit uses, near the modeled crossover
    cases = []
    for label, (m, data) in autos.items():
        for size in (4096, FIT_SPEC_BYTES, MIB, 64 * MIB):
            for n in ((1,) if size == FIT_SPEC_BYTES else (1, 4, 64)):
                chunk = data[:size]
                cases.append((label, m, f"{n} x {size // n} B" if n > 1 else
                              f"1 x {size} B", list(chunk.reshape(n, -1)), size,
                              False))
        cases.append((label, m, f"Snort batch {len(payloads)} payloads",
                      [np.frombuffer(p, np.uint8) for p in payloads],
                      sum(map(len, payloads)), False))
    for label, (m, data) in autos.items():
        for size in HELD_OUT_BYTES:
            cases.append((label, m, f"1 x {size} B", [data[:size]], size, True))

    def run_case(label, m, shape, streams, nbytes, held_out):
        reps = ROUTER_REPEATS.get(nbytes, 3)
        want, want_fin = oracle_scan(m, streams)
        med, spread = {}, {}
        for backend in ("device", "host"):
            f = forced(m, backend)
            r = f.scan(streams)
            check(np.array_equal(r.counts, want),
                  f"{label} {shape} {backend}: counts equal the host oracle")
            check((r.metrics.engine == "dfa-host-native") == (backend == "host"),
                  f"{label} {shape} {backend}: engine {r.metrics.engine}")
            ms = wall_ms(lambda: f.scan(streams), reps)
            med[backend], spread[backend] = float(np.median(ms)), max(ms) / min(ms)
        fin_dev = device_finals(forced(m, "device"), streams)
        fin_host = forced(m, "host")._host_scan_counts(streams)[1]
        check(np.array_equal(fin_dev, want_fin) and np.array_equal(fin_host, want_fin),
              f"{label} {shape}: finals equal the host oracle")
        choice = "host" if m._host_backend(len(streams), nbytes) else "device"
        r = m.scan(streams)
        check(np.array_equal(r.counts, want), f"{label} {shape} auto: counts")
        check((r.metrics.engine == "dfa-host-native") == (choice == "host"),
              f"{label} {shape} auto: engine {r.metrics.engine}, route {choice}")
        best = min(med.values())
        s, c = m.num_states, m.tables.num_classes
        row = {"automaton": label, "S": s, "C": c, "route": routes[label],
               "shape": shape, "rows": len(streams), "bytes": nbytes,
               "held_out": held_out,
               "device_ms": med["device"], "host_ms": med["host"], "auto": choice,
               "device_spread": spread["device"], "host_spread": spread["host"],
               "ratio": best / med[choice],
               "model_device_ms": router.device_seconds(s, c, nbytes, len(streams)) * 1e3,
               "model_host_ms": router.host_seconds(s, nbytes, len(streams)) * 1e3}
        print(f"router: {label} S={s} {shape}{' (held out)' if held_out else ''}: "
              f"device {nbytes / med['device'] / 1e6:.3f} GB/s ({med['device']:.3f} ms), "
              f"host {nbytes / med['host'] / 1e6:.3f} GB/s ({med['host']:.3f} ms), "
              f"auto -> {choice}, chosen/best {row['ratio']:.3f}; model "
              f"{row['model_device_ms']:.3f} / {row['model_host_ms']:.3f} ms; "
              f"counts and finals equal the host oracle", flush=True)
        return row

    reset_launches()
    t_phase = time.perf_counter()
    rows = [run_case(*case) for case in cases]
    for held in (False, True):
        ratios = [r["ratio"] for r in rows if r["held_out"] == held]
        print(f"router: {len(ratios)} {'held-out' if held else 'fitted'} cases, "
              f"every engine equal to the host oracle; chosen/best: worst "
              f"{min(ratios):.3f}, median {np.median(ratios):.3f}", flush=True)
    print(f"router: cases took {time.perf_counter() - t_phase:.1f} s", flush=True)

    # the probes and the margin on the card: a routed batch of 4 x 64 MiB,
    # whose modeled ratio lies in the contested band, in a fresh session
    m = autos["tokenizer"][0]
    streams = [text] * 4
    nbytes = 4 * text.size
    s, c = m.num_states, m.tables.num_classes
    prior = router.host_seconds(s, nbytes, 4) / router.device_seconds(s, c, nbytes, 4)
    check(nbytes >= router.PROBE_MIN_WORKLOAD
          and router.PROBE_BAND[0] <= prior <= router.PROBE_BAND[1],
          f"the probe case is contested (modeled ratio {prior:.3f})")
    router.reset_session()
    t0 = time.perf_counter()
    m._host_backend(4, nbytes)
    probe_s = time.perf_counter() - t0
    check(len(router.session_rates()) == 2, "the contested call probed both engines")
    probed = router.host_seconds(s, nbytes, 4) / router.device_seconds(s, c, nbytes, 4)
    rates = router.session_rates()
    row = run_case("tokenizer", m, f"4 x {text.size} B, probed", streams, nbytes,
                   True)
    rows.append(row)
    print(f"router: probed call: modeled ratio host/device {prior:.3f} on the "
          f"priors, {probed:.3f} on the probes "
          f"({json.dumps({k: round(v / 1e9, 4) for k, v in rates.items()})} GB/s, "
          f"{probe_s:.3f} s of probes); DEVICE_MARGIN {router.DEVICE_MARGIN} -> "
          f"{row['auto']}, chosen/best {row['ratio']:.3f}", flush=True)
    router.reset_session()

    # the Snort call as users run it ("auto") beside stage 1 on the card
    ids_dev = forced(ids, "device")
    ids_dev._exact, ids_dev._fold = forced(ids._exact, "device"), forced(ids._fold, "device")
    # phase 6 timed the Snort call as users run it ("auto"); here the same
    # call with stage 1 forced to the card
    streams = [np.frombuffer(p, np.uint8) for p in payloads]
    reports = {"auto": snort_auto[1]}
    snort = {"auto": {"call_ms": snort_auto[0]}, "device": {}}
    snort["device"]["call_ms"] = float(np.median(wall_ms(
        lambda: reports.__setitem__("device", ids_dev.scan(payloads)), 2)))
    for name, mm in (("auto", ids), ("device", ids_dev)):
        snort[name]["stage1_ms"] = float(np.median(wall_ms(
            lambda: mm._prefilter_counts(streams), IDS_REPEATS)))
    check(alert_rows(reports["auto"]) == alert_rows(reports["device"]),
          "Snort alerts equal under auto and device")
    print(f"router: Snort call over {len(payloads)} payloads: auto "
          f"{snort['auto']['call_ms']:.2f} ms (phase 6, median of {IDS_REPEATS}; "
          f"stage 1 {snort['auto']['stage1_ms']:.2f}), device "
          f"{snort['device']['call_ms']:.2f} ms (median of 2; stage 1 "
          f"{snort['device']['stage1_ms']:.2f}; stage 1 medians of "
          f"{IDS_REPEATS}); alerts equal", flush=True)
    launches = launch_counters()  # the routed calls' launches

    # the exact fallback: K6 against plain, then the DfaMatcher calls
    k6, comb, fb = phase_fallback(dev, autos["aho-corasick"][0].tables, rng)
    kernel_times["dfa_block_fns"] = k6
    kernel_times["dfa_fn_combine"] = comb
    pcfg = api.EngineConfig(scan_backend="device")
    fb_calls = {
        "parity 64 MiB": (api.DfaMatcher(fb["parity"], pcfg, device=dev), fb["noise"]),
        "reversed (aa)*b 16 MiB": (api.DfaMatcher(fb["rev"], pcfg, device=dev),
                                   fb["ab"][:16 * MIB]),
    }
    from regex_fpga_tpu_torch.ops import dfa_engine, hopper_dfa

    range_checks = []  # the combine's range check waits for the device:
    checker = hopper_dfa.check_fn_range  # the fallback calls must not make it

    def counted_check(*a, **kw):
        range_checks.append(1)
        return checker(*a, **kw)

    dfa_engine.check_fn_range = hopper_dfa.check_fn_range = counted_check
    before, aside = launch_counters(), {}
    for name, (m, data) in fb_calls.items():
        r = m.scan(data)
        ms = wall_ms(lambda: m.scan(data), 3)
        want, _ = oracle_scan(m, [data])
        check(not r.metrics.converged, f"{name}: the fast engine does not converge")
        check(np.array_equal(r.counts, want), f"{name}: fallback counts equal the oracle")
        wall = float(np.median(ms))
        with counted(aside):  # the split's own launches are not the main path's
            split = fallback_split(m, data)
        other = wall - sum(split.values())
        print(f"router: DfaMatcher.scan {name} through the exact fallback: "
              f"{data.size / wall / 1e6:.3f} GB/s (median of 3: {wall:.2f} ms), "
              f"converged=False, counts equal the host oracle; split (CUDA events, "
              f"ms): {json.dumps({k: round(v, 4) for k, v in split.items()})}, the "
              f"rest (upload, the discarded fast scan, host work) {other:.2f}",
              flush=True)
    after = launch_counters()
    dfa_engine.check_fn_range = hopper_dfa.check_fn_range = checker
    used = {k: after[k] - before[k] - aside.get(k, 0) for k in after
            if after[k] - before[k] - aside.get(k, 0) > 0}
    print(f"router: fallback calls launched {json.dumps(used)}; the combine's "
          f"range check ran {len(range_checks)} times in them", flush=True)
    check(all(used.get(k, 0) > 0 for k in ("dfa_block_fns", "dfa_fn_combine",
                                           "dfa_chain")),
          "the fallback ran K6 pass 1, its combine and K1")
    check(used["dfa_fn_combine"] == used["dfa_block_fns"],
          "one combine a group of blocks in the fallback calls")
    check(not range_checks, "dfa_scan_blocked makes no range check (no wait)")
    # the main path's launches: the routed calls and the fallback calls, not
    # the launches that held K6 to its plain version
    launches = {k: launches[k] + used.get(k, 0) for k in launches}

    gate = phase_gate(dev, text, [(autos[k][0].tables, autos[k][1]) for k in (
        "aho-corasick", "aho-corasick 1,500 keywords")])
    fit = fit_priors([r for r in rows if not r["held_out"]], kernel_times)
    fit["PROBE_MIN_WORKLOAD"] = probe_s * fit["HOST_MULTI_BPS"]
    print(f"router: priors fitted from this run {json.dumps(fit)}", flush=True)
    if out_dir:
        with open(os.path.join(out_dir, "router.json"), "w") as f:
            json.dump({"cases": rows, "snort": snort, "session": rates,
                       "probe_s": probe_s, "gate": gate,
                       "fit": fit}, f, indent=1)
    check(launches["dfa_chain_counts"] > 0 and launches["dfa_block_fns"] > 0,
          "K2 and K6 launched on the router path")
    return launches


def fit_priors(rows, kernel_times) -> dict:
    """The router's priors as this run measures them (ops/router.py): the
    fixed costs from the 4 KiB single-stream calls; the device's copy rate
    from the 64 MiB single-stream calls less K2's time on their route, and
    from the 64 MiB batches; the host's rates from the 64 MiB calls (on all
    cores) and the 1 MiB single-stream ones (one core), the speculative
    walk's fixed cost from the 256 KiB single-stream ones; the cost of a
    histogram entry from the Snort batch."""
    from regex_fpga_tpu_torch.ops import router

    def pick(shape):
        return [r for r in rows if r["shape"] == shape]

    def med(xs):
        return float(np.median(xs))

    k2_ms = {"shared uint32": kernel_times["dfa_chain_counts"]["ms"],
             "shared uint16": kernel_times["extra_ms"][
                 "dfa_chain_counts[aho-corasick S=836]"],
             "global": kernel_times["extra_ms"][
                 "dfa_chain_counts[random S=1024, global table]"]}
    route_bps = {k: 64 * MIB / (v / 1e3) for k, v in k2_ms.items()}
    one4k = pick("1 x 4096 B")
    dev_call = med([r["device_ms"] for r in one4k]) / 1e3
    host_call = med([r["host_ms"] for r in one4k]) / 1e3
    big = pick(f"1 x {64 * MIB} B")
    copy = med([r["bytes"] / (r["device_ms"] / 1e3 - dev_call
                              - r["bytes"] / route_bps[r["route"]]) for r in big])
    batches = pick(f"4 x {16 * MIB} B") + pick(f"64 x {MIB} B")
    batch_copy = med([r["bytes"] / (r["device_ms"] / 1e3 - dev_call
                                    - r["bytes"] / route_bps[r["route"]])
                      for r in batches])
    host_single = med([r["bytes"] / (r["host_ms"] / 1e3) for r in big])
    host_multi = med([r["bytes"] / (r["host_ms"] / 1e3) for r in batches])
    host_core = med([r["bytes"] / (r["host_ms"] / 1e3 - host_call)
                     for r in pick(f"1 x {MIB} B")])
    # what the speculative walk of one stream costs beyond its bytes
    host_spec = med([r["host_ms"] / 1e3 - r["bytes"] / host_core
                     for r in pick(f"1 x {FIT_SPEC_BYTES} B")])
    # per row and per histogram entry: the Snort batch at the least and the
    # most states, less the per-byte terms
    snort = sorted(pick(f"Snort batch {rows[-1]['rows']} payloads"),
                   key=lambda r: r["S"])
    per_row = {}
    for e, per_byte, call in (
            ("device", lambda r: 1 / batch_copy + 1 / route_bps[r["route"]],
             dev_call),
            ("host", lambda r: 1 / host_core, host_call)):
        y = [(r[f"{e}_ms"] / 1e3 - call - r["bytes"] * per_byte(r)) / r["rows"]
             for r in (snort[0], snort[-1])]
        slope = (y[1] - y[0]) / (snort[-1]["S"] - snort[0]["S"])
        per_row[e] = (y[0] - slope * snort[0]["S"], slope)
    fit = {"DEVICE_CALL_S": dev_call, "DEVICE_COPY_BPS": copy,
           "DEVICE_BATCH_COPY_BPS": batch_copy, "DEVICE_ROUTE_BPS": route_bps,
           "DEVICE_ROW_S": per_row["device"][0],
           "DEVICE_ROW_STATE_S": per_row["device"][1], "HOST_CALL_S": host_call,
           "HOST_SINGLE_BPS": host_single, "HOST_MULTI_BPS": host_multi,
           "HOST_CORE_BPS": host_core, "HOST_SPEC_CALL_S": host_spec,
           "HOST_ROW_S": per_row["host"][0],
           "HOST_ROW_STATE_S": per_row["host"][1]}
    # the model's error on this run's cases, and the run-to-run spread
    err = [max(r[f"model_{e}_ms"] / r[f"{e}_ms"], r[f"{e}_ms"] / r[f"model_{e}_ms"])
           for r in rows for e in ("device", "host")]
    fit["model_error_median"], fit["model_error_max"] = med(err), max(err)
    fit["PROBE_BAND"] = [1 / float(np.percentile(err, 90)),
                         float(np.percentile(err, 90))]
    fit["DEVICE_MARGIN"] = med([r[f"{e}_spread"] for r in rows
                                for e in ("device", "host")])
    fit["committed"] = {k: getattr(router, k) for k in fit if hasattr(router, k)}
    return fit


# ------------------------------------------------------------ --profile


# ---------------------------------------------------------------- phase 8

PARALLEL_PATH = ("dfa_chain", "dfa_chain_counts", "kgram_chain_bytes",
                 "nfa_active_scan", "nfa_tp_scan", "nfa_tp_step")
CORPUS_PATTERN = r"[0-9]+\.[0-9]+"


def sync_ns(threads: int) -> float:
    """The step of a CTA of ``threads`` threads that loads one dependent
    shared-memory entry and crosses one barrier (csrc/smem_chase.cu,
    ``sync_chase``), nanoseconds: the difference of two step counts."""
    from regex_fpga_tpu_torch import _build

    lib = _build.library()
    out = torch.empty(threads, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run(steps):
        return lambda: _build.check(
            lib.sync_chase(threads, steps, out.data_ptr(), stream), "sync_chase")
    return (event_ms(run(8192), 10) - event_ms(run(4096), 10)) / 4096 * 1e6


def token_text(n: int, length: int) -> np.ndarray:
    """(n, length) streams of bench.py's synthetic text, each rolled."""
    base = tiled(FRAG, length + 64 * n)
    return np.stack([base[7 * i: 7 * i + length] for i in range(n)])


def rank_program(n: int) -> dict:
    """The dist scans on ``n`` ranks of one card (phase 8 d): the fast and
    k-gram scans on a (1, n) seq mesh over 2 x 32 MiB of tokenizer text and
    nfa_scan_tp on a (1, n) model mesh over the l7-corpus NFA, 2 x 4 KiB.
    Module level, so that spawn_ranks can run it; numpy results, and the
    kernel launches of this rank's calls."""
    from regex_fpga_tpu_torch.models import (build_tokenizer_dfa,
                                             gen_l7_traffic, l7_corpus_nfa)
    from regex_fpga_tpu_torch.ops.kgram import build_kgram, kgram_maps, pack_ta
    from regex_fpga_tpu_torch.ops.tables import build_dfa_tables, build_nfa_csr
    from regex_fpga_tpu_torch.parallel import (dfa_scan_fast_dist,
                                               dfa_scan_kgram_dist, make_mesh,
                                               make_tp_mesh, nfa_scan_tp)
    from regex_fpga_tpu_torch.parallel.mesh import collective_route
    from regex_fpga_tpu_torch.parallel.tp_scan import tp_route

    dev = torch.device("cuda")
    before = launch_counters()
    tok = build_tokenizer_dfa()
    tables = build_dfa_tables(tok.table, tok.accept, device=dev)
    text = torch.as_tensor(token_text(2, 32 * MIB), device=dev)
    classes = torch.index_select(tables.class_of.to(torch.uint8), 0,
                                 text.reshape(-1).int()).reshape(text.shape)
    mesh = make_mesh(1, n)
    out = {"route": collective_route(mesh, dev)}
    t0 = time.perf_counter()
    fin, cnt, conv = dfa_scan_fast_dist(mesh, tables, classes,
                                        blocks_per_shard=8192, start=tok.start)
    torch.cuda.synchronize()
    out["fast"] = (fin.cpu().numpy(), cnt.cpu().numpy(), conv,
                   time.perf_counter() - t0)
    kg = build_kgram(tables, levels=2)
    ta = pack_ta(torch.as_tensor(kg.table, device=dev),
                 torch.as_tensor(kg.acc_table, device=dev))
    t0 = time.perf_counter()
    fin, tot, conv = dfa_scan_kgram_dist(mesh, ta, None, text,
                                         blocks_per_shard=8192, start=tok.start,
                                         maps=kgram_maps(kg).to(dev))
    torch.cuda.synchronize()
    out["kgram"] = (fin.cpu().numpy(), tot.cpu().numpy(), conv,
                    time.perf_counter() - t0)
    l7 = np.frombuffer(b"".join(gen_l7_traffic()[0]), np.uint8)
    flows = np.stack([l7[:4096], l7[20_000:24_096]])
    tp_mesh = make_tp_mesh(n_model=n)
    out["tp_route"] = tp_route(tp_mesh)
    csr = build_nfa_csr(l7_corpus_nfa(), device=dev)
    # a short call first: the group's first collective sets up its
    # communicator, which the timed call should not pay
    nfa_scan_tp(tp_mesh, csr, flows[:, :64])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    counts, bitmap = nfa_scan_tp(tp_mesh, csr, flows)
    torch.cuda.synchronize()
    out["tp"] = (counts.cpu().numpy(), bitmap.cpu().numpy(),
                 time.perf_counter() - t0)
    out["launches"] = {k: v - before[k] for k, v in launch_counters().items()}
    return out


def check_ranks(ranks, single, label: str, t0: float) -> None:
    """Every rank of ``rank_program(n)`` equals world size 1; prints the
    times (the multi-rank nfa_scan_tp: a launch of K5's step and an
    all_reduce a byte)."""
    n = len(ranks)
    for r, got in enumerate(ranks):
        for key in ("fast", "kgram"):
            check(got[key][2] and all(np.array_equal(a, b) for a, b in
                                      zip(got[key][:2], single[key][:2])),
                  f"rank {r} {key} on a (1, {n}) seq mesh: world size 1")
        # S_pad rounds S + 1 up to the model ranks: compare the states and
        # the sentinel slot, and the padding is clear
        s1 = single["tp"][1].shape[1]
        check(np.array_equal(got["tp"][0], single["tp"][0])
              and np.array_equal(got["tp"][1][:, :s1], single["tp"][1])
              and not got["tp"][1][:, s1:].any(),
              f"rank {r} nfa_scan_tp on a (1, {n}) model mesh: world size 1")
    tp_s = ranks[0]["tp"][2]
    print(f"parallel: {label} ({ranks[0]['route']}): fast "
          f"{ranks[0]['fast'][3]:.2f} s, k-gram {ranks[0]['kgram'][3]:.2f} s "
          f"over 2 x 32 MiB on a (1, {n}) seq mesh; nfa_scan_tp on a (1, {n}) "
          f"model mesh ({ranks[0]['tp_route']}) {tp_s:.3f} s over 2 x 4 KiB "
          f"({tp_s / 4096 * 1e3:.3f} ms a byte; world size 1: "
          f"{single['tp'][2]:.3f} s, {single['tp_route']}); every result "
          f"equals world size 1 ({time.perf_counter() - t0:.1f} s with the "
          f"spawn)", flush=True)


def tp_ranks(n: int) -> None:
    """``--tp-ranks N``: ``rank_program`` on N NCCL ranks, a card each (the
    multi-rank nfa_scan_tp: K5's step and an NCCL all_reduce a byte),
    against world size 1."""
    from regex_fpga_tpu_torch.parallel.multihost import spawn_ranks

    check(torch.cuda.device_count() >= n,
          f"{n} NCCL ranks need {n} cards, {torch.cuda.device_count()} visible")
    t0 = time.perf_counter()
    single = rank_program(1)
    ranks = spawn_ranks(rank_program, n, "nccl", "cuda", args=(n,), timeout=600)
    check_ranks(ranks, single, f"{n} NCCL ranks, a card each", t0)


def tp_case(rng, aut, corpus: np.ndarray, b: int, length: int, dev):
    """b streams of ``length`` bytes of ``corpus`` and the start carries."""
    s = aut.num_states
    starts = rng.integers(0, len(corpus) - length, size=b)
    streams = torch.as_tensor(np.stack([corpus[o:o + length] for o in starts]),
                              device=dev)
    bitmap = torch.zeros((b, s + 1), dtype=torch.bool, device=dev)
    bitmap[:, 0] = True
    return streams, bitmap, torch.zeros((b, s + 1), dtype=torch.int32, device=dev)


def random_nfa(rng, n_states: int, n_edges: int, n_bytes: int,
               self_loops: bool = False):
    """A seeded random CSR NFA over the first ``n_bytes`` byte values: a
    tenth of its states accept and have no out-edges of their own; with
    ``self_loops`` every state also loops to itself on every byte, so that
    from an all-active start every state stays active."""
    from regex_fpga_tpu_torch.models import CsrAutomaton

    acc = rng.choice(np.arange(1, n_states), size=n_states // 10, replace=False)
    src = rng.choice(np.setdiff1d(np.arange(n_states), acc), size=n_edges)
    chars = rng.integers(0, n_bytes, size=n_edges)
    tgts = rng.integers(0, n_states, size=n_edges)
    if self_loops:
        src = np.concatenate([src, np.repeat(np.arange(n_states), 256)])
        chars = np.concatenate([chars, np.tile(np.arange(256), n_states)])
        tgts = np.concatenate([tgts, np.repeat(np.arange(n_states), 256)])
    order = np.argsort(src, kind="stable")
    return CsrAutomaton(
        offsets=np.searchsorted(src[order], np.arange(n_states + 1)).astype(np.int64),
        trans_char=chars[order].astype(np.uint8),
        trans_target=tgts[order].astype(np.int32))


def route_text(route: dict) -> str:
    """K5's route (hopper_nfa.nfa_tp_route) in words."""
    bitmap = ("a word a lane in registers" if route["bitmap"] == "register"
              else "in shared memory with a list of its non-zero words")
    return (f"{route['warps_per_cta']} warp(s) a CTA, a warp a stream; bitmap "
            f"{bitmap}; edges: {route['edges']}; the start state's successors: "
            f"{route['start']}; counters "
            f"{'shared' if route['counters_smem'] else 'global'}")


def k5_edges(dev, rng):
    """K5 and its step against their plain versions, tolerance 0, on random
    NFAs on both sides of the register/list boundary (S = 1,023, 1,024,
    1,025: W = 32, 32, 33 words) and one in which every state is active on
    every byte (the word list full), each over 301 streams (more than the
    132 SMs, not a multiple of the warps a CTA) of 333 bytes (not a
    multiple of 32) and over 5 streams of 0 bytes, from random start
    carries with the sentinel bit set; the step on each half of an S_pad of
    two ranks. Returns the largest difference."""
    from regex_fpga_tpu_torch.ops import hopper_nfa as hn
    from regex_fpga_tpu_torch.ops.tables import build_nfa_csr

    err = 0
    for label, aut in (
            ("S=1,023", random_nfa(rng, 1023, 4000, 8)),
            ("S=1,024", random_nfa(rng, 1024, 4000, 8)),
            ("S=1,025", random_nfa(rng, 1025, 4000, 8)),
            ("all active, S=1,100", random_nfa(rng, 1100, 3300, 4, True))):
        csr = build_nfa_csr(aut, device=dev)
        s = aut.num_states
        s_pad = -(-(s + 1) // 2) * 2
        half = s_pad // 2
        seen = []
        for b, length in ((301, 333), (5, 0)):
            route = hn.nfa_tp_route(csr, b)
            streams = torch.as_tensor(
                rng.integers(0, 8, size=(b, length)).astype(np.uint8), device=dev)
            bitmap = torch.as_tensor(rng.random((b, s + 1)) < 0.02, device=dev)
            bitmap[:, 0] = True
            bitmap[:, s] = True  # the sentinel: inert, cleared by the first byte
            if label.startswith("all active"):
                bitmap[:, :s] = True
            counts = torch.as_tensor(
                rng.integers(0, 1000, size=(b, s + 1)).astype(np.int32), device=dev)
            got = hn.nfa_tp_scan(csr, streams, bitmap, counts)
            err = max(err, max_abs_err(got, hn.nfa_tp_scan_plain(
                csr, streams, bitmap, counts)))
            for lo in (0, half):
                bm = torch.zeros((b, half), dtype=torch.bool, device=dev)
                cnt = torch.zeros((b, half), dtype=torch.int32, device=dev)
                width = min(half, s + 1 - lo)
                bm[:, :width] = bitmap[:, lo:lo + width]
                cnt[:, :width] = counts[:, lo:lo + width]
                part = (csr, streams, bm, cnt, lo, s_pad)
                err = max(err, max_abs_err(hn.nfa_tp_scan_sharded(*part),
                                           hn.nfa_tp_scan_plain(*part)))
            seen.append(f"{b} x {length} B: {route_text(route)}")
        print(f"kernels: K5 and its step, {label} NFA (C={csr.num_classes}, "
              f"E={csr.targets.shape[0]}): {'; '.join(seen)}; counts and "
              f"bitmaps bit-exact against plain (tolerance 0), the step on "
              f"each half of S_pad={s_pad}", flush=True)
    check(err == 0, f"K5 or its step differs from plain by {err} at the edges")
    return err


def phase_k5(dev, snort_aut, snort_bytes, l7_aut, l7_bytes):
    """K5 against its plain version at the check shapes (l7 4 x 16 KiB,
    Snort 4 x 2 KiB), bit for bit, and the resume carries (two chunks equal
    one run); then the edge shapes (``k5_edges``); K5's sharded step (l7 4 x
    4 KiB) against K5 and against its plain version on each half of the
    states. Returns the kernels-line entries of nfa_tp_scan and nfa_tp_step
    (times at the l7 check shapes)."""
    from regex_fpga_tpu_torch.ops import hopper_nfa as hn
    from regex_fpga_tpu_torch.ops.tables import build_nfa_csr

    rng = np.random.default_rng(SEED + 8)
    err, entry = 0, None
    for label, aut, corpus, b, length in (
            ("l7-corpus", l7_aut, l7_bytes, 4, 16 * 1024),
            ("Snort-corpus", snort_aut, snort_bytes, 4, 2 * 1024)):
        csr = build_nfa_csr(aut, device=dev)
        route = hn.nfa_tp_route(csr, b)
        streams, bitmap, counts = tp_case(rng, aut, corpus, b, length, dev)
        got = hn.nfa_tp_scan(csr, streams, bitmap, counts)
        want, plain_ms = one_run_ms(
            lambda: hn.nfa_tp_scan_plain(csr, streams, bitmap, counts))
        err = max(err, max_abs_err(got, want))
        cut = length // 2 - 123
        c1, b1 = hn.nfa_tp_scan(csr, streams[:, :cut].contiguous(), bitmap, counts)
        two = hn.nfa_tp_scan(csr, streams[:, cut:].contiguous(), b1, c1)
        err = max(err, max_abs_err(two, got))
        ms = event_ms(lambda: hn.nfa_tp_scan(csr, streams, bitmap, counts), 10)
        words = hn._pack_bits(bitmap)
        bound = bound_ms((streams, csr.offsets, csr.targets, csr.class_of,
                          csr.accept, words, counts), (got[0], words))
        print(f"kernels: K5 {label} NFA S={aut.num_states} C={csr.num_classes} "
              f"E={csr.targets.shape[0]}, {route_text(route)}; {b} streams x "
              f"{length // 1024} KiB: counts and bitmaps bit-exact against plain "
              f"(tolerance 0), "
              f"two chunks equal one run; {ms:.4f} ms, plain {plain_ms:.2f} ms, "
              f"bound {bound:.5f} ms", flush=True)
        if entry is None:
            entry = {"max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": "bytes",
                     "library_ms": LIBRARY_MS,
                     "shape": f"{label} NFA, {b} streams x {length // 1024} KiB"}
    check(err == 0, f"nfa_tp_scan differs from its plain version by {err}")
    err = max(err, k5_edges(dev, rng))
    entry["max_abs_err"] = err

    # the multi-rank route's kernel, a launch a byte: all the states of one
    # rank against K5, then each half of an S_pad of two ranks (no sum over
    # ranks) against the plain step on that half
    csr = build_nfa_csr(l7_aut, device=dev)
    s = l7_aut.num_states
    b, length = 4, 4096
    streams, bitmap, counts = tp_case(rng, l7_aut, l7_bytes, b, length, dev)
    whole = (csr, streams, bitmap, counts, 0, s + 1)
    got = hn.nfa_tp_scan_sharded(*whole)
    step_err = max_abs_err(got, hn.nfa_tp_scan(csr, streams, bitmap, counts))
    s_pad = -(-(s + 1) // 2) * 2
    half = s_pad // 2
    for lo in (0, half):
        bm = torch.zeros((b, half), dtype=torch.bool, device=dev)
        cnt = torch.zeros((b, half), dtype=torch.int32, device=dev)
        bm[:, :min(half, s + 1 - lo)] = bitmap[:, lo:lo + half]
        part = (csr, streams, bm, cnt, lo, s_pad)
        step_err = max(step_err, max_abs_err(hn.nfa_tp_scan_sharded(*part),
                                             hn.nfa_tp_scan_plain(*part)))
    want, plain_ms = one_run_ms(lambda: hn.nfa_tp_scan_plain(*whole))
    step_err = max(step_err, max_abs_err(got, want))
    ms = event_ms(lambda: hn.nfa_tp_scan_sharded(*whole), 3)
    # the (B, S_pad) uint8 successor flags leave the kernel every byte: the
    # sum over ranks reads them
    bound = bound_ms((streams, csr.offsets, csr.targets, csr.class_of,
                      csr.accept, bitmap, counts), (got[0], got[1])) \
        + length * b * (s + 1) / HBM_BYTES_PER_S * 1e3
    check(step_err == 0, f"nfa_tp_step differs from K5 or its plain version "
                         f"by {step_err}")
    print(f"kernels: K5's sharded step (nfa_tp_step, a launch a byte) l7-corpus "
          f"NFA, {b} streams x {length // 1024} KiB: bit-exact against K5 on "
          f"every state and against plain on each half of S_pad={s_pad} "
          f"(tolerance 0); {ms:.2f} ms ({ms / length * 1e3:.2f} us a byte), "
          f"plain {plain_ms:.2f} ms, bound {bound:.5f} ms", flush=True)
    step = {"max_abs_err": step_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "bytes", "library_ms": LIBRARY_MS,
            "shape": f"l7-corpus NFA, {b} streams x {length // 1024} KiB"}
    return entry, step


def phase_parallel(dev, snort_ld, snort_aut, snort_bytes, l7_aut, l7_bytes,
                   results):
    """Phase 8: parallel/ on torch.distributed and K5. Returns the launch
    counts of its main path; adds K5's entry to ``results``."""
    import torch.distributed as dist

    from regex_fpga_tpu_torch import api
    from regex_fpga_tpu_torch.models import build_tokenizer_dfa
    from regex_fpga_tpu_torch.models.csr import prefix_automaton
    from regex_fpga_tpu_torch.ops import hopper_nfa as hn
    from regex_fpga_tpu_torch.ops.dfa_fast import dfa_scan_fast_multi
    from regex_fpga_tpu_torch.ops.kgram import (build_kgram, dfa_scan_kgram,
                                                kgram_maps, pack_ta)
    from regex_fpga_tpu_torch.ops.nfa_engine import nfa_scan, nfa_scan_batch
    from regex_fpga_tpu_torch.ops.tables import build_dfa_tables, build_nfa_csr
    from regex_fpga_tpu_torch.parallel import (dfa_scan_fast_dist,
                                               dfa_scan_kgram_dist, make_mesh,
                                               make_tp_mesh, multi_ruleset_scan,
                                               nfa_scan_dist, nfa_scan_tp,
                                               stack_nfa_tables)
    from regex_fpga_tpu_torch.parallel import ingest
    from regex_fpga_tpu_torch.parallel.mesh import collective_route
    from regex_fpga_tpu_torch.parallel.multihost import spawn_ranks
    from regex_fpga_tpu_torch.parallel.tp_scan import tp_route
    from regex_fpga_tpu_torch.ops.tables import build_nfa_tables

    results["nfa_tp_scan"], results["nfa_tp_step"] = phase_k5(
        dev, snort_aut, snort_bytes, l7_aut, l7_bytes)
    work = os.path.join(ROOT, "build", "chip_smoke_parallel")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    # the launches of the main path's own calls; their references and the
    # single-device timings stay outside the counted blocks
    launches = dict.fromkeys(launch_counters(), 0)

    # (a) corpus as a user runs it: 1 GiB of synthetic text and a tail
    t0 = time.perf_counter()
    size = (1 << 30) + 12345
    data = tiled(FRAG, size)
    path = os.path.join(work, "corpus.bin")
    data.tofile(path)
    m = api.compile_regex(CORPUS_PATTERN, device=dev)
    counts, final = native_walk(m.tables, data, m.start)
    want = int(counts.sum()) + int(bool(m.include_final_match
                                        and m._accept_eof[final]))
    prep = time.perf_counter() - t0
    rc, out, err, wall = run_cli(["corpus", CORPUS_PATTERN, path, "--checkpoint",
                                  os.path.join(work, "corpus_carry.npz")])
    check(rc == 0, f"corpus exit code {rc}: {err.decode()[-2000:]}")
    res = json.loads(out.decode().strip().splitlines()[-1])
    check(res["matches"] == want and want > 0,
          f"corpus matches {res['matches']} vs the native walk's {want}")
    check(res["final_offset"] == 1 << 30 and res["bytes"] == size,
          "corpus offsets")
    print(f"parallel: corpus {CORPUS_PATTERN!r} over 1 GiB + 12,345 bytes "
          f"(mesh {res['mesh']}, k={res['kgram_k']}, chunks of "
          f"{res['chunk_bytes'] >> 20} MiB, checkpointed): {res['matches']} "
          f"matches = the native serial walk; "
          f"{res['bytes_per_sec'] / 1e9:.3f} GB/s in the process (after "
          f"start-up), {size / wall / 1e9:.3f} GB/s over the subprocess's "
          f"{wall:.2f} s wall; file and reference {prep:.1f} s", flush=True)
    del data

    # (b) ingest in process, NCCL group of one rank
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(work, "store"), 1), rank=0, world_size=1,
        device_id=torch.device("cuda", torch.cuda.current_device()))
    mesh = make_mesh(1, 1)
    tok = build_tokenizer_dfa()
    tables = build_dfa_tables(tok.table, tok.accept, device=dev)
    kg = build_kgram(tables, levels=2)
    corpus = token_text(4, 256 * MIB)
    chunk = 64 * MIB
    refs = [native_walk(tables, row, tok.start) for row in corpus]
    want_counts = np.array([int(c.sum()) for c, _ in refs])
    want_states = np.array([f for _, f in refs])
    copy_s = []
    upload_call = ingest._PinnedUpload.__call__

    def timed_upload(self, slab):  # the host copy into the pinned buffer
        t = time.perf_counter()
        item = upload_call(self, slab)
        copy_s.append(time.perf_counter() - t)
        return item

    ingest._PinnedUpload.__call__ = timed_upload
    rates = {}
    try:
        for n, (label, kgram) in enumerate((("k=1", None), ("k-gram k=4", kg))):
            def run(chunks, store=None, depth=2):
                with counted(launches):
                    return ingest.dist_resilient_scan(
                        mesh, tables, chunks, kgram=kgram,
                        blocks_per_shard=16384, start=tok.start, store=store,
                        prefetch_depth=depth)
            run(ingest.iter_batch_chunks(corpus[:, :chunk], chunk))  # warm-up
            for depth in (2, 0):
                copy_s.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                carry = run(ingest.iter_batch_chunks(corpus, chunk), depth=depth)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                rates[(label, depth)] = (corpus.size / secs / 1e9,
                                         sum(copy_s) / secs)
                check(np.array_equal(carry["counts"], want_counts)
                      and np.array_equal(carry["states"], want_states),
                      f"ingest {label} depth {depth}: the native walk")
            store = ingest.CheckpointStore(os.path.join(work, f"carry{n}.npz"))
            first = run((c for i, c in enumerate(
                ingest.iter_batch_chunks(corpus, chunk)) if i < 2), store)
            check(int(first["offset"]) == 2 * chunk, "stopped after chunk 2")
            resumed = run(ingest.iter_batch_chunks(corpus, chunk), store)
            check(np.array_equal(resumed["counts"], want_counts)
                  and np.array_equal(resumed["states"], want_states),
                  f"ingest {label}: the resumed run equals the unbroken one")
    finally:
        ingest._PinnedUpload.__call__ = upload_call
    m_tok = forced(api.compile_tokenizer(device=dev), "device")
    one = corpus[0]
    m_tok.count([one])
    ms = wall_ms(lambda: m_tok.count([one]), 3)
    count_gbs = one.size / float(np.median(ms)) / 1e6
    for (label, depth), (gbs, share) in rates.items():
        print(f"parallel: ingest {label}, 4 streams x 256 MiB in chunks of 64 "
              f"MiB a stream, prefetch depth {depth}: {gbs:.3f} GB/s "
              f"({gbs / count_gbs:.2f}x count()'s single-stream "
              f"{count_gbs:.3f} GB/s over 256 MiB), the host copy into the "
              f"pinned buffers {100 * share:.1f}% of the wall time; equal to "
              f"the native walk, and a run stopped after chunk 2 and resumed "
              f"from its checkpoint equals it", flush=True)

    # (c) the dist scans at world size 1 on NCCL, against one device
    text = torch.as_tensor(token_text(4, 64 * MIB), device=dev)
    lut = tables.class_of.to(torch.uint8)
    classes = torch.index_select(lut, 0, text.reshape(-1).int()).reshape(text.shape)
    starts = torch.full((4,), tok.start, dtype=torch.int32, device=dev)
    ta = pack_ta(torch.as_tensor(kg.table, device=dev),
                 torch.as_tensor(kg.acc_table, device=dev))
    maps = kgram_maps(kg).to(dev)
    bps = 16384
    refs = [native_walk(tables, row, tok.start) for row in text.cpu().numpy()]

    def main_path(fn):
        def call():
            with counted(launches):
                return fn()
        return call

    calls = {
        "dfa_scan_fast_dist": (
            main_path(lambda: dfa_scan_fast_dist(mesh, tables, classes, bps,
                                                 tok.start)),
            lambda: dfa_scan_fast_multi(tables, classes, bps, starts)),
        "dfa_scan_kgram_dist": (
            main_path(lambda: dfa_scan_kgram_dist(mesh, ta, None, text, bps,
                                                  tok.start, maps=maps)),
            lambda: [dfa_scan_kgram(ta, row, bps, tok.start, maps=maps)
                     for row in text]),
    }
    for name, (dist_fn, single_fn) in calls.items():
        fin, cnt, conv = dist_fn()
        single = single_fn()
        if name == "dfa_scan_fast_dist":
            s_fin = single.final_states.cpu().numpy()
            s_cnt = single.counts.sum(1).cpu().numpy()
        else:
            s_fin = np.array([int(r.final_state) for r in single])
            s_cnt = np.array([int(r.total) for r in single])
        check(conv and np.array_equal(fin.cpu().numpy(), s_fin)
              and np.array_equal(cnt.cpu().numpy(), s_cnt)
              and np.array_equal(s_cnt, [int(c.sum()) for c, _ in refs])
              and np.array_equal(s_fin, [f for _, f in refs]),
              f"{name}: one device and the native walk")
        d_ms = float(np.median(wall_ms(dist_fn, 5)))
        s_ms = float(np.median(wall_ms(single_fn, 5)))
        print(f"parallel: {name} 4 x 64 MiB on a 1x1 mesh "
              f"({collective_route(mesh, dev)}; backend {mesh.backend}): "
              f"{text.numel() / d_ms / 1e6:.3f} GB/s, one device "
              f"{text.numel() / s_ms / 1e6:.3f} GB/s, fraction "
              f"{s_ms / d_ms:.3f}; equal to one device and the native walk",
              flush=True)

    # (e) the NFA scans
    csr = build_nfa_csr(l7_aut, device=dev)
    flows = np.stack([l7_bytes[o:o + MIB] for o in
                      np.random.default_rng(SEED + 9).integers(0, 63 * MIB, 64)])
    t0 = time.perf_counter()
    with counted(launches):
        per, totals = nfa_scan_dist(mesh, csr, flows)
        torch.cuda.synchronize()
    nd_s = time.perf_counter() - t0
    check(torch.equal(totals, per.sum(0, dtype=torch.int32)), "totals = column sums")
    ref_l7, _ = api.compile_ruleset(l7_aut, api.EngineConfig(), "lazy", dev) \
        .lazy_dfa.host_scan_batch(list(flows))
    check(np.array_equal(per.cpu().numpy(), ref_l7),
          "nfa_scan_dist: the lazy host walk")
    print(f"parallel: nfa_scan_dist l7-corpus NFA 64 x 1 MiB: {nd_s * 1e3:.1f} ms, "
          f"totals the column sums, counts equal the lazy host walk", flush=True)
    subsets = [l7_aut] + [prefix_automaton(l7_aut, k) for k in (200, 400, 600)]
    one_flow = flows[0]
    stacked = stack_nfa_tables([build_nfa_tables(a, device=dev) for a in subsets])
    t0 = time.perf_counter()
    with counted(launches):
        multi = multi_ruleset_scan(mesh, stacked, one_flow)
        torch.cuda.synchronize()
    mr_s = time.perf_counter() - t0
    for i, a in enumerate(subsets):
        own = nfa_scan(build_nfa_csr(a, device=dev), one_flow)
        check(not bool(own.overflowed)
              and torch.equal(multi[i, :a.num_states], own.counts),
              f"multi_ruleset_scan ruleset {i}: its own K4 run")
    print(f"parallel: multi_ruleset_scan {len(subsets)} rulesets (l7 and its "
          f"prefixes of 200, 400, 600 states) over 1 MiB: {mr_s * 1e3:.1f} ms, "
          f"each equal to its own K4 run", flush=True)
    tp_mesh = make_tp_mesh(1, 1)
    l7_main = torch.as_tensor(flows, device=dev)
    t0 = time.perf_counter()
    with counted(launches):
        tp_counts, _ = nfa_scan_tp(tp_mesh, csr, l7_main)
        torch.cuda.synchronize()
    tp_l7_s = time.perf_counter() - t0
    check(np.array_equal(tp_counts.cpu().numpy(), ref_l7), "K5 l7: the lazy walk")
    k4 = nfa_scan_batch(csr, l7_main, 128)
    check(not bool(k4.overflowed.any()) and torch.equal(tp_counts, k4.counts),
          "K5 l7 64 x 1 MiB: K4's counts at bound 128")
    s_csr = build_nfa_csr(snort_aut, device=dev)
    s_flows = tiled(snort_bytes, 132 * 64 * 1024).reshape(132, 64 * 1024)
    t0 = time.perf_counter()
    with counted(launches):
        s_counts, _ = nfa_scan_tp(tp_mesh, s_csr, s_flows)
        torch.cuda.synchronize()
    tp_s_s = time.perf_counter() - t0
    s_ref = np.stack([snort_ld.host_scan(f)[0] for f in s_flows])
    check(np.array_equal(s_counts.cpu().numpy(), s_ref),
          "K5 Snort 132 x 64 KiB: the native lazy walk")
    print(f"parallel: nfa_scan_tp "
          f"({tp_route(tp_mesh)}): l7 64 x 1 MiB {tp_l7_s * 1e3:.1f} ms (= K4 at "
          f"bound 128 and the lazy walk), Snort 132 x 64 KiB {tp_s_s * 1e3:.1f} "
          f"ms (= the native lazy walk)", flush=True)

    # K5 alone at the main path's shapes, beside its bound, its floor and the
    # first design's time (one CTA a stream, timed on an NVIDIA H100 80GB
    # HBM3 at 700 W)
    main = {}
    step = sync_ns(32)  # a dependent shared load and the barrier of one warp
    for label, c, streams, first_ms in (
            ("l7-corpus NFA, 64 flows x 1 MiB", csr, l7_main, 362.59),
            ("Snort-corpus NFA, 132 flows x 64 KiB", s_csr,
             torch.as_tensor(s_flows, device=dev), 53.58)):
        b, length = streams.shape
        route = hn.nfa_tp_route(c, b)
        bm = torch.zeros((b, c.num_states + 1), dtype=torch.bool, device=dev)
        bm[:, 0] = True
        cnt = torch.zeros(bm.shape, dtype=torch.int32, device=dev)
        ms = event_ms(lambda: hn.nfa_tp_scan(c, streams, bm, cnt), 2)
        words = hn._pack_bits(bm)
        bound = bound_ms((streams, c.offsets, c.targets, c.class_of, c.accept,
                          words, cnt), (cnt, words))
        floor = length * step / 1e6
        main[label] = {"ms": ms, "bound_ms": bound, "floor_ms": floor,
                       "step_ns": step, **route}
        print(f"time: nfa_tp_scan[{label}; {route_text(route)}] {ms:.2f} ms "
              f"(the first design, one CTA a stream: {first_ms} ms on an H100 "
              f"80GB HBM3 at 700 W), "
              f"bound {bound:.4f} ms, floor {floor:.2f} ms ({length:,} bytes x "
              f"{step:.2f} ns, a dependent shared load and the barrier of one "
              f"warp)", flush=True)
    k4_ms = results["nfa_active_scan"]["main_path"]["ms"]
    l7_k5 = main["l7-corpus NFA, 64 flows x 1 MiB"]["ms"]
    print(f"time: l7-corpus NFA 64 x 1 MiB: K5 {l7_k5:.2f} ms against K4 "
          f"{k4_ms:.2f} ms at bound 128 ({l7_k5 / k4_ms:.2f}x)", flush=True)
    results["nfa_tp_scan"]["main_path"] = main
    dist.destroy_process_group()

    # (d) two ranks on the one card over gloo, against world size 1
    t0 = time.perf_counter()
    single = rank_program(1)
    both = spawn_ranks(rank_program, 2, "gloo", "cuda", args=(2,), timeout=600)
    for got in both:
        for k, v in got["launches"].items():
            launches[k] += v
    check_ranks(both, single, "2 ranks on one card over gloo", t0)
    shutil.rmtree(work, ignore_errors=True)
    print(f"parallel: launches of the main path's own calls (both ranks of "
          f"(d) summed) {json.dumps(launches)}", flush=True)
    for name in PARALLEL_PATH:
        check(launches[name] > 0, f"{name} launched on the parallel path")
    return launches


def phase_profile(dev, calls, out_dir):
    """One torch.profiler run of each API call after a warm-up: device time
    in copies (memcpy/memset) and in kernels, and the share of the call's
    wall time in which the device did neither. Also the host-to-device copy
    of 64 MiB from pageable and from pinned memory."""
    from torch.profiler import ProfilerActivity, profile

    host = np.random.default_rng(SEED + 2).integers(0, 256, size=64 * MIB,
                                                     dtype=np.uint8)
    pinned = torch.from_numpy(host.copy()).pin_memory()
    copies = {
        "h2d pageable 64 MiB": lambda: torch.from_numpy(host).to(dev),
        "h2d pinned 64 MiB": lambda: pinned.to(dev, non_blocking=True),
    }
    rows = []
    for label, fn in copies.items():
        fn()
        ms = wall_ms(fn, REPEATS)
        rows.append({"copy": label, "median_ms": float(np.median(ms)),
                     "min_ms": min(ms), "max_ms": max(ms)})
        print(f"profile: {json.dumps(rows[-1])}", flush=True)
    for label, fn, nbytes in calls:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        copy_ms = kernel_ms = 0.0
        top = {}
        for e in prof.key_averages():
            if e.device_type.name != "CUDA":
                continue
            ms = e.self_device_time_total / 1e3
            if e.key.startswith(("Memcpy", "Memset")):
                copy_ms += ms
            else:
                kernel_ms += ms
                top[e.key[:60]] = top.get(e.key[:60], 0.0) + ms
        rows.append({
            "call": label, "wall_ms": wall, "copy_ms": copy_ms,
            "kernel_ms": kernel_ms,
            "idle_share": 1 - (copy_ms + kernel_ms) / wall,
            "top_kernels_ms": dict(sorted(top.items(), key=lambda kv: -kv[1])[:4]),
        })
        check(kernel_ms > 0, f"{label}: the profile shows device kernels")
        print(f"profile: {json.dumps(rows[-1])}", flush=True)
    if out_dir:
        with open(os.path.join(out_dir, "profile.json"), "w") as f:
            json.dump(rows, f, indent=1)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="directory for nvcc's report and results")
    parser.add_argument("--profile", action="store_true",
                        help="also profile each API call (device copy, kernel "
                             "and idle time)")
    parser.add_argument("--tp-ranks", type=int, metavar="N",
                        help="only the multi-rank scans on N NCCL ranks, a card "
                             "each, against world size 1 (needs N cards)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible to torch", file=sys.stderr)
        return 1
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    sys.path.insert(0, ROOT)
    dev = torch.device("cuda")

    t_start = time.perf_counter()

    def done(phase: str) -> None:
        print(f"chip_smoke: {phase} done at {time.perf_counter() - t_start:.1f} s",
              flush=True)

    phase_device(args.out)
    done("phase 1 (device, builds)")
    if args.tp_ranks:
        tp_ranks(args.tp_ranks)
        return 0

    from regex_fpga_tpu_torch.models import (LazyDfa, build_aho_corasick,
                                             build_tokenizer_dfa, gen_l7_traffic,
                                             gen_traffic, l7_corpus_nfa,
                                             snort_corpus_nfa)
    from regex_fpga_tpu_torch.ops.tables import build_dfa_tables

    tok = build_tokenizer_dfa()
    tok_tables = build_dfa_tables(tok.table, tok.accept, device=dev)
    ac = build_aho_corasick(WORDS[:300]).dfa
    ac_tables = build_dfa_tables(ac.table, ac.accept, device=dev)
    kernel_times = phase_kernels(dev, tok_tables, int(tok.start), ac_tables)
    done("phase 2 (kernels)")

    t0 = time.perf_counter()
    snort_aut, l7_aut = snort_corpus_nfa(), l7_corpus_nfa()
    snort_bytes = tiled(b"".join(gen_traffic()[0]), 64 * MIB)
    l7_bytes = tiled(b"".join(gen_l7_traffic()[0]), 64 * MIB)
    snort_ld = LazyDfa(snort_aut)
    snort_ld.host_scan(snort_bytes[:4 * MIB])
    print(f"nfa: Snort-corpus NFA S={snort_aut.num_states}, l7-corpus NFA "
          f"S={l7_aut.num_states}, Snort lazy DFA warmed to "
          f"{snort_ld.num_states} subset states "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    kernel_times["nfa_active_scan"] = phase_nfa_kernels(
        dev, snort_ld, snort_aut, snort_bytes, l7_aut, l7_bytes, kernel_times)

    done("phase 2 (NFA kernels)")
    surface_launches = phase_surface(dev, ac_tables, l7_aut, l7_bytes)
    done("phase 2 (package surface)")
    dfa_launches, calls, ac_text = phase_main_path(dev)
    done("phase 3 (DFA main path)")
    nfa_launches, nfa_calls = phase_nfa_path(dev, snort_aut, snort_bytes,
                                             l7_aut, l7_bytes)
    done("phase 4 (NFA main path)")
    span_launches, span_calls = phase_spans(dev, snort_bytes, l7_bytes, ac_text)
    done("phase 5 (spans)")
    ids_launches, ids_calls, ids, payloads, snort_auto = phase_ids(
        dev, snort_bytes, l7_bytes, kernel_times)
    done("phase 6 (IDS front door)")
    router_launches = phase_router(dev, ids, payloads, snort_auto, ac_text,
                                   snort_bytes, kernel_times, args.out)
    done("phase 7 (router, exact fallback)")
    parallel_launches = phase_parallel(dev, snort_ld, snort_aut, snort_bytes,
                                       l7_aut, l7_bytes, kernel_times)
    done("phase 8 (parallel, K5)")
    launches = {k: surface_launches[k] + dfa_launches[k] + nfa_launches[k]
                + span_launches[k] + ids_launches[k] + router_launches[k]
                + parallel_launches[k] for k in KERNELS}
    if args.profile:
        phase_profile(dev, calls + nfa_calls + span_calls + ids_calls, args.out)

    for name in KERNELS:
        check(launches[name] > 0, f"{name} launched on the main path")
    line = {"kernels": [
        {"name": name, "route": route, "source": source, "replaces": replaces,
         "launches": launches[name], **kernel_times[name]}
        for name, (route, source, replaces) in KERNELS.items()
    ]}
    print(json.dumps(line), flush=True)
    if args.out:
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(line, f, indent=1)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
