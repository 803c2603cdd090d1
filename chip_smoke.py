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
   alone on the main path's 64 flows of 1 MiB;
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
7. the kernels JSON line, then {"ok": true, "device": ...} as the last line.

``--out DIR`` also writes nvcc's report and the results there.
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
    for name, fn in extra.items():
        ms = event_ms(fn, 20)
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
    for name, fn in (("dfa_chain", hd.dfa_chain), ("dfa_chain_counts", hd.dfa_chain_counts)):
        ms = event_ms(lambda: fn(wide_t, wide_a, cls, ent), 20)
        results[name]["lazy_global"] = {
            "shape": f"lazy table padded to ({c}, 2049), global memory, {nb} lanes x {b} steps",
            "ms": ms}
        print(f"time: {name}[lazy table padded to ({c}, 2049), global memory, {nb}x{b}] "
              f"{ms:.4f} ms, bit-exact against plain", flush=True)
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
    for name, m, data in (("exact", ids._exact, streams),
                          ("case-folded", ids._fold, lows)):
        with recorded_k2() as calls:
            m.scan_patterns(data)
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
    return launches, device_calls


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


# ------------------------------------------------------------ --profile


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
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible to torch", file=sys.stderr)
        return 1
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    sys.path.insert(0, ROOT)
    dev = torch.device("cuda")

    phase_device(args.out)

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

    dfa_launches, calls, ac_text = phase_main_path(dev)
    nfa_launches, nfa_calls = phase_nfa_path(dev, snort_aut, snort_bytes,
                                             l7_aut, l7_bytes)
    span_launches, span_calls = phase_spans(dev, snort_bytes, l7_bytes, ac_text)
    ids_launches, ids_calls = phase_ids(dev, snort_bytes, l7_bytes, kernel_times)
    launches = {k: dfa_launches[k] + nfa_launches[k] + span_launches[k]
                + ids_launches[k] for k in KERNELS}
    if args.profile:
        phase_profile(dev, calls + nfa_calls + span_calls + ids_calls, args.out)

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
