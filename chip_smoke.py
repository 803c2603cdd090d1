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
   and per-stream) and K3 (kgram_chain) against their plain PyTorch
   versions on the card at the main path's shapes, bit for bit, with the
   time, the bound and the route (table placement and narrowing, lanes per
   CTA) of each; then K1/K2 on a lazy-DFA snapshot of the Snort-corpus NFA
   (the narrowed shared table) and K4 (nfa_active_scan) on both of its
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
5. the kernels JSON line, then {"ok": true, "device": ...} as the last line.

``--out DIR`` also writes nvcc's report and the results there.
``--profile`` adds, after phase 4, one torch.profiler run of each API call
that uses the card (device time in copies and in kernels, and the idle share
of the call's wall time) and the host-to-device copy of 64 MiB from pageable
and from pinned memory. The script imports torch, numpy and the port, and nothing
of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

MIB = 1 << 20
SEED = 20261016
REPEATS = 5  # timed runs per API call in phases 3 and 4; the median is reported

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
    "nfa_active_scan": ("cuda", "regex_fpga_tpu_torch/csrc/nfa_active.cu",
                        "regex_fpga_tpu/ops/nfa_engine.py:43"),
}
# no single PyTorch call computes a chain pass or an active-set step, so
# there is no library call to time beside the kernels
LIBRARY_MS = None
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate (NVIDIA data sheet)
DFA_PATH = ("dfa_chain", "dfa_chain_counts", "kgram_chain")
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


def phase_kernels(dev, tok_tables, ac_tables):
    """Each kernel against its plain version on the card. Returns per-kernel
    {"max_abs_err", "ms", "plain_ms"} at the main path's shapes."""
    from regex_fpga_tpu_torch.ops import hopper_dfa as hd
    from regex_fpga_tpu_torch.ops import hopper_kgram as hk
    from regex_fpga_tpu_torch.ops.kgram import build_kgram, pack_ta
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
    for name, t, b, dtype, block_major in cases:
        c, s = t.table.shape
        shape = (nb, b) if block_major else (b, nb)
        cls = torch.as_tensor(rng.integers(0, c, size=shape, dtype=np.int64),
                              device=dev).to(dtype)
        cls_seq = cls.T if block_major else cls
        ent = torch.as_tensor(rng.integers(0, s, size=nb).astype(np.int32),
                              device=dev)
        route = hd.dfa_chain_route("counts", c, s, nb, 64, dtype)
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
              f"{route['table']}, histogram "
              f"{'shared' if route['hist_smem'] else 'global'}, "
              f"{route['lanes_per_cta']} lanes per CTA: K1 x3 modes, K2 single "
              f"and 64 streams bit-exact against plain (tolerance 0)", flush=True)

    # K3 at the tokenizer's level-2 k-gram shape: 64 MiB of text = 2^24 steps
    kg = build_kgram(tok_tables, levels=2)
    kg_ta = pack_ta(torch.as_tensor(kg.table), torch.as_tensor(kg.acc_table)).to(dev)
    ck = torch.as_tensor(rng.integers(0, kg.table.shape[0], size=(nb, 256))
                         .astype(np.int32), device=dev)
    ent = torch.as_tensor(rng.integers(0, kg.num_states, size=nb)
                          .astype(np.int32), device=dev)
    errs["kgram_chain"] = max_abs_err(hk.kgram_chain(kg_ta, ck.T, ent),
                                      hk.kgram_chain_plain(kg_ta, ck.T, ent))
    ac_c, ac_s = ac_tables.table.shape
    big_cls = torch.as_tensor(rng.integers(0, ac_c, size=(4096, 256))
                              .astype(np.int16), device=dev)
    big_acc = torch.as_tensor(rng.integers(0, 5, size=(ac_c, ac_s))
                              .astype(np.int32), device=dev)
    big_ta = pack_ta(ac_tables.table, big_acc)
    ent_ac = torch.zeros(4096, dtype=torch.int32, device=dev)
    errs["kgram_chain"] = max(errs["kgram_chain"], max_abs_err(
        hk.kgram_chain(big_ta, big_cls.T, ent_ac),
        hk.kgram_chain_plain(big_ta, big_cls.T, ent_ac)))
    torch.cuda.synchronize()
    print(f"kernels: K3 tokenizer k=4 C_k={kg.table.shape[0]} S={kg.num_states} "
          f"{nb}x256 int32 and AC-sized S={ac_s} (table in "
          f"{'shared' if hk.kgram_chain_route(ac_c, ac_s)['table_smem'] else 'global'}"
          f" memory) int16 bit-exact against plain (tolerance 0)", flush=True)
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
    }
    plain = {
        "dfa_chain": lambda: hd.dfa_chain_plain(tt, ta, cls, ent, "finals"),
        "dfa_chain_counts": lambda: hd.dfa_chain_counts_plain(tt, ta, cls, ent),
        "kgram_chain": lambda: hk.kgram_chain_plain(kg_ta, ck.T, ent),
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
        "kgram_chain": bound_ms((ck, kg_ta, ent), (fin, fin)),
    }
    results = {}
    for name in DFA_PATH:
        ms = event_ms(timing[name], 20)
        plain_ms = event_ms(plain[name], 2)
        results[name] = {"max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bounds[name], "bound_by": "bytes",
                         "library_ms": LIBRARY_MS,
                         "shape": "tokenizer (S=23), 65,536 lanes x "
                                  + ("256 k-gram steps" if name == "kgram_chain"
                                     else "1,024 steps")}
        print(f"time: {name} {ms:.4f} ms, plain {plain_ms:.2f} ms, bound "
              f"{bounds[name]:.4f} ms ({64 * MIB / ms / 1e6:.1f} GB/s of text)",
              flush=True)
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
          f"{croute['table']}, histogram "
          f"{'shared' if croute['hist_smem'] else 'global'}), "
          f"{route['lanes_per_cta']} lanes per CTA, {nb}x{b} uint8 "
          f"block-major: K1 x3 modes and K2 bit-exact against plain "
          f"(tolerance 0)", flush=True)
    for name, (fn, plain, bound) in lazy_times.items():
        ms = event_ms(fn, 20)
        _, plain_ms = one_run_ms(plain)
        results[name]["lazy"] = {"shape": f"lazy table ({c}, {m1}), {nb} lanes "
                                          f"x {b} steps",
                                 "ms": ms, "plain_ms": plain_ms, "bound_ms": bound}
        print(f"time: {name}[lazy table ({c}, {m1}), {nb}x{b}] {ms:.4f} ms, "
              f"plain {plain_ms:.2f} ms, bound {bound:.5f} ms "
              f"({nb * b / ms / 1e6:.2f} GB/s of text)", flush=True)
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
    """The port's API at full size. Returns the kernel launch counts and
    the calls, as (label, zero-argument function, bytes) for the profile."""
    from regex_fpga_tpu_torch import api
    from regex_fpga_tpu_torch.models import CompiledDfa, build_aho_corasick

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
        ("tokenizer count (k-gram) 64 MiB", "tok", "count", (text,), text.size),
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
                      for label, who, method, args, nbytes in calls]


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
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
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
    kernel_times = phase_kernels(dev, tok_tables, ac_tables)

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

    dfa_launches, calls = phase_main_path(dev)
    nfa_launches, nfa_calls = phase_nfa_path(dev, snort_aut, snort_bytes,
                                             l7_aut, l7_bytes)
    launches = {k: dfa_launches[k] + nfa_launches[k] for k in KERNELS}
    if args.profile:
        phase_profile(dev, calls + nfa_calls, args.out)

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
