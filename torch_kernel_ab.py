#!/usr/bin/env python3
"""Time the Hopper kernels of two or more checkouts of the torch port on one
CUDA card, in turns, at the main path's shapes.

    python3 torch_kernel_ab.py TREE_A TREE_B [--rounds 2] [--out FILE]
                               [--cases k1,k2]

Each TREE is the root of a checkout that holds ``regex_fpga_tpu_torch/``.
The inputs are made once, from a seed, by the port of the tree this script
lives in, and saved under its ``build/``; each tree then builds its own
kernels (into its own ``build/``) and is timed in a fresh process. A round
runs the trees in order and then in reverse (A, B, B, A), so that a drift of
the card's clock over the call does not favour one side. Each run prints one
JSON line; the script ends with the median of every case per tree, the
card's name and power limit, and exits non-zero when a run failed. A case
that a tree's port does not have is reported as null for that tree.
``--cases`` keeps the cases whose name holds one of the given words.

    python3 torch_kernel_ab.py --lazy-passes 16

needs no card: it runs ``lazy_nfa_scan`` over that many MiB of the Snort
traffic twice on the CPU (the plain versions) and prints, for the cold and
the warmed call, every chain pass it launches: kernel, mode, (steps, lanes)
and the table's shape, which say what the lazy path's main shape is.

Cases (CUDA events; each the mean of REPS launches after one warm-up):
  K1 dfa_chain and K2 dfa_chain_counts on the GPT-2 tokenizer DFA (S=23),
  65,536 lanes x 1,024 steps of seeded class ids, K2 also with 64 streams
  and on the class ids of real text from the tokenizer's start state (random
  ids change the hit rate: a quarter of real text's steps count); K2 on
  a 300-keyword Aho-Corasick DFA (S=836); K1 and K2 on the Snort-corpus
  lazy-DFA snapshot (83, 1025) at the lazy-device path's 1,024 lanes x 4,096
  steps of its traffic, on the same 4 MiB cut into 4,096 and 16,384
  lanes, and, to part a launch's fixed cost from its cost per step, K1 on
  the first 32, 1,024 and 2,048 steps of the 1,024 lanes and on lanes that
  all read one table entry (no bank conflicts), and K1 and K2 on that
  snapshot padded to 2,049 columns, as the lazy path pads it once the lazy
  DFA outgrows 1,024 states (the table then stays in global memory); K3 kgram_chain on the tokenizer's k=4 tables, 65,536 lanes x 256
  steps, from class ids, from raw text with the class mapping counted in
  (kgram_chain_bytes; a tree without it maps with tensor passes and calls
  kgram_chain), and kgram_chain_bytes alone; K4 nfa_active_scan on the
  l7-corpus NFA over 4 streams of 16 KiB and over the main path's 64 flows
  of 1 MiB (bound 128); K5 nfa_tp_scan at the main path's shapes, the
  l7-corpus NFA over the same 64 flows of 1 MiB and the Snort-corpus NFA
  over 132 flows of 64 KiB of its traffic, from the start state; K5's
  sharded step (nfa_tp_scan_sharded, a launch a byte, all states on one
  rank) on the l7-corpus NFA over 4 flows of 4 KiB; K6 pass 1
  (dfa_block_fns) over 65,536 blocks x 1,024 on the 300-keyword
  Aho-Corasick DFA (36, 836) and the class ids of random bytes, on a parity
  automaton (2, 2) over random bytes, on the reversed (aa)*b DFA (3, 4) over
  runs of a's and b's, and on a seeded permutation automaton (36, 836)
  whose chains never meet, over random class ids; K6's combine
  (dfa_engine.block_entry_states, from state 1, in the groups that
  dfa_scan_blocked makes: a tree without the combine kernel runs its
  doubling) over the Aho-Corasick and the parity block functions (S = 836
  and 2) of the same blocks; and the latency of a
  dependent shared-memory load
  (smem_chase, one warp: the difference of 8,192 and 4,096 steps), which is
  the floor under a chain step.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

MIB = 1 << 20
SEED = 20261016
ROOT = os.path.dirname(os.path.abspath(__file__))
REPS = {"k4 l7 64x1MiB": 3, "k5 l7 64x1MiB": 3, "k5 snort 132x64KiB": 5,
        "k5 step l7 4x4KiB": 5, "k6 combine S=836 65536 blocks": 5,
        "k6 combine S=2 65536 blocks": 5}  # every other case: 20
FRAG = (b"The quick brown fox jumps over 1234 lazy dogs, it's 99.5% fine!  "
        b"pre-split   benchmark text \xc3\xa9t\xc3\xa9 2026... ")
WORDS = [w % i for i in range(300)
         for w in (b"error%04d", b"warning%03d", b"GET /path%d HTTP",
                   b"user-agent: bot%d", b"fail%dure")]


def make_inputs(path: str) -> None:
    """Seeded inputs for every case, from this tree's port."""
    sys.path.insert(0, ROOT)
    from regex_fpga_tpu_torch.models import (LazyDfa, build_aho_corasick,
                                             build_tokenizer_dfa,
                                             compile_pattern, gen_l7_traffic,
                                             gen_traffic, l7_corpus_nfa,
                                             snort_corpus_nfa)
    from regex_fpga_tpu_torch.ops.kgram import build_kgram
    from regex_fpga_tpu_torch.ops.lazy_scan import _pad_for
    from regex_fpga_tpu_torch.ops.tables import build_dfa_tables, build_nfa_csr

    rng = np.random.default_rng(SEED)
    tok_dfa = build_tokenizer_dfa()
    tok = build_dfa_tables(tok_dfa.table, tok_dfa.accept)
    snort = np.resize(np.frombuffer(b"".join(gen_traffic()[0]), np.uint8), 4 * MIB)
    ld = LazyDfa(snort_corpus_nfa())
    ld.host_scan(snort)
    lazy_table, unknown, n_acc = ld.snapshot(pad_to=_pad_for(ld))
    lazy_accept = n_acc > 0
    lazy_accept[unknown] = True
    csr = build_nfa_csr(l7_corpus_nfa())
    snort_csr = build_nfa_csr(snort_corpus_nfa())
    ac_dfa = build_aho_corasick(WORDS[:300]).dfa
    ac = build_dfa_tables(ac_dfa.table, ac_dfa.accept)
    kg = build_kgram(tok, levels=2)
    text = np.resize(np.frombuffer(FRAG, np.uint8), 64 * MIB)
    noise = rng.integers(0, 256, size=64 * MIB, dtype=np.uint8)
    rev_dfa = compile_pattern(r"(aa)*b", anchored=False, reverse=True)
    rev = build_dfa_tables(rev_dfa.table, rev_dfa.accept)
    ab = np.where(rng.random(64 * MIB) < 0.9999, ord("a"), ord("b")).astype(np.uint8)
    np.savez(
        path,
        tok_table=tok.table.numpy(), tok_accept=tok.accept.numpy(),
        tok_start=np.int32(tok_dfa.start),
        tok_cls=rng.integers(0, tok.table.shape[0], size=(65536, 1024), dtype=np.uint8),
        tok_text=text,
        tok_text_cls=tok.class_of.numpy()[text].astype(np.uint8).reshape(65536, 1024),
        ac_table=ac.table.numpy(), ac_accept=ac.accept.numpy(),
        ac_cls=rng.integers(0, ac.table.shape[0], size=(65536, 1024), dtype=np.uint8),
        kg_table=kg.table, kg_acc=kg.acc_table,
        kg_cls=rng.integers(0, kg.table.shape[0], size=(65536, 256)).astype(np.int32),
        lazy_table=lazy_table, lazy_accept=lazy_accept,
        lazy_cls=ld.class_of[snort].astype(np.uint8).reshape(1024, 4096),
        lazy_entries=rng.integers(0, lazy_table.shape[1], size=1024).astype(np.int32),
        l7_offsets=csr.offsets.numpy(), l7_targets=csr.targets.numpy(),
        l7_class_of=csr.class_of.numpy(), l7_accept=csr.accept.numpy(),
        l7_bytes=np.resize(np.frombuffer(b"".join(gen_l7_traffic()[0]), np.uint8),
                           64 * MIB),
        l7_small_starts=rng.integers(0, 63 * 16 * 1024, size=4),
        l7_big_starts=rng.integers(0, 63 * MIB, size=64),
        snort_offsets=snort_csr.offsets.numpy(), snort_targets=snort_csr.targets.numpy(),
        snort_class_of=snort_csr.class_of.numpy(), snort_accept=snort_csr.accept.numpy(),
        snort_flows=np.resize(snort, 132 * 64 * 1024).reshape(132, 64 * 1024),
        k6_ac_cls=ac.class_of.numpy()[noise].astype(np.uint8).reshape(65536, 1024),
        k6_parity_table=np.array([[1, 0], [0, 1]], dtype=np.int32),
        k6_parity_cls=(noise >= 128).astype(np.uint8).reshape(65536, 1024),
        k6_rev_table=rev.table.numpy(),
        k6_rev_cls=rev.class_of.numpy()[ab].astype(np.uint8).reshape(65536, 1024),
        k6_perm_table=np.stack([rng.permutation(ac.table.shape[1])
                                for _ in range(ac.table.shape[0])]).astype(np.int32),
        k6_perm_cls=rng.integers(0, ac.table.shape[0], size=(65536, 1024),
                                 dtype=np.uint8),
    )


def time_tree(tree: str, inputs: str, only: list[str]) -> dict:
    """Every case's mean device milliseconds with the kernels of ``tree``."""
    sys.path.insert(0, tree)
    import torch

    from regex_fpga_tpu_torch import _build
    from regex_fpga_tpu_torch.models import build_tokenizer_dfa
    from regex_fpga_tpu_torch.ops import hopper_dfa as hd
    from regex_fpga_tpu_torch.ops import hopper_kgram as hk
    from regex_fpga_tpu_torch.ops import hopper_nfa as hn
    from regex_fpga_tpu_torch.ops import kgram as kgram_ops
    from regex_fpga_tpu_torch.ops.dfa_engine import (FN_GROUP_BYTES,
                                                     block_entry_states)
    from regex_fpga_tpu_torch.ops.tables import NfaCsr, build_dfa_tables

    if not os.path.abspath(_build.__file__).startswith(os.path.abspath(tree) + os.sep):
        raise RuntimeError(f"{_build.__file__} is not the package of {tree}")
    dev = torch.device("cuda")
    z = np.load(inputs)
    t = {k: torch.as_tensor(z[k], device=dev) for k in z.files}
    csr = NfaCsr(offsets=t["l7_offsets"], targets=t["l7_targets"],
                 class_of=t["l7_class_of"], accept=t["l7_accept"],
                 num_states=int(z["l7_accept"].shape[0]) - 1)
    s = csr.num_states
    tok_cls, lazy_cls = t["tok_cls"].T, t["lazy_cls"].T  # (steps, lanes) views
    tok_ent = torch.zeros(65536, dtype=torch.int32, device=dev)
    tok_start = torch.full_like(tok_ent, int(z["tok_start"]))

    snort_csr = NfaCsr(offsets=t["snort_offsets"], targets=t["snort_targets"],
                       class_of=t["snort_class_of"], accept=t["snort_accept"],
                       num_states=int(z["snort_accept"].shape[0]) - 1)

    def k5(c, streams, step=False):
        """K5 (or, with ``step``, its sharded step on one rank holding every
        state) over ``streams`` from the start state."""
        n = c.num_states + 1
        bm = torch.zeros((streams.shape[0], n), dtype=torch.bool, device=dev)
        bm[:, 0] = True
        cnt = torch.zeros(bm.shape, dtype=torch.int32, device=dev)
        if step:
            return lambda: hn.nfa_tp_scan_sharded(c, streams, bm, cnt, 0, n)
        return lambda: hn.nfa_tp_scan(c, streams, bm, cnt)

    l7_flows = torch.stack([t["l7_bytes"][o:o + MIB] for o in z["l7_big_starts"]])
    l7_step = torch.stack([t["l7_bytes"][o:o + 4096] for o in z["l7_big_starts"][:4]])

    def k4(starts, size):
        n = len(starts)
        act = torch.full((n, 128), s, dtype=torch.int32, device=dev)
        act[:, 0] = 0
        cnt = torch.zeros((n, s + 1), dtype=torch.int32, device=dev)
        lens = np.full(n, size)
        return lambda: hn.nfa_active_scan(csr, t["l7_bytes"], starts, lens, act, cnt)

    # the snapshot once the lazy DFA has outgrown 1,024 states: padded to
    # 2,048, which no shared-memory form holds
    wide_table = torch.nn.functional.pad(t["lazy_table"], (0, 1024)).contiguous()
    wide_accept = torch.nn.functional.pad(t["lazy_accept"], (0, 1024)).contiguous()

    def lazy(kernel, lanes, steps=None, same=False, wide=False):
        """K1 or K2 over the lazy path's 4 MiB chunk cut into ``lanes``; only
        the first ``steps`` of each lane; ``same``: every lane reads class 0
        from state 0, so that a warp's table loads share one address;
        ``wide``: the table padded to 2,049 columns (global memory)."""
        cls = t["lazy_cls"].reshape(lanes, -1).T[:steps]
        ent = t["lazy_entries"].repeat(lanes // 1024)
        if same:
            cls, ent = torch.zeros_like(cls), torch.zeros_like(ent)
        table, accept = ((wide_table, wide_accept) if wide
                         else (t["lazy_table"], t["lazy_accept"]))
        return lambda: kernel(table, accept, cls, ent)

    # K3 on the tokenizer's k=4 tables: this tree's own packing of them
    tok_dfa = build_tokenizer_dfa()
    kg = kgram_ops.build_kgram(
        build_dfa_tables(tok_dfa.table, tok_dfa.accept, device="cpu"), levels=2)
    kg_ta = hk.pack_ta(t["kg_table"], t["kg_acc"])
    kg_cls = t["kg_cls"].T
    text = t["tok_text"]
    if hasattr(hk, "kgram_chain_bytes"):
        maps = kgram_ops.kgram_maps(kg).to(dev)
        text3 = text.reshape(65536, 256, 4).transpose(0, 1)
        k3_bytes = lambda: hk.kgram_chain_bytes(kg_ta, maps, text3, tok_start)
        k3_text = k3_bytes
    else:
        k3_bytes = None
        k3_text = lambda: hk.kgram_chain(
            kg_ta, kgram_ops.map_kgram_classes(kg, text).reshape(65536, 256).T,
            tok_start)

    def chase(entry_bytes, spread):
        """Nanoseconds per dependent shared-memory load, the warp's lanes in
        32 banks (spread) or in one."""
        lib = _build.library()
        if not hasattr(lib, "smem_chase"):
            return None
        out = torch.empty(32, dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream

        def run(steps):
            return lambda: _build.check(
                lib.smem_chase(entry_bytes, steps, spread, out.data_ptr(), stream),
                "smem_chase")
        return lambda: (event_ms(run(8192), 20) - event_ms(run(4096), 20)) / 4096 * 1e6

    def k6(table, cls):
        return lambda: hd.dfa_block_fns(t[table], t[cls])

    def combine(table, cls):
        """The combine over these blocks' functions (made once, untimed, by
        this tree's pass 1), in dfa_scan_blocked's groups, from state 1."""
        fns = {}

        def run():
            if not fns:
                f = hd.dfa_block_fns(t[table], t[cls])
                group = max(1, FN_GROUP_BYTES // (4 * f.shape[1]))
                fns["groups"] = [f[g:g + group] for g in range(0, f.shape[0], group)]
            cur = torch.ones(1, dtype=torch.int32, device=dev)
            for f in fns["groups"]:
                _, cur = block_entry_states(f, cur)
            return cur
        return run

    cases = {
        "k1 tokenizer 65536x1024": lambda: hd.dfa_chain(
            t["tok_table"], t["tok_accept"], tok_cls, tok_ent),
        "k2 tokenizer 65536x1024": lambda: hd.dfa_chain_counts(
            t["tok_table"], t["tok_accept"], tok_cls, tok_ent),
        "k2 tokenizer 65536x1024, 64 streams": lambda: hd.dfa_chain_counts(
            t["tok_table"], t["tok_accept"], tok_cls, tok_ent, 64),
        "k2 tokenizer 65536x1024, real text": lambda: hd.dfa_chain_counts(
            t["tok_table"], t["tok_accept"], t["tok_text_cls"].T, tok_start),
        "k2 aho-corasick S=836 65536x1024": lambda: hd.dfa_chain_counts(
            t["ac_table"], t["ac_accept"], t["ac_cls"].T, tok_ent),
        "k1 lazy (83,1025) 1024x4096": lazy(hd.dfa_chain, 1024),
        "k2 lazy (83,1025) 1024x4096": lazy(hd.dfa_chain_counts, 1024),
        "k1 lazy (83,1025) 1024x32": lazy(hd.dfa_chain, 1024, 32),
        "k1 lazy (83,1025) 1024x1024": lazy(hd.dfa_chain, 1024, 1024),
        "k1 lazy (83,1025) 1024x2048": lazy(hd.dfa_chain, 1024, 2048),
        "k1 lazy (83,1025) 1024x4096, one table entry": lazy(hd.dfa_chain, 1024, None, True),
        "k1 lazy (83,2049) 1024x4096, global table": lazy(hd.dfa_chain, 1024, wide=True),
        "k2 lazy (83,2049) 1024x4096, global table": lazy(hd.dfa_chain_counts, 1024, wide=True),
        "k1 lazy (83,1025) 4096x1024": lazy(hd.dfa_chain, 4096),
        "k2 lazy (83,1025) 4096x1024": lazy(hd.dfa_chain_counts, 4096),
        "k1 lazy (83,1025) 16384x256": lazy(hd.dfa_chain, 16384),
        "k2 lazy (83,1025) 16384x256": lazy(hd.dfa_chain_counts, 16384),
        "k3 tokenizer k=4 65536x256, class ids": lambda: hk.kgram_chain(
            kg_ta, kg_cls, tok_ent),
        "k3 tokenizer k=4 65536x256, from raw text": k3_text,
        "k3 bytes tokenizer k=4 65536x256x4": k3_bytes,
        "k4 l7 4x16KiB": k4(z["l7_small_starts"], 16 * 1024),
        "k4 l7 64x1MiB": k4(z["l7_big_starts"], MIB),
        "k5 l7 64x1MiB": k5(csr, l7_flows),
        "k5 snort 132x64KiB": k5(snort_csr, t["snort_flows"]),
        "k5 step l7 4x4KiB": k5(csr, l7_step, step=True),
        "k6 aho-corasick (36,836) 65536x1024": k6("ac_table", "k6_ac_cls"),
        "k6 parity (2,2) 65536x1024": k6("k6_parity_table", "k6_parity_cls"),
        "k6 reversed (aa)*b (3,4) 65536x1024": k6("k6_rev_table", "k6_rev_cls"),
        "k6 permutation (36,836) 65536x1024": k6("k6_perm_table", "k6_perm_cls"),
        "k6 combine S=836 65536 blocks": combine("ac_table", "k6_ac_cls"),
        "k6 combine S=2 65536 blocks": combine("k6_parity_table", "k6_parity_cls"),
    }
    def wanted(name):
        return not only or any(word in name for word in only)

    out = {}
    for eb in (2, 4):
        for spread in (1, 0):
            name = (f"smem chase uint{8 * eb}, {'32 banks' if spread else 'one bank'}, "
                    f"ns per load")
            fn = chase(eb, spread)
            if wanted(name):
                out[name] = fn() if fn else None
    for name, fn in cases.items():
        if not wanted(name):
            continue
        if fn is None:
            out[name] = None
            continue
        out[name] = event_ms(fn, REPS.get(name, 20))
    return out


def lazy_passes(mib: int) -> None:
    """Print the chain passes of a cold and a warmed ``lazy_nfa_scan`` call
    over ``mib`` MiB of the Snort traffic, on the CPU."""
    import collections

    sys.path.insert(0, ROOT)
    from regex_fpga_tpu_torch.models import LazyDfa, gen_traffic, snort_corpus_nfa
    from regex_fpga_tpu_torch.ops import dfa_take, hopper_dfa, lazy_scan

    seen = collections.Counter()

    def logged(fn, name):
        def call(table, accept, cls_seq, entries, *rest):
            mode = rest[0] if rest and isinstance(rest[0], str) else "counts"
            seen[name, mode, tuple(cls_seq.shape), tuple(table.shape)] += 1
            return fn(table, accept, cls_seq, entries, *rest)
        return call

    dfa_take.dfa_chain = logged(hopper_dfa.dfa_chain, "k1")
    dfa_take.dfa_chain_counts = logged(hopper_dfa.dfa_chain_counts, "k2")
    data = np.resize(np.frombuffer(b"".join(gen_traffic()[0]), np.uint8), mib * MIB)
    ld = LazyDfa(snort_corpus_nfa())
    for call in ("cold", "warmed"):
        seen.clear()
        lazy_scan.lazy_nfa_scan(ld, data, device="cpu")
        print(f"{call} call: the lazy DFA has {ld.num_states} states")
        for key, n in sorted(seen.items(), key=lambda kv: -kv[1]):
            print(f"  {n:4d} x {key}")


def event_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` runs after a warm-up."""
    import torch

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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("trees", nargs="*", help="checkout roots to compare")
    parser.add_argument("--rounds", type=int, default=2,
                        help="rounds of (trees in order, then reversed)")
    parser.add_argument("--out", help="also write the runs here as JSON")
    parser.add_argument("--cases", default="",
                        help="comma-separated words: time only the cases whose "
                             "name holds one of them")
    parser.add_argument("--lazy-passes", type=int, metavar="MIB",
                        help="on the CPU: list the chain passes of lazy_nfa_scan "
                             "over MIB MiB of Snort traffic, cold and warmed")
    parser.add_argument("--time", help=argparse.SUPPRESS)    # child: one tree
    parser.add_argument("--inputs", help=argparse.SUPPRESS)  # child: its inputs
    args = parser.parse_args(argv)
    if args.lazy_passes:
        lazy_passes(args.lazy_passes)
        return 0
    if args.time:
        only = [w for w in args.cases.split(",") if w]
        print(json.dumps({"tree": args.time,
                          "ms": time_tree(args.time, args.inputs, only)}))
        return 0
    import torch

    if not torch.cuda.is_available() or len(args.trees) < 2:
        print("torch_kernel_ab: needs a CUDA card and two trees", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    trees = [os.path.abspath(tr) for tr in args.trees]
    inputs = os.path.join(ROOT, "build", "torch_kernel_ab_inputs.npz")
    os.makedirs(os.path.dirname(inputs), exist_ok=True)
    make_inputs(inputs)
    runs = []
    for _ in range(args.rounds):
        for tree in trees + trees[::-1]:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--time", tree,
                 "--inputs", inputs, "--cases", args.cases],
                capture_output=True, text=True)
            if proc.returncode != 0:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                return 1
            runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
            print(json.dumps(runs[-1]), flush=True)
    cases = list(dict.fromkeys(c for r in runs for c in r["ms"]))

    def median(tree, case):
        got = [r["ms"].get(case) for r in runs if r["tree"] == tree]
        got = [v for v in got if v is not None]
        return float(np.median(got)) if got else None

    medians = {tree: {c: median(tree, c) for c in cases} for tree in trees}
    for c in cases:
        unit = "" if "ns per" in c else " ms"
        print(f"{c}: " + ", ".join(
            f"{os.path.basename(tr) or tr} "
            + ("null" if medians[tr][c] is None else f"{medians[tr][c]:.4f}{unit}")
            for tr in trees))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, "runs": runs, "medians": medians}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
