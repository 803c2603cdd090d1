#!/usr/bin/env python3
"""Time the Hopper kernels of two or more checkouts of the torch port on one
CUDA card, in turns, at the main path's shapes.

    python3 torch_kernel_ab.py TREE_A TREE_B [--rounds 2] [--out FILE]

Each TREE is the root of a checkout that holds ``regex_fpga_tpu_torch/``.
The inputs are made once, from a seed, by the port of the tree this script
lives in, and saved under its ``build/``; each tree then builds its own
kernels (into its own ``build/``) and is timed in a fresh process. A round
runs the trees in order and then in reverse (A, B, B, A), so that a drift of
the card's clock over the call does not favour one side. Each run prints one
JSON line; the script ends with the median of every case per tree, the
card's name and power limit, and exits non-zero when a run failed.

Cases (CUDA events; each the mean of REPS launches after one warm-up):
  K1 dfa_chain and K2 dfa_chain_counts on the GPT-2 tokenizer DFA (S=23),
  65,536 lanes x 1,024 steps of seeded class ids; both on the Snort-corpus
  lazy-DFA snapshot (83, 1025) at the lazy-device path's 1,024 lanes x 4,096
  steps of its traffic; K4 nfa_active_scan on the l7-corpus NFA over 4
  streams of 16 KiB and over the main path's 64 flows of 1 MiB (bound 128).
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
REPS = {"k4 l7 64x1MiB": 3}  # every other case: 20


def make_inputs(path: str) -> None:
    """Seeded inputs for every case, from this tree's port."""
    sys.path.insert(0, ROOT)
    from regex_fpga_tpu_torch.models import (LazyDfa, build_tokenizer_dfa,
                                             gen_l7_traffic, gen_traffic,
                                             l7_corpus_nfa, snort_corpus_nfa)
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
    np.savez(
        path,
        tok_table=tok.table.numpy(), tok_accept=tok.accept.numpy(),
        tok_cls=rng.integers(0, tok.table.shape[0], size=(65536, 1024), dtype=np.uint8),
        lazy_table=lazy_table, lazy_accept=lazy_accept,
        lazy_cls=ld.class_of[snort].astype(np.uint8).reshape(1024, 4096),
        lazy_entries=rng.integers(0, lazy_table.shape[1], size=1024).astype(np.int32),
        l7_offsets=csr.offsets.numpy(), l7_targets=csr.targets.numpy(),
        l7_class_of=csr.class_of.numpy(), l7_accept=csr.accept.numpy(),
        l7_bytes=np.resize(np.frombuffer(b"".join(gen_l7_traffic()[0]), np.uint8),
                           64 * MIB),
        l7_small_starts=rng.integers(0, 63 * 16 * 1024, size=4),
        l7_big_starts=rng.integers(0, 63 * MIB, size=64),
    )


def time_tree(tree: str, inputs: str) -> dict:
    """Every case's mean device milliseconds with the kernels of ``tree``."""
    sys.path.insert(0, tree)
    import torch

    from regex_fpga_tpu_torch import _build
    from regex_fpga_tpu_torch.ops import hopper_dfa as hd
    from regex_fpga_tpu_torch.ops import hopper_nfa as hn
    from regex_fpga_tpu_torch.ops.tables import NfaCsr

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

    def k4(starts, size):
        n = len(starts)
        act = torch.full((n, 128), s, dtype=torch.int32, device=dev)
        act[:, 0] = 0
        cnt = torch.zeros((n, s + 1), dtype=torch.int32, device=dev)
        lens = np.full(n, size)
        return lambda: hn.nfa_active_scan(csr, t["l7_bytes"], starts, lens, act, cnt)

    cases = {
        "k1 tokenizer 65536x1024": lambda: hd.dfa_chain(
            t["tok_table"], t["tok_accept"], tok_cls, tok_ent),
        "k2 tokenizer 65536x1024": lambda: hd.dfa_chain_counts(
            t["tok_table"], t["tok_accept"], tok_cls, tok_ent),
        "k1 lazy (83,1025) 1024x4096": lambda: hd.dfa_chain(
            t["lazy_table"], t["lazy_accept"], lazy_cls, t["lazy_entries"]),
        "k2 lazy (83,1025) 1024x4096": lambda: hd.dfa_chain_counts(
            t["lazy_table"], t["lazy_accept"], lazy_cls, t["lazy_entries"]),
        "k4 l7 4x16KiB": k4(z["l7_small_starts"], 16 * 1024),
        "k4 l7 64x1MiB": k4(z["l7_big_starts"], MIB),
    }
    out = {}
    for name, fn in cases.items():
        reps = REPS.get(name, 20)
        fn()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        out[name] = t0.elapsed_time(t1) / reps
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("trees", nargs="*", help="checkout roots to compare")
    parser.add_argument("--rounds", type=int, default=2,
                        help="rounds of (trees in order, then reversed)")
    parser.add_argument("--out", help="also write the runs here as JSON")
    parser.add_argument("--time", help=argparse.SUPPRESS)    # child: one tree
    parser.add_argument("--inputs", help=argparse.SUPPRESS)  # child: its inputs
    args = parser.parse_args(argv)
    if args.time:
        print(json.dumps({"tree": args.time, "ms": time_tree(args.time, args.inputs)}))
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
                 "--inputs", inputs], capture_output=True, text=True)
            if proc.returncode != 0:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                return 1
            runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
            print(json.dumps(runs[-1]), flush=True)
    cases = list(runs[0]["ms"])
    medians = {tree: {c: float(np.median([r["ms"][c] for r in runs
                                           if r["tree"] == tree]))
                      for c in cases} for tree in trees}
    for c in cases:
        print(f"{c}: " + ", ".join(f"{os.path.basename(tr) or tr} "
                                   f"{medians[tr][c]:.4f} ms" for tr in trees))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, "runs": runs, "medians": medians}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
