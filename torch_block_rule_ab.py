#!/usr/bin/env python3
"""Time the DFA main path's odd-length calls, and their power-of-two
neighbours, through the API of two or more checkouts of the torch port on one
CUDA card, in turns.

    python3 torch_block_rule_ab.py TREE_A TREE_B [--rounds 2] [--repeats 5]
                                   [--out FILE]
    python3 torch_block_rule_ab.py TREE_A TREE_B --device cpu --small

``--device cpu --small`` rehearses the script on the CPU (the kernels' plain
versions) with every size cut 64-fold, the odd lengths kept odd.

Each TREE is the root of a checkout that holds ``regex_fpga_tpu_torch/``.
Every run is a fresh process that imports the port of one tree, builds its
kernels (into that tree's ``build/``), makes the inputs from a seed and times
each call on the host clock (a device synchronize before and after), as the
median of ``--repeats`` runs after a warm-up, under
``EngineConfig(scan_backend="device")`` (64 MiB chunks, 65,536 lanes). A
round runs the trees in order and then in reverse (A, B, B, A). Each run
prints one JSON line with every call's milliseconds, lanes and result; the
script then prints the median of each call per tree, the card's name and
power limit, and fails when two trees' results differ.

Calls (the tokenizer DFA, S=23, on tiled text; a 300-keyword Aho-Corasick
DFA, S=836, on keyword traffic): ``scan`` counts over 64 MiB and 64 MiB - 1;
``count`` over 64 MiB and 64 MiB - 1; ``scan`` positions over 16 MiB and
16 MiB - 1; Aho-Corasick ``scan`` counts over 64 MiB and 64 MiB - 1; one
stream of 1 MiB and of 1,383,198 bytes (the size of the JAX Snort test's
large payload); equal-row batches of 64 x 1 MiB and 64 x (1 MiB + 1).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

MIB = 1 << 20
SEED = 20261017
FRAG = (b"The quick brown fox jumps over 1234 lazy dogs, it's 99.5% fine!  "
        b"pre-split   benchmark text \xc3\xa9t\xc3\xa9 2026... ")
WORDS = [w % i for i in range(300)
         for w in (b"error%04d", b"warning%03d", b"GET /path%d HTTP",
                   b"user-agent: bot%d", b"fail%dure")]
SNORT_PAYLOAD = 1_383_198

#: label -> (matcher, method, bytes a stream before the cut, change in
#: bytes, streams); odd lengths beside their power-of-two neighbours
CALLS = {
    "tok scan counts 64 MiB": ("tok", "scan", 64 * MIB, 0, 1),
    "tok scan counts 64 MiB - 1": ("tok", "scan", 64 * MIB, -1, 1),
    "tok count 64 MiB": ("tok", "count", 64 * MIB, 0, 1),
    "tok count 64 MiB - 1": ("tok", "count", 64 * MIB, -1, 1),
    "tok positions 16 MiB": ("tok", "positions", 16 * MIB, 0, 1),
    "tok positions 16 MiB - 1": ("tok", "positions", 16 * MIB, -1, 1),
    "ac scan counts 64 MiB": ("ac", "scan", 64 * MIB, 0, 1),
    "ac scan counts 64 MiB - 1": ("ac", "scan", 64 * MIB, -1, 1),
    "tok scan 1 MiB": ("tok", "scan", MIB, 0, 1),
    "tok scan 1,383,198 B": ("tok", "scan", SNORT_PAYLOAD - 1, 1, 1),
    "tok batch 64 x 1 MiB": ("tok", "scan", MIB, 0, 64),
    "tok batch 64 x (1 MiB + 1)": ("tok", "scan", MIB, 1, 64),
}


def size(label: str, cut: int) -> int:
    _, _, n, delta, _ = CALLS[label]
    return n // cut + delta


def keyword_traffic(rng, n: int) -> np.ndarray:
    """Seeded words of the synthetic text and of the keyword list."""
    vocab = FRAG.split(b" ") + WORDS[:300]
    picks = rng.integers(0, len(vocab), size=n // 6)
    return np.frombuffer(b" ".join(vocab[i] for i in picks.tolist()),
                         np.uint8)[:n]


def lanes(m, n: int, method: str) -> int:
    """The lanes of the first chain pass over a chunk of ``n`` bytes
    (count: of its k-gram steps) under the tree's own block rule."""
    pick = getattr(m, "_lanes", None) or m._pick_blocks
    return pick(max(n // 4, 1) if method == "count" else n)


def time_tree(tree: str, repeats: int, device: str, cut: int) -> dict:
    """Every call's median milliseconds, lanes and result with ``tree``."""
    sys.path.insert(0, tree)
    import torch

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    from regex_fpga_tpu_torch import api
    from regex_fpga_tpu_torch.models import build_aho_corasick

    if not os.path.abspath(api.__file__).startswith(os.path.abspath(tree) + os.sep):
        raise RuntimeError(f"{api.__file__} is not the package of {tree}")
    rng = np.random.default_rng(SEED)
    cfg = api.EngineConfig(scan_backend="device")
    if cut > 1:  # the rehearsal: 64-fold fewer lanes, as the sizes
        cfg = api.EngineConfig(scan_backend="device", num_blocks=1024,
                               chunk_bytes=MIB)
    m = {"tok": api.compile_tokenizer(config=cfg, device=device),
         "ac": api.DfaMatcher(build_aho_corasick(WORDS[:300]).dfa, cfg,
                              device=device)}
    corpus = {"tok": np.resize(np.frombuffer(FRAG, np.uint8), 65 * MIB // cut),
              "ac": keyword_traffic(rng, 64 * MIB // cut)}
    out = {}
    for label, (who, method, _, _, streams) in CALLS.items():
        n = size(label, cut)
        data = corpus[who][:n] if streams == 1 else \
            corpus[who][:streams * n].reshape(streams, n)
        if method == "count":
            run = lambda: m[who].count(data)
        elif method == "positions":
            run = lambda: m[who].scan(data, collect_positions=True)
        else:
            run = lambda: m[who].scan(data)
        got = run()  # warm-up: kernels, lazy tables
        ms = []
        for _ in range(repeats):
            sync()
            t0 = time.perf_counter()
            run()
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
        if method == "count":
            result = int(got)
        elif method == "positions":
            result = [int(got.total), int(sum(len(p) for p in got.match_positions))]
        else:
            result = [int(got.total), int(got.counts.sum(axis=1).max())]
        out[label] = {"ms": float(np.median(ms)), "lanes": lanes(m[who], n, method),
                      "result": result}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("trees", nargs="*", help="checkout roots to compare")
    parser.add_argument("--rounds", type=int, default=2,
                        help="rounds of (trees in order, then reversed)")
    parser.add_argument("--repeats", type=int, default=5,
                        help="timed runs per call in each run")
    parser.add_argument("--out", help="also write the runs here as JSON")
    parser.add_argument("--device", default="cuda",
                        help="cuda, or cpu with --small for a rehearsal")
    parser.add_argument("--small", action="store_true",
                        help="cut every size 64-fold (odd lengths stay odd)")
    parser.add_argument("--time", help=argparse.SUPPRESS)  # child: one tree
    args = parser.parse_args(argv)
    cut = 64 if args.small else 1
    if args.time:
        print(json.dumps({"tree": args.time, "calls": time_tree(
            args.time, args.repeats, args.device, cut)}))
        return 0
    import torch

    if len(args.trees) < 2 or (args.device == "cuda"
                                and not torch.cuda.is_available()):
        print("torch_block_rule_ab: needs two trees, and a CUDA card unless "
              "--device cpu", file=sys.stderr)
        return 1
    smi = "the CPU (a rehearsal: no device numbers)"
    if args.device == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    trees = [os.path.abspath(tr) for tr in args.trees]
    runs = []
    for _ in range(args.rounds):
        for tree in trees + trees[::-1]:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--time", tree,
                 "--repeats", str(args.repeats), "--device", args.device,
                 *(["--small"] if args.small else [])],
                capture_output=True, text=True)
            if proc.returncode != 0:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                return 1
            runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
            print(json.dumps(runs[-1]), flush=True)
    ok = True
    for label in CALLS:
        results = {json.dumps(r["calls"][label]["result"]) for r in runs}
        if len(results) > 1:
            print(f"{label}: results differ between runs: {results}",
                  file=sys.stderr)
            ok = False
    medians = {tree: {label: float(np.median([r["calls"][label]["ms"]
                                              for r in runs if r["tree"] == tree]))
                      for label in CALLS} for tree in trees}
    for label, (_, _, _, _, streams) in CALLS.items():
        n = size(label, cut) * streams
        print(f"{label}: " + ", ".join(
            f"{os.path.basename(tr) or tr} {medians[tr][label]:.3f} ms "
            f"({n / medians[tr][label] / 1e6:.3f} GB/s, "
            f"{next(r for r in runs if r['tree'] == tr)['calls'][label]['lanes']} "
            f"lanes)" for tr in trees), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, "runs": runs, "medians": medians}, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
