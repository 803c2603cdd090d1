#!/usr/bin/env python3
"""Time the two uploads of the port's ragged batch against each other on one
CUDA card, in alternating pairs.

    python3 torch_upload_ab.py [--pairs 12] [--out FILE]
    python3 torch_upload_ab.py --device cpu --small     # a quick CPU check

``DfaMatcher._scan_ragged_counts`` puts a chunk's rows into one device
array, either as one host concatenation uploaded once ("concat") or as one
copy a row ("rows"); ``api._CONCAT_ROW_BYTES`` picks between them by the
rows' mean length. This script forces each path in turn (0: always rows,
2**62: always concat) and runs the two as pairs, concat then rows and rows
then concat in turns, on:

  snort     stage 1 of the Snort matcher (``_prefilter_counts``):
            ``compile_snort`` over the 3,000-rule community-scale corpus,
            ``gen_traffic(4000)``, two ragged batches of 4,000 rows
            (193 bytes a row on average);
  tok-64    the GPT-2 tokenizer DFA over 64 seeded flows of 1 KiB-2 MiB,
            the shape of ``chip_smoke.py`` phase 3's ragged batch;
  rows-L    the tokenizer DFA over 16 MiB of seeded bytes in rows of L
            bytes on average (lengths drawn within +-50%), L from 256 B to
            4 MiB: where the two paths cross.

The tokenizer cases time ``_scan_ragged_counts`` itself. Every run is
host-clocked (``perf_counter``, ended by a device synchronize) and its
result is held to the first run's. One JSON line per case: each path's
median, min and max in ms, the median of the per-pair differences (rows
less concat) and the number of pairs that concat won. Then the card's name
and power limit; ``--out`` also writes the lines to a file. Exits non-zero
when a result differs between the paths.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

MIB = 1 << 20
SEED = 20261017
PATHS = {"concat": 1 << 62, "rows": 0}
ROW_MEANS = [256, 1 << 10, 4 << 10, 16 << 10, 64 << 10, 256 << 10, MIB,
             4 * MIB]


def ragged_rows(rng, total: int, mean: int) -> list[np.ndarray]:
    """Seeded rows of ``mean`` bytes on average (+-50%) filling ``total``."""
    data = rng.integers(0, 256, size=total, dtype=np.uint8)
    lens = rng.integers(mean // 2, mean + mean // 2 + 1,
                        size=max(2, total // mean))
    cuts = np.minimum(np.cumsum(lens), total)
    return [r for r in np.split(data, cuts[:-1]) if r.size]


def digest(result) -> list:
    """The comparable part of a case's result (arrays or tuples of them)."""
    if isinstance(result, tuple):
        return [digest(x) for x in result]
    if isinstance(result, np.ndarray):
        return [result.shape, result.tobytes()]
    return [result]


def timed(fn) -> float:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def run_case(api, name: str, fn, pairs: int) -> dict:
    """Warm both paths, then ``pairs`` pairs in alternating order."""
    want, same = None, True
    for path in PATHS:  # warm-up, and each path's result
        api._CONCAT_ROW_BYTES = PATHS[path]
        got = digest(fn())
        want = got if want is None else want
        same &= got == want
    ms = {p: [] for p in PATHS}
    for k in range(pairs):
        for path in (("concat", "rows") if k % 2 == 0 else ("rows", "concat")):
            api._CONCAT_ROW_BYTES = PATHS[path]
            ms[path].append(timed(fn))
    diff = np.array(ms["rows"]) - np.array(ms["concat"])
    out = {"case": name, "pairs": pairs, "results_equal": bool(same)}
    for path, t in ms.items():
        out[path] = {"median_ms": float(np.median(t)), "min_ms": min(t),
                     "max_ms": max(t)}
    out["rows_less_concat_median_ms"] = float(np.median(diff))
    out["concat_won"] = int((diff > 0).sum())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pairs", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="small inputs (for a check on the CPU)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from regex_fpga_tpu_torch import api
    from regex_fpga_tpu_torch.models import gen_community_rules, gen_traffic

    saved = api._CONCAT_ROW_BYTES
    rng = np.random.default_rng(SEED)
    dev = args.device
    total = 64 << 10 if args.small else 16 * MIB
    means = [m for m in ROW_MEANS if m <= total // 4]
    cfg = api.EngineConfig(scan_backend="device")
    tok = api.compile_tokenizer(config=cfg, device=dev)
    ids = api.compile_snort(gen_community_rules(), device=dev)
    payloads, _ = gen_traffic(n_payloads=40 if args.small else 4000)
    snort_rows = [np.frombuffer(p, np.uint8) for p in payloads]
    flow_lens = rng.integers(1024, (16 << 10 if args.small else 2 * MIB) + 1,
                             size=64)
    flows = [rng.integers(0, 256, size=int(n), dtype=np.uint8)
             for n in flow_lens]
    cases = [("snort", lambda: ids._prefilter_counts(snort_rows)),
             ("tok-64", lambda: tok._scan_ragged_counts(flows)[0])]
    for mean in means:
        rows = ragged_rows(rng, total, mean)
        cases.append((f"rows-{mean}",
                      lambda rows=rows: tok._scan_ragged_counts(rows)[0]))

    lines, ok = [], True
    try:
        for name, fn in cases:
            res = run_case(api, name, fn, args.pairs)
            ok &= res["results_equal"]
            lines.append(json.dumps(res))
            print(lines[-1], flush=True)
    finally:
        api._CONCAT_ROW_BYTES = saved
    if dev != "cpu":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
        lines.append(smi)
        print(smi, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
