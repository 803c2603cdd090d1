"""The controls: the plain reference with one guarantee broken, put in the
port's place at a cell's own size, and held to the reference as a run is.
Each must come out not correct; its numbers are the upper readings the
limits were set from. Not part of a benchmark run.

    python -m benchmark.control --workload <name> --seeds 1,2,3 [--seconds 3]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = run.run_cell(args.workload, seed, args.seconds, False,
                         t0=time.perf_counter(), system="control")
        line = {"workload": args.workload, "seed": seed, "correct": r["correct"],
                "attempted": r["attempted"], "checks": r["checks"]}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
