"""Committed golden conformance fixtures (SURVEY.md §4.2 ground truth); the
port's copy of ``regex_fpga_tpu/models/golden.py``, with its own copy of the
JSON beside it.

``golden_histograms.json`` holds the COMPLETE per-state match histograms the
reference testbench prints at end of run (Simulation/testbench_BLK_Mem.sv:
75-85) for all four trace/ruleset combos at the harness's 200,000-char run
length — including the 535-state snort_16/hi table.  It is a byte-for-byte
copy of the JAX package's file (``tests/test_torch_models.py`` checks), which
scripts/gen_golden_histograms.py regenerates (runs the §4.3 golden oracle).

The port's CLI ``conformance`` gate (``regex_fpga_tpu_torch/__main__.py``)
diffs full tables against this file, making the bit-exactness contract a
committed artifact rather than a re-derived one.
"""

from __future__ import annotations

import json
import os
from functools import lru_cache

__all__ = ["load_golden_histograms", "GOLDEN_KEYS"]

GOLDEN_KEYS = (
    "l-7_filter/lo", "l-7_filter/hi", "snort_16/lo", "snort_16/hi",
)

_PATH = os.path.join(os.path.dirname(__file__), "golden_histograms.json")


@lru_cache(maxsize=1)
def load_golden_histograms() -> dict[str, dict]:
    """Return {"<ruleset>/<stream>": {"total", "distinct", "histogram"}}.

    ``histogram`` maps accepting-state index (int) -> match count (int);
    states with zero matches are omitted (the testbench prints only nonzero
    counters, testbench_BLK_Mem.sv:76-82).
    """
    with open(_PATH) as f:
        raw = json.load(f)
    out = {}
    for key, rec in raw.items():
        out[key] = {
            "total": int(rec["total"]),
            "distinct": int(rec["distinct"]),
            "histogram": {int(s): int(c) for s, c in rec["histogram"].items()},
        }
    return out
