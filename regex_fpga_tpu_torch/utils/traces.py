"""Loaders for the reference conformance fixtures (the port's copy of
``regex_fpga_tpu/utils/traces.py``).

The reference testbench consumes hex byte-per-line ``.mem`` traces via
``$readmemh`` (``Simulation/testbench_BLK_Mem.sv:34-35``) and hard-codes a
200,000-character run (``testbench_BLK_Mem.sv:71``) even where traces are
longer — loaders here reproduce that truncation so conformance runs match the
reference harness exactly.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = [
    "read_mem_trace",
    "reference_root",
    "RULESETS",
    "load_ruleset",
    "load_trace_pair",
    "REFERENCE_RUN_LENGTH",
]

# Hard-coded run length of the reference harness (testbench_BLK_Mem.sv:71).
REFERENCE_RUN_LENGTH = 200_000


def read_mem_trace(path: str, limit: int | None = REFERENCE_RUN_LENGTH) -> np.ndarray:
    """Read a ``$readmemh``-style one-hex-byte-per-line trace as uint8."""
    with open(path, "r") as f:
        data = np.array(
            [int(line, 16) for line in f if line.strip()], dtype=np.uint8
        )
    return data[:limit] if limit is not None else data


def reference_root() -> str:
    """``REGEX_FPGA_REFERENCE``, or the ``reference`` directory inside the
    repository's checkout; the default never leaves the checkout."""
    default = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "reference")
    return os.environ.get("REGEX_FPGA_REFERENCE", default)


# ruleset name -> (coe relpath, trace name fragment, num_states)
RULESETS = {
    "l-7_filter": ("Block_Mem/CSR_BlockMem.coe", "l-7_filter", 2794),
    "snort_16": ("Block_Mem/CSR_BlockMem_snort_16.coe", "snort_16", 9514),
}


def load_ruleset(name: str):
    from ..models.csr import load_coe

    coe_rel, _, _ = RULESETS[name]
    return load_coe(os.path.join(reference_root(), coe_rel))


def load_trace_pair(
    name: str, limit: int | None = REFERENCE_RUN_LENGTH
) -> tuple[np.ndarray, np.ndarray]:
    """Return the (lo, hi) stream pair for a ruleset, truncated like the
    reference harness."""
    _, frag, _ = RULESETS[name]
    root = reference_root()
    lo = read_mem_trace(os.path.join(root, f"Simulation/input_trace_lo_{frag}.mem"), limit)
    hi = read_mem_trace(os.path.join(root, f"Simulation/input_trace_hi_{frag}.mem"), limit)
    return lo, hi
