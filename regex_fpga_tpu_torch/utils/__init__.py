"""Engine settings, run metrics and the conformance fixture loaders: the
port's copies of the JAX package's ``regex_fpga_tpu/utils/config.py``,
``utils/metrics.py`` and ``utils/traces.py``, and ``utils/native.py``, the
JAX package's names for the native host walker (``regex_fpga_tpu_torch
.native``). The package exports the six trace loaders, as the JAX
package's does."""

from .traces import (
    REFERENCE_RUN_LENGTH,
    RULESETS,
    load_ruleset,
    load_trace_pair,
    read_mem_trace,
    reference_root,
)

__all__ = [
    "REFERENCE_RUN_LENGTH",
    "RULESETS",
    "load_ruleset",
    "load_trace_pair",
    "read_mem_trace",
    "reference_root",
]
