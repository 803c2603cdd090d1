"""Device engines of the torch port: tables, the k=1 and k-gram chain
scans on their Hopper kernels (``hopper_dfa``, ``hopper_kgram``), the exact
fallback (``dfa_engine``), the lazy-DFA chain scan and its host/device loop
(``dfa_take``, ``lazy_scan``, on ``hopper_dfa``), and the active-set NFA
engine (``nfa_engine``, on ``hopper_nfa``).

The package exports the names of the JAX package's ``regex_fpga_tpu.ops``,
with one rename: its ``nfa_scan_jax`` is ``nfa_scan`` here. Importing it
builds no kernel: each kernel is built at its first call on the card."""

from .dfa_engine import (
    DfaScanResult,
    block_entry_states,
    block_transition_functions,
    compose,
    dfa_match_positions,
    dfa_scan_blocked,
    dfa_scan_serial,
)
from .dfa_fast import (
    FastScanResult,
    chain_pass_finals,
    chain_pass_full,
    dfa_scan_fast,
)
from .dfa_take import (
    TakeCountsResult,
    TakeScanResult,
    dfa_scan_take,
    dfa_scan_take_counts,
)
from .kgram import KgramTables, build_kgram, dfa_scan_kgram, map_kgram_classes
from .lazy_scan import LazyScanState, lazy_nfa_scan
from .nfa_engine import (
    DEFAULT_ACTIVE_BOUND,
    NfaScanResult,
    nfa_scan,
    nfa_scan_batch,
)
from .tables import (
    DfaTables,
    NfaTables,
    build_dfa_tables,
    build_dfa_tables_from_csr,
    build_nfa_tables,
)

__all__ = [
    "DEFAULT_ACTIVE_BOUND",
    "DfaScanResult",
    "DfaTables",
    "FastScanResult",
    "KgramTables",
    "LazyScanState",
    "TakeCountsResult",
    "TakeScanResult",
    "build_kgram",
    "dfa_scan_kgram",
    "dfa_scan_take",
    "dfa_scan_take_counts",
    "lazy_nfa_scan",
    "map_kgram_classes",
    "chain_pass_finals",
    "chain_pass_full",
    "dfa_scan_fast",
    "NfaScanResult",
    "NfaTables",
    "block_entry_states",
    "block_transition_functions",
    "build_dfa_tables",
    "build_dfa_tables_from_csr",
    "build_nfa_tables",
    "compose",
    "dfa_match_positions",
    "dfa_scan_blocked",
    "dfa_scan_serial",
    "nfa_scan_batch",
    "nfa_scan",
]
