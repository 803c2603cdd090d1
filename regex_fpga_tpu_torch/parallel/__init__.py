"""Distributed scans on ``torch.distributed``: the counterpart of
``regex_fpga_tpu/parallel/`` (one process a rank; see ``mesh``)."""

from .dist_scan import dfa_scan_fast_dist, dfa_scan_kgram_dist, nfa_scan_dist
from .ingest import CheckpointStore, iter_file_chunks, resilient_scan, shard_files
from .mesh import DATA_AXIS, MODEL_AXIS, SEQ_AXIS, make_mesh, make_tp_mesh
from .multi_ruleset import multi_ruleset_scan, stack_nfa_tables
from .tp_scan import nfa_scan_tp, pad_tables_tp

__all__ = [
    "CheckpointStore",
    "DATA_AXIS",
    "MODEL_AXIS",
    "SEQ_AXIS",
    "dfa_scan_fast_dist",
    "dfa_scan_kgram_dist",
    "iter_file_chunks",
    "make_mesh",
    "make_tp_mesh",
    "multi_ruleset_scan",
    "nfa_scan_dist",
    "nfa_scan_tp",
    "pad_tables_tp",
    "resilient_scan",
    "shard_files",
    "stack_nfa_tables",
]
