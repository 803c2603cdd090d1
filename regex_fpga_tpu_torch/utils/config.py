"""Engine configuration (SURVEY.md SS5.6 — the reference hard-codes its
parameters in Verilog: ``size_range`` at top.v:8, ``parallel_lane=4`` at
FPGA.v:47, run length at testbench_BLK_Mem.sv:71; here they are one
dataclass)."""

from __future__ import annotations

import dataclasses

__all__ = ["EngineConfig", "DEFAULT_CONFIG"]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    # NFA engine
    active_bound: int = 128          # max simultaneous NFA states (flags overflow)
    # fast DFA engine
    num_blocks: int = 65536          # parallel chains per chunk
    max_iters: int = 16              # Jacobi fixpoint budget
    min_block_bytes: int = 64        # below NB*this, shrink NB
    # streaming
    chunk_bytes: int = 1 << 26       # 64 MiB device chunks
    # distribution
    blocks_per_shard: int = 8192
    #: host-vs-device engine routing for counting/histogram scans
    #: (``ops/router.py``): "auto" = measured-crossover cost model,
    #: "device"/"host" force one side (tests, rigs without the native lib)
    scan_backend: str = "auto"


DEFAULT_CONFIG = EngineConfig()


def shrink_blocks(nbytes: int, num_blocks: int, min_block_bytes: int,
                  divisible: bool = True) -> int:
    """The engines' shared block-count rule: halve ``num_blocks`` until
    each block holds at least ``min_block_bytes``, then (when
    ``divisible``) until it divides ``nbytes`` exactly.  Ragged batching
    passes ``divisible=False`` and pads the stream UP to a block multiple
    instead (the stall class makes padding exact)."""
    nb = num_blocks
    while nb > 1 and nbytes // nb < min_block_bytes:
        nb //= 2
    if divisible:
        while nbytes % nb:
            nb //= 2
    return max(nb, 1)
