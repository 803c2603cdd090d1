"""Structured run metrics (SURVEY.md SS5.5 — replaces the reference's final
``$display`` dump, testbench_BLK_Mem.sv:75-84, with machine-readable JSON)."""

from __future__ import annotations

import dataclasses
import json
import time

__all__ = ["RunMetrics", "Timer"]


@dataclasses.dataclass
class RunMetrics:
    engine: str = ""
    bytes_scanned: int = 0
    streams: int = 0
    matches: int = 0
    wall_seconds: float = 0.0
    iterations: int = 0            # Jacobi iterations (fast DFA path)
    converged: bool = True
    chunks: int = 0
    devices: int = 1

    @property
    def bytes_per_second(self) -> float:
        return self.bytes_scanned / self.wall_seconds if self.wall_seconds else 0.0

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["bytes_per_second"] = self.bytes_per_second
        return json.dumps(d)


class Timer:
    """Wall-clock context manager. Device work is asynchronous: callers
    bring their results to the host before the block exits."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
