"""The traced run's window: the profiler's events, and the arithmetic the
per-layer readers share.

Events are plain records (name, category, start and length in
microseconds) read from the profiler's Chrome trace, so the readers and
their tests need no card. Device activity is what ran on the card: kernels,
copies and memsets. Nothing here reads a clock of its own.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile

__all__ = ["Event", "Trace", "DEVICE_CATS", "HBM_BYTES_PER_S", "bound_s",
           "capture", "events_from_chrome", "union", "gaps"]

#: the card's memory rate: NVIDIA H100 SXM5 80 GB, HBM3, 3.35 TB/s
HBM_BYTES_PER_S = 3.35e12
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: what the host runs: the innermost of these over an idle gap names it
HOST_CATS = ("cuda_runtime", "cuda_driver", "cpu_op", "user_annotation")
WINDOW_SPAN = "bench.window"


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    cat: str
    ts: float   # microseconds
    dur: float  # microseconds

    @property
    def end(self) -> float:
        return self.ts + self.dur


@dataclasses.dataclass
class Trace:
    """One traced window: its events (unclipped; ``of`` keeps those that
    overlap the window), its bounds in trace time, the calls it holds and
    their bytes."""

    events: list[Event]
    t0: float          # window start, microseconds
    t1: float          # window end, microseconds
    calls: int
    bytes_in: int      # bytes the calls handed the port
    bytes_out: int     # bytes of the answers the calls returned

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def of(self, *cats: str) -> list[Event]:
        return [e for e in self.events if e.cat in cats
                and e.end > self.t0 and e.ts < self.t1]

    def device(self) -> list[Event]:
        return self.of(*DEVICE_CATS)

    def busy_s(self) -> float:
        return sum(b - a for a, b in union(self.device(), self.t0, self.t1)) * 1e-6


def bound_s(bytes_read: int, bytes_written: int) -> float:
    """The least time the card could take for this work: every input byte
    read once and every output byte written once at the memory rate. A scan
    is dependent table lookups with no arithmetic worth a peak rate, so the
    bytes bound it."""
    return (bytes_read + bytes_written) / HBM_BYTES_PER_S


def union(events, t0: float, t1: float) -> list[tuple[float, float]]:
    """The intervals covered by ``events`` inside [t0, t1], merged."""
    spans = sorted((max(e.ts, t0), min(e.end, t1)) for e in events)
    out: list[list[float]] = []
    for a, b in spans:
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def gaps(busy: list[tuple[float, float]], t0: float, t1: float):
    """The idle intervals of [t0, t1] around the merged ``busy`` ones."""
    out, at = [], t0
    for a, b in busy:
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if at < t1:
        out.append((at, t1))
    return out


def events_from_chrome(doc: dict) -> list[Event]:
    return [Event(str(e.get("name", "")), str(e.get("cat", "")),
                  float(e["ts"]), float(e.get("dur", 0.0)))
            for e in doc.get("traceEvents", [])
            if e.get("ph") == "X" and "ts" in e]


def capture(prof) -> list[Event]:
    """The events of a finished ``torch.profiler.profile``, read through its
    Chrome trace (written under TMPDIR and removed at once)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return events_from_chrome(json.load(f))
    finally:
        os.unlink(path)


def window(events: list[Event]) -> tuple[float, float]:
    """The bounds of the harness's window span."""
    spans = [e for e in events if e.name == WINDOW_SPAN
             and e.cat == "user_annotation"]
    if not spans:
        raise ValueError(f"the trace holds no {WINDOW_SPAN!r} span")
    return spans[0].ts, spans[0].end


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    time by what the host was doing then (the innermost host event over
    the middle of each gap), each list in seconds."""
    ops: dict[str, float] = {}
    for e in tr.device():
        d = min(e.end, tr.t1) - max(e.ts, tr.t0)
        ops[e.name] = ops.get(e.name, 0.0) + d * 1e-6
    host = sorted((e for e in tr.of(*HOST_CATS) if e.name != WINDOW_SPAN),
                  key=lambda e: e.ts)
    idle: dict[str, float] = {}
    live: list[Event] = []  # host events begun before the gap's middle
    i = 0
    for a, b in gaps(union(tr.device(), tr.t0, tr.t1), tr.t0, tr.t1):
        mid = (a + b) / 2
        while i < len(host) and host[i].ts <= mid:
            live.append(host[i])
            i += 1
        live = [e for e in live if e.end >= mid]
        name = min(live, key=lambda e: e.dur).name if live else "host: no traced op"
        idle[name] = idle.get(name, 0.0) + (b - a) * 1e-6
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
    return {"device_ops": rank(ops), "idle_gaps": rank(idle)}
