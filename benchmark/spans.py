"""The program's own spans in a traced window, and the arithmetic the
readers of them share.

The port records its spans through ``regex_fpga_tpu_torch.utils.profiling
.trace`` into the same ``torch.profiler`` trace as the device events, as
``user_annotation`` events named ``rf.<layer>.<what>``: ``rf.api.*`` around
a public call, ``rf.engine.*`` around a chunk, a chain pass, the exact
fallback or the positions compaction, ``rf.device.*`` around a copy that
carries the request's bytes or its answer. The calls run on one thread, so
the spans nest: the innermost program span at a host instant is the layer
the host was in, and the intervals where a span is innermost are its self
time. A program without these spans reads ``None`` in every reader.

The profiler stamps host events and device events on two clocks that it
lines up only roughly: on an H100 the device timeline has sat from tens of
microseconds to tens of milliseconds off the host's within one 3-s window,
drifting as it went. So an idle interval of the card is not read at its
device-clock instants. ``idle_on_host`` places each one on the host clock
by the device operation that ends it: on one stream the card runs its work
in the order the host enqueued it, so the k-th last kernel (copy, memset)
pairs with the k-th last host call that launched one, and a card that was
idle starts that work as soon as the call enqueues it. The interval, its length read
on the device clock, is put to end where that call begins.
"""

from __future__ import annotations

import bisect

from benchmark.trace import union

__all__ = ["PREFIX", "API", "ENGINE", "PASS", "CHUNKS", "COPIES", "WAITS",
           "ENQUEUE", "program", "innermost", "enqueued", "idle_on_host",
           "idle_by_span", "inside"]

PREFIX = "rf."
API = "rf.api."
ENGINE = "rf.engine."
PASS = "rf.engine.pass"
#: one span a chunk on the chain engines: K3's k-gram scan, K1 or K2
CHUNKS = ("rf.engine.kgram", "rf.engine.k1")
#: the copies that carry a request's bytes to the card or its answer back
COPIES = ("rf.device.upload", "rf.device.readback")
#: the runtime calls that make the host wait: those that
#: ``metrics/api.host_waits_per_call.py`` counts (a test holds the two equal)
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D")
#: the host calls (CUDA runtime or driver) that put each kind of device
#: event on a stream, by a part of their name
ENQUEUE = {"kernel": ("LaunchKernel", "LaunchCooperativeKernel"),
           "gpu_memcpy": ("Memcpy",), "gpu_memset": ("Memset",)}


def program(tr) -> list:
    """The program's spans that overlap the window."""
    return [e for e in tr.of("user_annotation") if e.name.startswith(PREFIX)]


def innermost(spans, t0: float, t1: float) -> list[tuple[float, float, str]]:
    """(start, end, name) of each stretch of [t0, t1] with a span over it,
    named by the innermost span there: each span's self intervals, in time
    order. ``spans`` nest (one thread's)."""
    out: list[tuple[float, float, str]] = []
    stack: list = []  # the spans open at ``at``, innermost last
    at = t0

    def run_to(t: float) -> None:
        nonlocal at
        while True:
            while stack and stack[-1].end <= at:
                stack.pop()
            end = min(t, stack[-1].end) if stack else t
            if end <= at:
                return
            if stack:
                out.append((at, end, stack[-1].name))
            at = end

    for e in sorted(spans, key=lambda e: (e.ts, -e.dur)):
        run_to(min(e.ts, t1))
        stack.append(e)
    run_to(t1)
    return out


def enqueued(tr):
    """(pairs, unknown_to): each device event of the trace with the host
    call that enqueued it, in the device's order, and the host instant up
    to which the card's work is not all known. On one stream the card runs
    each kind of work in the order the host enqueued it, so the k-th last
    device event of a kind pairs with the k-th last call that enqueues that
    kind (a call held inside another, as a driver call inside the
    runtime's, is the same launch). The profiler may lose the records of a
    session's first device events (on an H100, those of the first 39
    launches of one 3-s window): a kind's calls left over at its start have
    no record, and ``unknown_to`` is where the last of them ends (minus
    infinity when none is left over). ``None`` without device events, or
    where a kind has more device events than calls."""
    host = sorted((e for e in tr.events if e.cat in ("cuda_runtime", "cuda_driver")),
                  key=lambda e: (e.ts, -e.dur))
    pairs, unknown_to = [], float("-inf")
    for cat, names in ENQUEUE.items():
        dev = sorted((e for e in tr.events if e.cat == cat), key=lambda e: e.ts)
        calls, end = [], float("-inf")
        for e in host:
            if any(n in e.name for n in names):
                if e.ts >= end:  # not held inside the last one
                    calls.append(e)
                    end = e.end
        lost = len(calls) - len(dev)
        if lost < 0:
            return None
        if lost:
            unknown_to = max(unknown_to, calls[lost - 1].end)
        pairs += zip(dev, calls[lost:])
    if not pairs:
        return None
    return sorted(pairs, key=lambda p: p[0].ts), unknown_to


def idle_on_host(tr) -> list[tuple[float, float]] | None:
    """The card's idle intervals over the whole trace, each placed on the
    host clock: it ends where the call that enqueued the device event
    ending it begins, and keeps its length on the device clock (the one
    after the last device event keeps the last interval's shift). In time
    order, none overlapping the last, and none before ``enqueued``'s
    ``unknown_to``. ``None`` as ``enqueued``."""
    found = enqueued(tr)
    if found is None:
        return None
    pairs, unknown_to = found
    out: list[tuple[float, float]] = []
    busy_to = shift = float("-inf")  # device clock; device minus host
    for dev, call in pairs:
        if dev.ts > busy_to:  # an idle interval ends with ``dev``
            shift = dev.ts - call.ts
            out.append((busy_to - shift, call.ts))
        busy_to = max(busy_to, dev.end)
    out.append((busy_to - shift, float("inf")))
    at, kept = unknown_to, []
    for a, b in out:
        a = max(a, at)
        if b > a:
            kept.append((a, b))
            at = b
    return kept


def idle_by_span(tr) -> dict[str, float] | None:
    """Microseconds of the window in which the card ran no kernel, copy or
    memset, by the innermost program span over each instant of them (each
    idle interval placed on the host clock by ``idle_on_host`` and cut
    exactly at the spans' bounds); idle time under no program span is left
    out. ``None`` without program spans, or as ``idle_on_host``."""
    spans = program(tr)
    idle = idle_on_host(tr) if spans else None
    if idle is None:
        return None
    out: dict[str, float] = {}
    i = 0
    for a, b, name in innermost(spans, tr.t0, tr.t1):
        while i < len(idle) and idle[i][1] <= a:
            i += 1
        j = i
        while j < len(idle) and idle[j][0] < b:
            d = min(b, idle[j][1]) - max(a, idle[j][0])
            out[name] = out.get(name, 0.0) + d
            j += 1
    return out


def inside(events, spans) -> list[bool]:
    """For each event, whether it lies wholly inside one of ``spans``."""
    cover = union(spans, float("-inf"), float("inf"))
    starts = [a for a, _ in cover]
    out = []
    for e in events:
        k = bisect.bisect_right(starts, e.ts) - 1
        out.append(k >= 0 and e.end <= cover[k][1])
    return out
