"""One run of one benchmark cell.

    python -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Sets up (the port's kernels, built into ``build/kernels/`` inside the
checkout on the first run; the automaton; the requests, made from the seed),
warms up every request once, then calls the port in a closed loop with one
caller for ``--seconds`` (``--trace 1``: at most ``TRACE_SECONDS`` under the
profiler). Once the window has closed it reads the memory peak, frees the
port, holds every kept answer to the plain reference (``reference/``) and
reads the per-layer metrics; its last step, before any result is printed,
refuses the run if a JAX module was loaded by then. The last line of
standard output is the result; the numbers compared, each beside its
limit, are the last lines of standard error and the last key of the
result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

from benchmark import cells, gen, port  # noqa: E402
from benchmark import trace as tracing  # noqa: E402

#: top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "regex_fpga_tpu")
#: the traced window's length at most: its trace stays a few tens of MB
TRACE_SECONDS = 3.0
#: every number compared must be at most its limit: the answers are exact
LIMITS = {"wrong_answers": 0, "failed_calls": 0}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden
    (``regex_fpga_tpu_torch`` is not ``regex_fpga_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Control:
    """The plain reference with one guarantee broken, in the port's place."""

    def __init__(self, config: dict, device):
        self.ref = cells.reference_class(config)(config, device, control=True)

    def __getattr__(self, name):
        return lambda item: getattr(self.ref, name)([item])[0]


def _same(a, b) -> bool:
    return np.array_equal(np.asarray(a), np.asarray(b))


def check(kept, expected: dict) -> tuple[int, int]:
    """(answers compared, answers wrong), each answer whole."""
    wrong = sum(not _same(answer, expected[k]) for k, answer in kept)
    return len(kept), wrong


def _loop(system, call, pool, seconds, keep, span):
    """The closed loop: one caller, the next call when the last returned."""
    lat, kept, failures = [], [], []
    done_bytes = out_bytes = calls = 0
    items, nbytes = pool.items, pool.nbytes
    perf = time.perf_counter
    start = perf()
    deadline = start + seconds
    while perf() < deadline:
        k = calls % len(items)
        t = perf()
        try:
            with span():
                answer = port.call(system, call, items[k])
        except Exception as e:  # a failed call is counted, and the run goes on
            failures.append(repr(e))
        else:
            lat.append(perf() - t)
            done_bytes += nbytes[k]
            out_bytes += port.answer_bytes(answer)
            if keep[calls % len(keep)]:
                kept.append((k, answer))
        calls += 1
    return dict(lat=lat, kept=kept, failures=failures, calls=calls,
                bytes=done_bytes, out_bytes=out_bytes, window_s=perf() - start)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float | None = None,
             system: str = "port", overrides: dict | None = None) -> dict:
    """One run; returns the result line as a dict (``checks`` last).
    ``system="control"`` puts the reference's control in the port's place;
    ``overrides`` replace keys of the traffic mix (smaller sizes in tests)."""
    import torch

    t0 = T0 if t0 is None else t0
    cell = cells.load(workload)
    traffic = dict(cell.traffic, **(overrides or {}))
    call = traffic["call"]
    cuda = torch.device(device).type == "cuda"

    pool = gen.make_pool(traffic, cell.config, seed, device)
    if cuda:  # the peak is the port's: the generator's scratch is freed
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    if system == "control":  # not timed: no warm-up
        sut = Control(cell.config, device)
    else:
        sut = port.build(cell.config, device)
        for item in pool.items:  # warm-up: every request once
            port.call(sut, call, item)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # the answers held to the reference: the first pass over the pool, and
    # a share of the later calls drawn from the seed
    keep = np.random.default_rng([seed, 1]).random(1 << 16) < traffic["check_share"]
    keep[:len(pool)] = True
    name = f"api.{type(sut).__name__}.{call}"
    tr = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            with record_function(tracing.WINDOW_SPAN):
                run = _loop(sut, call, pool, min(seconds, TRACE_SECONDS), keep,
                            lambda: record_function(name))
            if cuda:
                torch.cuda.synchronize()
        events = tracing.capture(prof)
        w0, w1 = tracing.window(events)
        tr = tracing.Trace(events, w0, w1, len(run["lat"]), run["bytes"],
                           run["out_bytes"])
    else:
        run = _loop(sut, call, pool, seconds, keep, contextlib.nullcontext)
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    del sut
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = cells.reference_class(cell.config)(cell.config, device)
    need = sorted({k for k, _ in run["kept"]})
    expected = dict(zip(need, getattr(ref, call)([pool.items[k] for k in need])))
    checked, wrong = check(run["kept"], expected)

    lat_ms = np.asarray(run["lat"]) * 1e3
    e2e = {
        "setup_s": setup_s,
        "scan_GBps": run["bytes"] / run["window_s"] / 1e9,
        "call_p95_ms": float(np.percentile(lat_ms, 95)) if len(lat_ms) else None,
    }
    metrics = {}
    if tr is None:
        for m in cell.end_to_end:
            if e2e[m["name"]] is not None:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            value = cells.metric_reader(m["name"])(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    checks = {
        "wrong_answers": {"value": wrong, "limit": LIMITS["wrong_answers"]},
        "failed_calls": {"value": len(run["failures"]),
                         "limit": LIMITS["failed_calls"]},
        "answers_checked": {"value": checked, "at_least": 1},
    }
    result = {
        "correct": bool(checked >= 1 and all(
            checks[k]["value"] <= lim for k, lim in LIMITS.items())),
        "attempted": run["calls"],
        "failed": len(run["failures"]),
        "metrics": metrics,
        "device": dev,
    }
    if tr is not None:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        result["breakdown"] = tracing.breakdown(tr)
    result["checks"] = checks
    result["_info"] = {
        "calls": len(lat_ms),
        "call_median_ms": float(np.median(lat_ms)) if len(lat_ms) else None,
        "window_s": run["window_s"], "bytes": run["bytes"],
        "failures": run["failures"][:3],
    }
    # the last step: whatever the run loaded, the reference and the readers
    # too, is in sys.modules by now
    loaded = forbidden_modules()
    if loaded:
        raise SystemExit(f"forbidden modules loaded: {', '.join(loaded)}")
    return result


def emit(result: dict) -> None:
    """Standard error's last lines: what was compared, beside its limit;
    standard output's last line: the result, ``checks`` its last key."""
    info = result.pop("_info")
    print(f"calls {info['calls']} in {info['window_s']:.3f} s, median "
          f"{info['call_median_ms']} ms; bytes {info['bytes']}", file=sys.stderr)
    for f in info["failures"]:
        print(f"failed call: {f}", file=sys.stderr)
    for k, v in result["checks"].items():
        bound = (f"limit {v['limit']}" if "limit" in v
                 else f"at least {v['at_least']}")
        print(f"{k} {v['value']} {bound}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    chips = cells.load(args.workload).chips

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    emit(run_cell(args.workload, args.seed, args.seconds, bool(args.trace)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
