"""Profiling and tracing helpers on ``torch.profiler``.

The counterpart of ``regex_fpga_tpu/utils/profiling.py``, with the same
signatures: ``profile_to`` writes a trace of the host and the card,
``trace`` names a region in it, ``throughput_probe`` measures bytes per
second around device work.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["trace", "profile_to", "throughput_probe"]


@contextlib.contextmanager
def profile_to(logdir: str):
    """Capture a ``torch.profiler`` trace of the block, host and (where
    there is one) CUDA activity, into ``logdir`` as a Chrome trace (view it
    in Perfetto or ``chrome://tracing``)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield logdir
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


#: what ``trace`` hands back while no profiler records: shared, reentrant
_OFF = contextlib.nullcontext()


def trace(name: str):
    """A named span in the profiler's timeline: a
    ``torch.profiler.record_function`` while a profiler session records
    (its Chrome trace shows it as a ``user_annotation`` event on the host
    clock of the CUDA runtime calls, which the device events' correlation
    ids tie to the card's work; under
    ``torch.autograd.profiler.emit_nvtx`` it is an NVTX range), else a
    shared null context, so a span off costs one check. Spans nest on the
    caller's thread: a span's parent is the span that encloses it."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


class throughput_probe:
    """Sustained bytes per second around device work.

    PyTorch returns before the card has finished, so pass the result of the
    work to ``stop``: it waits for the device that result lies on before the
    clock is read."""

    def __init__(self, nbytes: int):
        self.nbytes = nbytes

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def stop(self, force_result=None) -> float:
        if isinstance(force_result, torch.Tensor) and force_result.is_cuda:
            torch.cuda.synchronize(force_result.device)
        self.seconds = time.perf_counter() - self.t0
        self.bytes_per_second = self.nbytes / self.seconds
        return self.bytes_per_second

    def __exit__(self, *exc):
        if not hasattr(self, "seconds"):
            self.stop()
