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


@contextlib.contextmanager
def trace(name: str):
    """A named region in the profiler's timeline
    (``torch.profiler.record_function``) and, where a CUDA card is visible,
    an NVTX range of the same name."""
    cuda = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if cuda:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if cuda:
                torch.cuda.nvtx.range_pop()


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
