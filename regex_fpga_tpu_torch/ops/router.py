"""Host-vs-device engine router for counting scans, priced for the H100.

The counterpart of ``regex_fpga_tpu/ops/router.py``, with its public names.
Two engines compute the same per-state histograms, bit for bit:

* **device**: the chunked fast engine (``ops.dfa_fast``) on the K1/K2
  kernels. A routed call pays a fixed cost (launches, syncs, the readback
  of the counts), the pageable upload and the byte-to-class map of every
  byte, the kernel at the rate of its table's route (``hopper_dfa.
  dfa_chain_route``: shared uint16, shared uint32 or global memory; without
  a card the engine is the plain version and this term is left out), and,
  for a batch, its stacking on the host and the (rows, S) histogram it
  reads back and corrects.
* **host**: the native multi-cursor walk (``native.dfa_scan_multi``, or
  ``dfa_scan_speculative`` for fewer than 4 streams), a fixed cost per
  native call, its walk rate, and its (rows, S) counts.

The JAX router priced the device by padded 128 x 128 MXU tiles, so its rate
fell with S. On the card a k=1 pass costs one dependent load a byte whatever
S is, and an API call is bound by its upload (a 64 MiB counting scan: 13 of
its 18 ms are the pageable copy, K2 under 0.1 ms; PERF.md section 5). The
crossover therefore lies in the call's fixed cost, its bytes and its rows,
not in S: small calls and large batches of short rows go to the host, large
scans stay on the device. The model reads the kernel's own route, so that it
prices what the engine runs. Every prior below was fitted by
``chip_smoke.py``'s phase 7 (``fit_priors``: 50 calls of 5 automata, 3
sizes and 4 batch shapes under both engines) on an NVIDIA H100 80GB HBM3 at
a 700 W power limit; PERF.md section 6 ("The router's priors") names the
run and lists a later run's refit beside them, and every run of the script
prints its own refit beside these.

As in JAX, the static priors can be replaced for the session by probes of
both engines (``probe_host``, ``probe_device``), which fire once when a
large call falls in the contested band. The device probe times one stream;
a batch keeps its stacking cost on top of the probed rate. A probe that
fails raises; the router routes to the host only when the walker is
available and the model says the host is faster, and a forced ``"host"``
without the walker raises.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import native

__all__ = [
    "DEVICE_BATCH_COPY_BPS",
    "DEVICE_CALL_S",
    "DEVICE_COPY_BPS",
    "DEVICE_MARGIN",
    "DEVICE_ROUTE_BPS",
    "DEVICE_ROW_S",
    "DEVICE_ROW_STATE_S",
    "HOST_CALL_S",
    "HOST_CORE_BPS",
    "HOST_MULTI_BPS",
    "HOST_ROW_S",
    "HOST_ROW_STATE_S",
    "HOST_SINGLE_BPS",
    "HOST_SPEC_CALL_S",
    "HOST_SPEC_MIN_BYTES",
    "PROBE_BAND",
    "PROBE_MIN_WORKLOAD",
    "choose_scan_backend",
    "device_count_bps",
    "device_route",
    "device_seconds",
    "host_count_bps",
    "host_seconds",
    "probe_device",
    "probe_host",
    "record_device_rate",
    "record_host_rate",
    "reset_session",
    "session_rates",
]

#: Fixed device seconds per routed counting call: the upload's and the
#: engine's launches, the syncs of the convergence check, the readback
#: (the median 4 KiB single-stream call).
DEVICE_CALL_S = 0.574e-3
#: Bytes per second of the pageable upload and the class map of one stream
#: (64 MiB single-stream calls, less the fixed cost and K2's time).
DEVICE_COPY_BPS = 6.47e9
#: The same for a batch of streams (2 or more), which the engine stacks or
#: concatenates on the host first (64 MiB in 4 and in 64 streams).
DEVICE_BATCH_COPY_BPS = 1.91e9
#: Bytes per second of K2 over one 64 MiB chunk at 65,536 lanes, by the
#: route of its table (chip_smoke.py phase 2: the tokenizer, the 300-keyword
#: Aho-Corasick automaton and a random (256, 1024) table). Replaces JAX's
#: ``DEVICE_TILE_BPS`` (a rate per MXU tile), which means nothing on the
#: card: a step there is one table load, from shared memory or, for the
#: largest tables, through the caches.
DEVICE_ROUTE_BPS = {
    "shared uint32": 924e9,
    "shared uint16": 503e9,
    "global": 130e9,
}
#: Device seconds per row of a batch, and per histogram entry (rows x S):
#: the row's upload and scatter, the int32 readback, the widening, the
#: stall correction and the host's sum (the Snort batch of 4,000 payloads
#: at S = 23 and at S = 4,008, less the per-byte terms).
DEVICE_ROW_S = 1.34e-6
DEVICE_ROW_STATE_S = 1.11e-8
#: Bytes per second of the speculative segmented walk of one stream, and of
#: the multi-cursor walk of 4 or more streams, on the host of the card, for
#: inputs the walk splits over its cores (2 MiB and more; 64 MiB calls) ...
HOST_SINGLE_BPS = 1.10e9
HOST_MULTI_BPS = 0.93e9
#: ... and on one core, below that (1 MiB single-stream calls, less
#: HOST_CALL_S).
HOST_CORE_BPS = 0.31e9
#: Host seconds per native walk call (the median 4 KiB single-stream call,
#: a serial walk) ...
HOST_CALL_S = 0.127e-3
#: ... and per speculative walk of one stream (``dfa_scan_speculative``,
#: below 4 streams, for streams of ``HOST_SPEC_MIN_BYTES`` and more): the
#: cut into 32 segments, the replay before each seam and two or more
#: multi-cursor calls: what the 256 KiB single-stream calls took beyond
#: their bytes at HOST_CORE_BPS (the median over the five automata, on the
#: same card; PERF.md section 6 names the run).
HOST_SPEC_CALL_S = 1.32e-3
#: Shorter streams walk serially: the speculative walk's 32 segments need
#: 4 x 64 bytes each (its defaults).
HOST_SPEC_MIN_BYTES = 32 * 4 * 64
#: Host seconds per row, and per counts entry (rows x S): the row's place
#: in the concatenation, zeroing and filling the (rows, S) int64 counts
#: (the Snort batch as above, less the walk).
HOST_ROW_S = 2.40e-6
HOST_ROW_STATE_S = 2.72e-9
#: Contested band of the modeled ratio host seconds / device seconds:
#: outside it the prior decides; inside it a large call probes both engines
#: once. Its edge is the 90th percentile of the model's error factor over
#: phase 7's cases. JAX's band was a range of S (200-1500); on the card S
#: does not move the crossover.
PROBE_BAND = (1 / 2.84, 2.84)
#: Probe only when at least this many bytes are at stake: below it a
#: mis-route in the band costs less than the probes themselves (they took
#: 0.29 s, in which the host walks 269 MB).
PROBE_MIN_WORKLOAD = 256 << 20
PROBE_HOST_BYTES = 16 << 20
PROBE_DEVICE_BYTES = 64 << 20   # EngineConfig.chunk_bytes' default
PROBE_DEVICE_BLOCKS = 65536     # EngineConfig.num_blocks' default
PROBE_MIN_BLOCK_BYTES = 64      # EngineConfig.min_block_bytes' default
PROBE_REPS = 3
#: Once probed, the device must be this much faster than the host inside
#: the band: the spread (max / min) of one call's host-clocked time from run
#: to run, the median over phase 7's cases and both engines.
DEVICE_MARGIN = 1.22

#: The session's measured rates: "host_multi_bps", "host_single_bps" and
#: one "device_bps:<route>" per probed route (one stream's rate, upload
#: included; a batch adds its stacking on top, ``_device_byte_s``).
_session: dict = {}


def session_rates() -> dict:
    """A copy of the session's measured rates."""
    return dict(_session)


def reset_session() -> None:
    _session.clear()


def device_route(num_states: int, num_classes: int) -> str | None:
    """Where K2 keeps the table of these shapes, from the kernel's own plan
    (``dfa_chain_route``), or None without a card: the device engine then
    runs the plain version, and the model prices the copy alone."""
    if not torch.cuda.is_available():
        return None
    from .hopper_dfa import dfa_chain_route

    return dfa_chain_route("counts", num_classes, num_states,
                           num_lanes=PROBE_DEVICE_BLOCKS)["table"]


def _device_key(route: str | None) -> str:
    return "device_bps" if route is None else f"device_bps:{route}"


def _device_byte_s(route: str | None, n_streams: int = 1) -> float:
    measured = _session.get(_device_key(route))
    if measured is not None:  # the probe times one stream, upload included
        one = 1.0 / measured
    else:
        one = 1.0 / DEVICE_COPY_BPS + (
            0.0 if route is None else 1.0 / DEVICE_ROUTE_BPS[route])
    if n_streams > 1:  # a batch is stacked or concatenated on the host first
        one += 1.0 / DEVICE_BATCH_COPY_BPS - 1.0 / DEVICE_COPY_BPS
    return one


def _host_bps(n_streams: int, workload_bytes: int | None = None) -> float:
    # the walk splits over cores what one native call takes: each stream
    # below 4 streams, the whole batch from 4 on
    if workload_bytes is not None and (
            workload_bytes // (n_streams if n_streams < 4 else 1)
            < native.THREAD_MIN_BYTES):
        return HOST_CORE_BPS
    if n_streams >= 4:
        return _session.get("host_multi_bps", HOST_MULTI_BPS)
    return _session.get("host_single_bps", HOST_SINGLE_BPS)


def device_seconds(num_states: int, num_classes: int, workload_bytes: int,
                   n_streams: int = 1) -> float:
    """Modeled seconds of a routed device counting call."""
    route = device_route(num_states, num_classes)
    rows = (n_streams * (DEVICE_ROW_S + num_states * DEVICE_ROW_STATE_S)
            if n_streams > 1 else 0.0)
    return (DEVICE_CALL_S + workload_bytes * _device_byte_s(route, n_streams)
            + rows)


def host_seconds(num_states: int, workload_bytes: int,
                 n_streams: int = 1) -> float:
    """Modeled seconds of the host walk of the same call: one multi-cursor
    call for 4 streams or more, else a walk a stream, speculative from
    ``HOST_SPEC_MIN_BYTES``."""
    if n_streams >= 4:
        calls = HOST_CALL_S
    else:
        spec = workload_bytes // max(n_streams, 1) >= HOST_SPEC_MIN_BYTES
        calls = n_streams * (HOST_SPEC_CALL_S if spec else HOST_CALL_S)
    return (calls + workload_bytes / _host_bps(n_streams, workload_bytes)
            + n_streams * (HOST_ROW_S + num_states * HOST_ROW_STATE_S))


def device_count_bps(num_states: int, num_classes: int,
                     workload_bytes: int | None = None,
                     n_streams: int = 1) -> float:
    """Modeled bytes per second of the device engine at (S, C): of a call
    of ``workload_bytes`` in ``n_streams`` rows, or, without a workload, of
    a large scan (the per-byte rate of the table's route)."""
    if workload_bytes is None:
        return 1.0 / _device_byte_s(device_route(num_states, num_classes))
    return workload_bytes / device_seconds(num_states, num_classes,
                                           workload_bytes, n_streams)


def host_count_bps(n_streams: int, workload_bytes: int | None = None,
                   num_states: int = 0) -> float:
    """Modeled bytes per second of the host walk: the multi-cursor rate for
    4 streams or more, the speculative single-stream rate below; of a call
    of ``workload_bytes``, or of a large scan without one. Session-measured
    when a probe has run."""
    if workload_bytes is None:
        return _host_bps(n_streams)
    return workload_bytes / host_seconds(num_states, workload_bytes,
                                         n_streams)


def record_device_rate(num_states: int, num_classes: int,
                       bytes_per_sec: float) -> None:
    """Fold an observed device rate of a large single-stream counting call
    at (S, C) into the session: it stands for every table of the same
    route, and a batch adds its stacking cost to it."""
    _session[_device_key(device_route(num_states, num_classes))] = float(
        bytes_per_sec)


def record_host_rate(n_streams: int, bytes_per_sec: float) -> None:
    key = "host_multi_bps" if n_streams >= 4 else "host_single_bps"
    _session[key] = float(bytes_per_sec)


def _median_seconds(run) -> float:
    run()  # warm: thread pool, tables in cache, kernels built
    ts = []
    for _ in range(PROBE_REPS):
        t0 = time.perf_counter()
        run()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def probe_host(tables, n_streams: int) -> float:
    """Time the native walker on a synthetic random stream (split into 16
    streams for 4 or more, the speculative walk below); cache and return its
    bytes per second."""
    key = "host_multi_bps" if n_streams >= 4 else "host_single_bps"
    if key in _session:
        return _session[key]
    tab = tables.table.cpu().numpy()
    cls = tables.class_of.cpu().numpy()
    acc = tables.accept.cpu().numpy()
    data = np.random.default_rng(0).integers(0, 256, PROBE_HOST_BYTES,
                                             dtype=np.uint8)
    if n_streams >= 4:
        parts = np.array_split(data, 16)
        run = lambda: native.dfa_scan_multi(tab, cls, acc, parts)
    else:
        run = lambda: native.dfa_scan_speculative(tab, cls, acc, data)
    bps = PROBE_HOST_BYTES / _median_seconds(run)
    _session[key] = bps
    return bps


def probe_device(tables, chunk_bytes: int | None = None,
                 num_blocks: int | None = None,
                 min_block_bytes: int | None = None) -> float:
    """Time what a routed device call pays for one chunk of the scan's own
    geometry, from host memory: the upload, the class map, the fast engine's
    counting passes and the readback of the counts. Caches the rate for the
    table's route and returns it in bytes per second."""
    from ..utils.config import shrink_blocks
    from .dfa_fast import dfa_scan_fast

    key = _device_key(device_route(tables.num_states, tables.num_classes))
    if key in _session:
        return _session[key]
    nbytes = chunk_bytes or PROBE_DEVICE_BYTES
    nb = shrink_blocks(nbytes, num_blocks or PROBE_DEVICE_BLOCKS,
                       min_block_bytes or PROBE_MIN_BLOCK_BYTES)
    raw = np.random.default_rng(0).integers(0, 256, nbytes, dtype=np.uint8)
    lut = tables.class_of.to(torch.uint8)
    dev = tables.table.device

    def run():
        data = torch.from_numpy(raw).to(dev)
        res = dfa_scan_fast(tables, torch.index_select(lut, 0, data.int()),
                            num_blocks=nb, emit="counts")
        return res.counts.cpu()

    bps = nbytes / _median_seconds(run)
    _session[key] = bps
    return bps


def choose_scan_backend(num_states: int, num_classes: int,
                        n_streams: int = 1, mode: str = "auto",
                        tables=None, workload_bytes: int | None = None,
                        chunk_bytes: int | None = None,
                        num_blocks: int | None = None,
                        min_block_bytes: int | None = None,
                        ) -> str:
    """``"device"`` or ``"host"`` for a counting scan.

    ``mode`` is ``EngineConfig.scan_backend``: "device" and "host" force (a
    forced "host" raises when the native walker is not available); "auto"
    compares the modeled seconds of the two engines for ``workload_bytes``
    in ``n_streams`` rows (without a workload: their rates on a large scan)
    and routes to the host only when the walker is available and faster.
    When ``tables`` is given, the call is large enough
    (``PROBE_MIN_WORKLOAD``) and the model's ratio falls in ``PROBE_BAND``,
    both engines are probed once for the session, and the device must then
    beat the host by ``DEVICE_MARGIN``."""
    if mode == "device":
        return "device"
    if mode == "host":
        if not native.available():
            raise RuntimeError("scan_backend='host' needs the native host "
                               "walker, and g++ is not available to build it")
        return "host"
    if mode != "auto":
        raise ValueError(f"scan_backend must be 'auto', 'device' or 'host', "
                         f"got {mode!r}")
    if not native.available():
        return "device"
    work = PROBE_DEVICE_BYTES if workload_bytes is None else workload_bytes

    def ratio() -> float:
        return (host_seconds(num_states, work, n_streams)
                / device_seconds(num_states, num_classes, work, n_streams))

    host_key = "host_multi_bps" if n_streams >= 4 else "host_single_bps"
    dev_key = _device_key(device_route(num_states, num_classes))
    in_band = PROBE_BAND[0] <= ratio() <= PROBE_BAND[1]
    if (tables is not None and in_band
            and (workload_bytes or 0) >= PROBE_MIN_WORKLOAD):
        if host_key not in _session:
            probe_host(tables, n_streams)
        if dev_key not in _session:
            probe_device(tables, chunk_bytes, num_blocks, min_block_bytes)
    r = ratio()
    if in_band and host_key in _session and dev_key in _session:
        return "device" if r >= DEVICE_MARGIN else "host"
    return "device" if r >= 1.0 else "host"
