"""Chunked corpus ingest with checkpointed, fault-tolerant scanning.

The counterpart of ``regex_fpga_tpu/parallel/ingest.py``. The matcher state
between chunks is a small serializable carry (DFA: one state and a count a
stream), so recovery is "reload the last carry, rescan from that chunk".
Chunk scans that raise are retried; a persistent failure surfaces after
``max_retries``, and a deterministic one (``NonRetryableScanError``) at once.

``dist_resilient_scan`` feeds a distributed scan on the card: a prefetch
thread copies each chunk into one of ``prefetch_depth + 1`` pinned host
buffers and starts its upload on a side CUDA stream; the scan's stream waits
on the upload's event and maps the bytes to classes on the card (or feeds
the raw bytes to K3 where its maps fit), so the upload of chunk k+1 runs
during the scan of chunk k. A buffer is refilled only after its upload has
completed. On the CPU a chunk is a plain tensor.
"""

from __future__ import annotations

import dataclasses
import os
import time
import warnings
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from ..ops.tables import host_to_device
from .mesh import DATA_AXIS, SEQ_AXIS

__all__ = [
    "iter_file_chunks",
    "shard_files",
    "CheckpointStore",
    "NonRetryableScanError",
    "resilient_scan",
    "prefetch_chunks",
    "iter_batch_chunks",
    "dist_resilient_scan",
]


class NonRetryableScanError(RuntimeError):
    """A deterministic scan failure (e.g. seam fixpoint non-convergence):
    re-running the identical chunk cannot succeed, so ``resilient_scan``
    surfaces it immediately instead of burning retries."""


def prefetch_chunks(
    chunks: Iterable[tuple[int, np.ndarray]],
    prepare: Callable[[np.ndarray], object] | None = None,
    depth: int = 2,
) -> Iterator[tuple[int, object]]:
    """Overlap ingest with compute: a worker thread reads (and
    ``prepare``s) up to ``depth`` chunks ahead while the caller scans the
    current one. Order is preserved; a worker exception re-raises at the
    consumption point. A consumer that abandons the generator releases the
    worker (bounded puts with cancellation)."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    sentinel = object()
    failure: list[BaseException] = []
    stop = threading.Event()

    def worker():
        try:
            for off, chunk in chunks:
                item = (off, prepare(chunk) if prepare else chunk)
                # bounded put with cancellation: if the consumer abandoned
                # the generator, drop the prepared chunks instead of
                # blocking on a full queue forever
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # surfaced to the consumer below
            failure.append(e)
        finally:
            while True:  # same bounded put: never block on a gone consumer
                try:
                    q.put(sentinel, timeout=0.1)
                    break
                except queue.Full:
                    if stop.is_set():
                        break

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if failure:
                    raise failure[0]
                return
            yield item
    finally:
        stop.set()


def iter_file_chunks(
    path: str, chunk_bytes: int, offset: int = 0
) -> Iterator[tuple[int, np.ndarray]]:
    """Yield (offset, uint8 chunk) via mmap: no double buffering in RAM."""
    data = np.memmap(path, dtype=np.uint8, mode="r")
    for off in range(offset, len(data), chunk_bytes):
        yield off, np.asarray(data[off : off + chunk_bytes])


def shard_files(paths: list[str], host_index: int, host_count: int) -> list[str]:
    """Static per-host file sharding (round-robin by size rank)."""
    ranked = sorted(paths, key=lambda p: -os.path.getsize(p))
    return [p for i, p in enumerate(ranked) if i % host_count == host_index]


@dataclasses.dataclass
class CheckpointStore:
    """npz-on-disk checkpoint of a streaming scan carry."""

    path: str

    def save(self, carry: dict) -> None:
        tmp = self.path + ".tmp.npz"  # np.savez keeps names ending in .npz
        np.savez(tmp, **{k: v for k, v in carry.items() if v is not None})
        os.replace(tmp, self.path)

    def load(self) -> dict | None:
        if not os.path.exists(self.path):
            return None
        with np.load(self.path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}


def resilient_scan(
    scan_chunk: Callable[[object, dict | None], dict],
    chunks: Iterable[tuple[int, object]],
    store: CheckpointStore | None = None,
    max_retries: int = 3,
    retry_delay: float = 1.0,
    span: Callable[[object], int] | None = None,
) -> dict:
    """Run ``scan_chunk(chunk, carry) -> carry`` over chunks with retry and
    checkpointing. ``carry`` is a dict of numpy arrays / scalars that fully
    determines resumption.

    ``span(chunk)`` converts a chunk to its advance in the units of the
    iterable's offsets (default: the trailing axis' length)."""
    if span is None:
        span = lambda c: int(np.shape(c)[-1]) if np.ndim(c) else len(c)
    carry: dict | None = store.load() if store else None
    start_off = int(carry["offset"]) if carry and "offset" in carry else 0
    for off, chunk in chunks:
        if off < start_off:
            continue
        attempt = 0
        while True:
            try:
                carry = scan_chunk(chunk, carry)
                break
            except NonRetryableScanError:
                raise  # deterministic: an identical retry cannot succeed
            except Exception:
                attempt += 1
                if attempt > max_retries:
                    raise
                time.sleep(retry_delay * attempt)
        carry["offset"] = np.int64(off + span(chunk))
        if store:
            store.save(carry)
    return carry if carry is not None else {}


def iter_batch_chunks(
    data: np.ndarray, chunk_len: int, offset: int = 0
) -> Iterator[tuple[int, np.ndarray]]:
    """Yield (byte_offset, (BATCH, chunk_len) slab) slices of a (BATCH, L)
    corpus. ``offset`` counts per-stream bytes."""
    batch, l = data.shape
    assert l % chunk_len == 0, "corpus length must be divisible by chunk_len"
    for off in range(offset, l, chunk_len):
        yield off, np.ascontiguousarray(data[:, off : off + chunk_len])


class _LoadOnly(CheckpointStore):
    """A store that only loads: with several ranks, rank 0 writes."""

    def save(self, carry: dict) -> None:
        pass


class _PinnedUpload:
    """Chunks to the card through a ring of pinned host buffers and a side
    stream. Called on the prefetch thread; returns (device tensor, event of
    its upload)."""

    def __init__(self, device: torch.device, buffers: int):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.buffers: list = [None] * buffers
        self.events: list = [None] * buffers
        self.next = 0

    def __call__(self, slab: np.ndarray):
        i = self.next
        self.next = (i + 1) % len(self.buffers)
        if self.events[i] is not None:
            self.events[i].synchronize()  # its previous upload is done
        buf = self.buffers[i]
        if buf is None or buf.shape != slab.shape:
            buf = self.buffers[i] = torch.empty(slab.shape, dtype=torch.uint8,
                                                pin_memory=True)
        # torch's copy from the strided view: threads, and no GIL held
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*not writable.*")
            buf.copy_(torch.from_numpy(slab))
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            dev = buf.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        self.events[i] = event
        return dev, event


def _on_device(item, device: torch.device) -> torch.Tensor:
    """The consumer's side of a prepared chunk: a device tensor whose
    upload the current stream waits for."""
    data, event = item
    if event is not None:
        stream = torch.cuda.current_stream(device)
        stream.wait_event(event)
        data.record_stream(stream)  # allocated on the side stream
    return data


def dist_resilient_scan(
    mesh,
    tables,
    chunks: Iterable[tuple[int, np.ndarray]],
    *,
    kgram=None,
    blocks_per_shard: int = 8192,
    start: int = 0,
    max_iters: int = 16,
    overlap: int = 64,
    store: CheckpointStore | None = None,
    max_retries: int = 3,
    retry_delay: float = 1.0,
    prefetch_depth: int = 2,
) -> dict:
    """Chunked ingest into the distributed scan, with the carry across
    chunks, checkpointing and retry.

    ``chunks`` yields (offset, (BATCH, chunk_len) uint8 slabs), e.g.
    ``iter_batch_chunks``; BATCH divides over the mesh's data axis. Each
    rank uploads only its own shard of a slab (its rows, and its span of
    columns along seq) and scans it with ``dfa_scan_fast_dist`` (counting
    mode), or ``dfa_scan_kgram_dist`` when ``kgram`` (a ``KgramTables``) is
    given, each stream entering from its carried state. The carry
    (per-stream states, running totals, offset) is checkpointed through
    ``store`` after every chunk, so recovery replays from the last chunk
    boundary exactly. ``prefetch_depth`` chunks are prepared ahead on a
    thread (0: none, each chunk is prepared when it is scanned).

    Returns the final carry: {"states": (BATCH,), "counts": (BATCH,),
    "offset": scalar}. Raises ``NonRetryableScanError`` (a RuntimeError) if
    a chunk's seam fixpoint does not converge."""
    from ..ops.hopper_kgram import kgram_bytes_supported
    from ..ops.kgram import kgram_maps, map_kgram_classes, pack_ta
    from .dist_scan import (_data_rows, _fast_local, _gather_data, _kgram_local,
                            _seq_cols)

    dev = tables.device
    k, maps = 1, None
    if kgram is not None:
        k = kgram.k
        ta = pack_ta(torch.as_tensor(kgram.table, device=dev),
                     torch.as_tensor(kgram.acc_table, device=dev))
        maps = kgram_maps(kgram)
        if maps is not None:  # K3 maps the raw bytes itself where they fit
            maps = maps.to(dev)
            if not kgram_bytes_supported(ta, maps):
                maps = None
    class_lut = tables.class_of.to(torch.uint8)

    def shard(slab: np.ndarray) -> np.ndarray:
        """This rank's rows and its span of columns (whole k-gram steps)."""
        rows = _data_rows(mesh, slab.shape[0])
        cols = _seq_cols(mesh, slab.shape[1] // k, blocks_per_shard)
        return slab[rows, cols.start * k: cols.stop * k]  # a view

    if dev.type == "cuda":
        upload = _PinnedUpload(dev, prefetch_depth + 1)
        prepare = lambda slab: upload(shard(slab))
    else:
        prepare = lambda slab: (host_to_device(shard(slab), dev), None)

    def scan_chunk(item, carry):
        data = _on_device(item, dev)
        batch = data.shape[0] * mesh.shape[DATA_AXIS]
        if carry is None:
            carry = {"states": np.full(batch, start, np.int32),
                     "counts": np.zeros(batch, np.int64)}
        rows = _data_rows(mesh, batch)
        starts = torch.as_tensor(carry["states"][rows], device=dev)
        if kgram is not None:
            if maps is not None:
                src = data.reshape(data.shape[0], -1, k)
            else:  # rows are whole k-gram steps, so they map as one run
                src = map_kgram_classes(kgram, data.reshape(-1)) \
                    .reshape(data.shape[0], -1)
            finals, totals, converged = _kgram_local(
                mesh, ta, src, starts, blocks_per_shard, max_iters, overlap,
                maps)
        else:
            cls = torch.index_select(class_lut, 0, data.reshape(-1).int()) \
                .reshape(data.shape)
            finals, totals, converged = _fast_local(
                mesh, tables, cls, starts, blocks_per_shard, max_iters,
                overlap)
        if not converged:
            raise NonRetryableScanError(
                ("k-gram " if kgram is not None else "") + "seam fixpoint did "
                "not converge; use the exact associative engine for this "
                "automaton")
        finals = _gather_data(mesh, finals).cpu().numpy()
        totals = _gather_data(mesh, totals).cpu().numpy()
        return {"states": finals.astype(np.int32),
                "counts": carry["counts"] + totals}

    # the resume filter runs BEFORE the prefetch pipeline: chunks already
    # scanned must not pay the copy and the upload just to be skipped
    if store is not None:
        if torch.distributed.is_initialized() and torch.distributed.get_rank():
            store = _LoadOnly(store.path)  # every rank holds rank 0's carry
        loaded = store.load()
        if loaded and "offset" in loaded:
            start_off = int(loaded["offset"])
            chunks = ((off, c) for off, c in chunks if off >= start_off)

    n_seq = mesh.shape[SEQ_AXIS]
    prepared = (prefetch_chunks(chunks, prepare=prepare, depth=prefetch_depth)
                if prefetch_depth > 0
                else ((off, prepare(c)) for off, c in chunks))
    carry = resilient_scan(
        scan_chunk, prepared, store=store, max_retries=max_retries,
        retry_delay=retry_delay,
        # offsets are byte units of the whole stream: a rank holds 1/n_seq
        span=lambda item: int(item[0].shape[-1]) * n_seq,
    )
    if store is not None and torch.distributed.is_initialized():
        torch.distributed.barrier()  # rank 0's last checkpoint is written
    return carry
