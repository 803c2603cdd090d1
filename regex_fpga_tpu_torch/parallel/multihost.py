"""Process groups: the counterpart of ``regex_fpga_tpu/parallel/multihost.py``.

A multi-process run is: ``init_distributed()`` in every process (one process
a card, started by ``torchrun``), one global (data, seq) mesh over all
ranks, per-host file shards feeding the local ranks
(``ingest.shard_files``), and the collectives of ``dist_scan``. A single
process is the same program with a world size of 1.

``spawn_ranks`` starts ranks on one machine without ``torchrun``, on the card
unless the caller asks for the CPU: the tests run gloo ranks on the CPU with
it (``device="cpu"``), and ``graft_entry.dryrun_multichip`` and
``chip_smoke.py`` use it for several ranks. Its rendezvous is a file in a
temporary directory, so it needs no network.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import shutil
import tempfile
import traceback

import torch
import torch.distributed as dist

from ..ops.tables import resolve_device
from .mesh import make_mesh

__all__ = ["HostTopology", "global_mesh", "init_distributed", "spawn_ranks"]


@dataclasses.dataclass(frozen=True)
class HostTopology:
    host_index: int
    host_count: int
    local_devices: int
    global_devices: int


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def init_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device=None,
) -> HostTopology:
    """Initialise ``torch.distributed`` from the arguments or torchrun's
    variables (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``). NCCL on ``cuda:LOCAL_RANK`` unless ``device="cpu"``
    asks for gloo. A no-op for one process, and for a process whose group
    is already initialised."""
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        if coordinator is None and "MASTER_ADDR" in os.environ:
            coordinator = (f"{os.environ['MASTER_ADDR']}:"
                           f"{os.environ.get('MASTER_PORT', '29500')}")
        world = num_processes or _env_int("WORLD_SIZE", 1)
        rank = process_id if process_id is not None else _env_int("RANK", 0)
        if world > 1:
            if coordinator is None:
                raise ValueError("a run of several processes needs the "
                                 "coordinator's address (MASTER_ADDR)")
            cpu = device is not None and torch.device(device).type == "cpu"
            if not cpu:
                torch.cuda.set_device(_env_int("LOCAL_RANK", 0))
            dist.init_process_group("gloo" if cpu else "nccl",
                                    init_method=f"tcp://{coordinator}",
                                    world_size=world, rank=rank)
    return HostTopology(host_index=rank, host_count=world,
                        local_devices=torch.cuda.device_count(),
                        global_devices=world)


def global_mesh(n_seq: int = 1):
    """(data, seq) mesh over every rank of every host."""
    return make_mesh(n_seq=n_seq)


def _rank_main(rank, world, backend, device, store_path, results, fn, args):
    try:
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        else:
            torch.set_num_threads(1)
        store = dist.FileStore(store_path, world)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world)
        try:
            results.put((rank, True, fn(*args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn_ranks(fn, world_size: int, backend: str = "gloo", device=None,
                args: tuple = (), timeout: float = 600.0) -> list:
    """Run ``fn(*args)`` in ``world_size`` new processes (the ``spawn``
    start method), each a rank of one process group on ``backend``, with its
    tensors on ``device`` (default: the card; a CUDA rank takes card
    ``rank % device_count``; raises ``RuntimeError`` when no card is visible,
    and ``device="cpu"`` runs the ranks on the CPU).
    ``fn`` is a module-level function; it reads its rank from
    ``torch.distributed`` and returns a picklable value (numpy, not
    tensors). Returns the values in rank order. A rank that raises or dies
    stops the others, and the error is raised here."""
    device = resolve_device(device)
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="regex_ranks_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world_size, backend, str(device),
                               os.path.join(tmp, "store"), results, fn, args))
             for r in range(world_size)]
    out: dict = {}
    try:
        for p in procs:
            p.start()
        waited = 0.0
        while len(out) < world_size:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                waited += 1.0
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"a rank exited with code {dead[0]} "
                                       f"before it reported")
                if waited > timeout:
                    raise TimeoutError(f"ranks still running after {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world_size)]
