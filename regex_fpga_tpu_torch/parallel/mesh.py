"""Mesh construction and the collectives of the distributed scans.

The counterpart of ``regex_fpga_tpu/parallel/mesh.py``. JAX drives every
device of a mesh from one process through ``shard_map``; here every rank of
``torch.distributed`` is a process with one device, and a ``Mesh`` is this
rank's view of a 2-D grid of ranks laid out row-major (rank = i * n1 + j):

- ``data``: independent byte streams / corpus shards,
- ``seq``: blocks of one stream spread over ranks, seams passed along,
- ``model``: the state dimension of a large NFA sharded over ranks
  (``tp_scan.py``).

Every collective of the scans goes through the helpers below: ``ring_shift``
(JAX's ``ppermute`` with the forward pairs i -> i + 1 mod n), ``all_reduce``
(a sum, ``psum``) and ``all_gather``, each over one axis of the mesh.
Inside a ``record_collectives()`` block each call is recorded with its
payload, so that the tests can hold the scans to ``comm_model``; outside
one nothing is kept.

Where the tensors go: on NCCL they stay on the card. Gloo takes host tensors
only, so a CUDA tensor is copied to host memory, exchanged and copied back
(``collective_route`` names the step). With no process group initialised the
world size is 1 and every collective is the identity.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple

import torch
import torch.distributed as dist

__all__ = ["DATA_AXIS", "MODEL_AXIS", "SEQ_AXIS", "Collective", "Mesh",
           "all_gather", "all_reduce", "collective_route", "make_mesh",
           "make_tp_mesh", "record_collectives", "ring_shift"]

DATA_AXIS = "data"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"


class Collective(NamedTuple):
    op: str            # "ring_shift", "all_reduce" or "all_gather"
    axis: str          # the mesh axis it ran over
    in_bytes: int      # payload this rank contributed
    out_bytes: int     # payload this rank received (all_gather: all members)


_LOG: list | None = None  # the innermost record_collectives() block's list


@contextlib.contextmanager
def record_collectives():
    """Yields a list that receives every collective issued in the block,
    in call order, as ``Collective`` tuples."""
    global _LOG
    outer, _LOG = _LOG, []
    try:
        yield _LOG
    finally:
        _LOG = outer


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a 2-D mesh of ranks."""

    axis_names: tuple[str, str]
    shape: dict           # axis name -> size, as JAX's ``mesh.shape``
    coords: dict          # axis name -> this rank's index along it
    groups: dict          # axis name -> (process group, its global ranks)
    backend: str | None   # "nccl", "gloo", or None with one process

    @property
    def size(self) -> int:
        a, b = self.axis_names
        return self.shape[a] * self.shape[b]


_GROUPS: dict = {}


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _build(names: tuple[str, str], n0: int, n1: int) -> Mesh:
    world, rank = _world()
    if n0 * n1 != world:
        raise ValueError(f"mesh {n0}x{n1} does not cover {world} ranks")
    rows = [[i * n1 + j for j in range(n1)] for i in range(n0)]
    cols = [[i * n1 + j for i in range(n0)] for j in range(n1)]
    i, j = divmod(rank, n1)
    groups = {names[0]: (None, cols[j]), names[1]: (None, rows[i])}
    backend = dist.get_backend() if dist.is_initialized() else None
    if world > 1:
        key = (names, n0, n1, id(dist.group.WORLD))
        if key not in _GROUPS:
            # every rank creates every group, in the same order
            made = {tuple(r): dist.new_group(r) for r in rows + cols}
            _GROUPS[key] = made
        made = _GROUPS[key]
        groups = {names[0]: (made[tuple(cols[j])], cols[j]),
                  names[1]: (made[tuple(rows[i])], rows[i])}
    return Mesh(names, {names[0]: n0, names[1]: n1},
                {names[0]: i, names[1]: j}, groups, backend)


def make_mesh(n_data: int | None = None, n_seq: int = 1) -> Mesh:
    """A (data, seq) mesh over every rank. Default: all ranks on data."""
    world, _ = _world()
    if n_data is None:
        n_data = world // n_seq
    return _build((DATA_AXIS, SEQ_AXIS), n_data, n_seq)


def make_tp_mesh(n_model: int | None = None, n_data: int = 1) -> Mesh:
    """A (data, model) mesh for state-sharded scans; default: all ranks on
    the model axis, which is innermost, as in JAX."""
    world, _ = _world()
    if n_model is None:
        n_model = world // n_data
    return _build((DATA_AXIS, MODEL_AXIS), n_data, n_model)


def collective_route(mesh: Mesh, device) -> str:
    """How a collective moves tensors of ``device`` on this mesh."""
    device = torch.device(device)
    if mesh.size == 1:
        return (f"one rank ({mesh.backend or 'no process group'}): every "
                f"collective is the identity")
    if mesh.backend == "nccl":
        return f"nccl on {device}"
    if device.type == "cuda":
        return "gloo through host memory (device -> host copy, exchange, " \
               "host -> device copy)"
    return "gloo on the host"


def _host(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The tensor the backend takes: gloo exchanges host tensors, and bools
    travel as bytes."""
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    if mesh.backend == "gloo" and x.device.type != "cpu":
        return x.cpu()
    return x.contiguous()


def _record(op, axis, x, out_bytes) -> None:
    if _LOG is not None:
        _LOG.append(Collective(op, axis, x.numel() * x.element_size(),
                               out_bytes))


def ring_shift(mesh: Mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """Rank i along ``axis`` receives rank i-1's ``x`` (cyclically)."""
    group, ranks = mesh.groups[axis]
    n = len(ranks)
    out = x
    if n > 1:
        i = mesh.coords[axis]
        send = _host(mesh, x)
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send, ranks[(i + 1) % n], group),
               dist.P2POp(dist.irecv, recv, ranks[(i - 1) % n], group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        out = recv.to(x.device, x.dtype)
    _record("ring_shift", axis, x, x.numel() * x.element_size())
    return out


def all_reduce(mesh: Mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over ``axis``, written into ``x`` and returned."""
    group, ranks = mesh.groups[axis]
    if len(ranks) > 1:
        buf = _host(mesh, x)
        dist.all_reduce(buf, group=group)
        if buf is not x:
            x.copy_(buf)
    _record("all_reduce", axis, x, x.numel() * x.element_size())
    return x


def all_gather(mesh: Mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """(n, *x.shape): every member's ``x`` along ``axis``, in axis order."""
    group, ranks = mesh.groups[axis]
    if len(ranks) > 1:
        buf = _host(mesh, x)
        parts = [torch.empty_like(buf) for _ in ranks]
        dist.all_gather(parts, buf, group=group)
        out = torch.stack(parts).to(x.device, x.dtype)
    else:
        out = x[None]
    _record("all_gather", axis, x, out.numel() * out.element_size())
    return out
