"""K1, K2 and K6: the DFA chain passes on Hopper, with their plain versions.

``dfa_chain`` (K1) runs NB independent chains, ``state <- T[class, state]``
per step, and returns the final states and, by mode, the state before each
step and its accept bit. ``dfa_chain_counts`` (K2) runs the same chains and
returns the final states and the accept-visit histogram, per state or per
stream and state. The kernels are ``csrc/dfa_chain.cu``; they replace the TPU
kernels ``regex_fpga_tpu/ops/pallas_dfa.py::_kernel`` and ``::_counts_kernel``.
``dfa_block_fns`` (K6, pass 1 of the exact fallback) runs every block of a
stream from every start state and returns the blocks' transition functions,
merging the chains of a block that meet; ``dfa_fn_combine`` (K6's combine)
turns them into every block's entry state. Their kernels are
``csrc/dfa_block_fns.cu``; they replace the XLA region
``regex_fpga_tpu/ops/dfa_engine.py::block_transition_functions`` and
``::block_entry_states``.

Layout: ``cls_seq`` is (B, NB), one column per lane, as in the JAX engines.
Its storage may be either order: a ``blocks.T`` view of a block-major (NB, B)
stream is read in place, and the full/mask outputs are then stored
block-major too, so ``states.T.reshape(-1)`` is the stream order without a
copy. A view with neither stride 1 is made contiguous first.

A wrapper launches its kernel for CUDA tensors and takes the plain version
only for CPU tensors. Out-of-range states and classes step to state 0 and
never accept, in both versions, as the JAX engines' one-hot lookup does.
The combine is the exception: it requires its input in range
(``dfa_fn_combine``, ``check_fn_range``).
"""

from __future__ import annotations

import weakref

import torch

from .. import _build

__all__ = [
    "LAUNCHES",
    "check_fn_range",
    "dfa_block_fns",
    "dfa_block_fns_plain",
    "dfa_block_fns_route",
    "dfa_chain",
    "dfa_chain_counts",
    "dfa_chain_plain",
    "dfa_chain_counts_plain",
    "dfa_chain_route",
    "dfa_fn_combine",
    "dfa_fn_combine_plain",
]

#: Kernel launches since the last reset, one count per kernel.
LAUNCHES = {"dfa_chain": 0, "dfa_chain_counts": 0, "dfa_block_fns": 0,
            "dfa_fn_combine": 0}

MODES = ("finals", "full", "mask")
_CLASS_DTYPES = {torch.uint8: 1, torch.int16: 2, torch.int32: 4}


def _check_args(table, accept, cls_seq, entries) -> tuple[int, int]:
    """Validate a chain pass's inputs; returns (B, NB)."""
    dev = cls_seq.device
    for name, t in (("table", table), ("accept", accept), ("entries", entries)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, cls_seq on {dev}")
    if cls_seq.dim() != 2:
        raise ValueError(f"cls_seq must be 2-D (B, NB), got {tuple(cls_seq.shape)}")
    if cls_seq.dtype not in _CLASS_DTYPES:
        raise TypeError(f"class ids must be uint8, int16 or int32, got {cls_seq.dtype}")
    if table.dim() != 2 or table.dtype != torch.int32:
        raise TypeError("table must be a (C, S) int32 tensor")
    c, s = table.shape
    if accept.shape != (s,) or accept.dtype != torch.bool:
        raise TypeError(f"accept must be a ({s},) bool tensor")
    b, nb = cls_seq.shape
    if entries.shape != (nb,) or entries.dtype != torch.int32:
        raise TypeError(f"entries must be a ({nb},) int32 tensor")
    if c * s >= 1 << 31 or b >= 1 << 31 or nb >= 1 << 31:
        raise ValueError("table, steps and lanes must each stay below 2^31")
    return b, nb


def _device_args(table, accept, cls_seq, entries):
    """Contiguous tables, and class ids with one stride 1 (the kernel
    stages rows along the contiguous axis)."""
    if 1 not in cls_seq.stride():
        cls_seq = cls_seq.contiguous()
    return table.contiguous(), accept.contiguous(), cls_seq, entries.contiguous()


def _like(cls_seq: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An uninitialised (B, NB) tensor stored in the same order as cls_seq."""
    b, nb = cls_seq.shape
    if cls_seq.stride(0) < cls_seq.stride(1):  # block-major storage
        return torch.empty((nb, b), dtype=dtype, device=cls_seq.device).T
    return torch.empty((b, nb), dtype=dtype, device=cls_seq.device)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {t.device}")


def dfa_chain(table, accept, cls_seq, entries, mode: str = "finals"):
    """K1. Returns (finals (NB,) int32, states (B, NB) int32 or None,
    acc (B, NB) bool or None): ``mode`` "finals" returns finals only,
    "full" all three, "mask" finals and acc."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    b, nb = _check_args(table, accept, cls_seq, entries)
    if cls_seq.device.type == "cpu":
        return dfa_chain_plain(table, accept, cls_seq, entries, mode)
    _require_cuda(cls_seq)
    table, accept, cls_seq, entries = _device_args(table, accept, cls_seq,
                                                   entries)
    c, s = table.shape
    finals = torch.empty(nb, dtype=torch.int32, device=cls_seq.device)
    states = _like(cls_seq, torch.int32) if mode == "full" else None
    acc = _like(cls_seq, torch.bool) if mode != "finals" else None
    out = states if states is not None else acc
    out_ls, out_ss = (out.stride(1), out.stride(0)) if out is not None else (0, 0)
    LAUNCHES["dfa_chain"] += 1
    with torch.cuda.device(cls_seq.device):
        rc = _build.library().dfa_chain(
            cls_seq.data_ptr(), _CLASS_DTYPES[cls_seq.dtype],
            cls_seq.stride(1), cls_seq.stride(0),
            table.data_ptr(), accept.data_ptr(), c, s,
            entries.data_ptr(), nb, b, finals.data_ptr(),
            states.data_ptr() if states is not None else None,
            acc.data_ptr() if acc is not None else None,
            out_ls, out_ss, _stream(cls_seq.device),
        )
    _build.check(rc, "dfa_chain")
    return finals, states, acc


def dfa_chain_counts(table, accept, cls_seq, entries,
                     num_streams: int | None = None):
    """K2. Returns (finals (NB,) int32, counts int32): counts[s] is the
    number of steps taken from state s when s accepts (visits * accept).
    With ``num_streams`` N, lanes are grouped stream-major (NB/N lanes per
    stream) and counts is (N, S); without it counts is (S,)."""
    b, nb = _check_args(table, accept, cls_seq, entries)
    n = 1 if num_streams is None else num_streams
    if n < 1 or nb % n:
        raise ValueError(f"{nb} lanes do not split into {n} streams")
    if cls_seq.device.type == "cpu":
        return dfa_chain_counts_plain(table, accept, cls_seq, entries, num_streams)
    _require_cuda(cls_seq)
    table, accept, cls_seq, entries = _device_args(table, accept, cls_seq,
                                                   entries)
    c, s = table.shape
    finals = torch.empty(nb, dtype=torch.int32, device=cls_seq.device)
    counts = torch.zeros((n, s), dtype=torch.int32, device=cls_seq.device)
    LAUNCHES["dfa_chain_counts"] += 1
    with torch.cuda.device(cls_seq.device):
        rc = _build.library().dfa_chain_counts(
            cls_seq.data_ptr(), _CLASS_DTYPES[cls_seq.dtype],
            cls_seq.stride(1), cls_seq.stride(0),
            table.data_ptr(), accept.data_ptr(), c, s,
            entries.data_ptr(), nb, b, finals.data_ptr(),
            counts.data_ptr(), max(nb // n, 1), _stream(cls_seq.device),
        )
    _build.check(rc, "dfa_chain_counts")
    return finals, (counts if num_streams is not None else counts[0])


def dfa_chain_route(mode: str, num_classes: int, num_states: int,
                    num_lanes: int = 1, num_streams: int = 1,
                    class_dtype: torch.dtype = torch.uint8) -> dict:
    """Where the kernel keeps its data for these shapes on the current card:
    {"table": "shared uint16" | "shared uint32" | "global", "table_smem":
    bool, "accept_folded": bool (the accept bit rides in the table entry: one
    load per step), "hist": "lane rows" | "stream rows" | "global" (counts
    mode), "hist_smem": bool, "ring": windows in the staging ring,
    "lanes_per_cta": int}."""
    code = {"finals": 0, "full": 1, "mask": 2, "counts": 3}[mode]
    lib = _build.library()
    r = lib.dfa_chain_route(code, _CLASS_DTYPES[class_dtype], num_classes,
                            num_states, num_lanes,
                            max(num_lanes // num_streams, 1))
    table = ("global", "shared uint32", "shared uint16")[r & 3]
    hist = ("global", "stream rows", "lane rows")[(r >> 2) & 3]
    return {"table": table, "table_smem": table != "global",
            "accept_folded": table != "global" and mode != "finals",
            "hist": hist, "hist_smem": hist != "global", "ring": r >> 4,
            "lanes_per_cta": lib.dfa_chain_lanes_per_cta()}


_CHECKED_TABLES: dict = {}  # id -> (weak reference, version) of tables in range


def _check_table_range(table) -> None:
    """Raise if ``table`` holds a state id outside [0, S). The check waits
    for the device, so a table tensor is checked once and again only after
    an in-place change (its version counter moves)."""
    seen = _CHECKED_TABLES.get(id(table))
    if seen is not None and seen[0]() is table and seen[1] == table._version:
        return
    if bool(((table < 0) | (table >= table.shape[1])).any()):
        raise ValueError("table holds state ids outside [0, S): corrupt table")
    key = id(table)
    _CHECKED_TABLES[key] = (weakref.ref(table, lambda _: _CHECKED_TABLES.pop(key, None)),
                            table._version)


def dfa_block_fns(table, classes):
    """K6, pass 1 of the exact fallback. ``classes`` is (NB, B): the class
    ids of NB blocks of B bytes. Returns (NB, S) int32: f[n, s] is the state
    after block n when it is entered in state s. A class outside [0, C)
    steps to state 0, as in ``dfa_chain``; a table entry outside [0, S)
    raises. On the card the class ids must be uint8 (C <= 256 always)."""
    if classes.device != table.device:
        raise ValueError(f"table is on {table.device}, classes on {classes.device}")
    if classes.dim() != 2 or classes.dtype not in _CLASS_DTYPES:
        raise TypeError("classes must be a (NB, B) uint8, int16 or int32 tensor")
    if table.dim() != 2 or table.dtype != torch.int32:
        raise TypeError("table must be a (C, S) int32 tensor")
    c, s = table.shape
    nb, b = classes.shape
    if c * s >= 1 << 31 or nb * s >= 1 << 31:
        raise ValueError("table and output must each stay below 2^31 entries")
    _check_table_range(table)
    if classes.device.type == "cpu":
        return dfa_block_fns_plain(table, classes)
    _require_cuda(classes)
    if classes.dtype != torch.uint8 or c > 256:
        raise TypeError("the kernel takes uint8 class ids of at most 256 classes")
    classes, table = classes.contiguous(), table.contiguous()
    out = torch.empty((nb, s), dtype=torch.int32, device=classes.device)
    LAUNCHES["dfa_block_fns"] += 1
    with torch.cuda.device(classes.device):
        rc = _build.library().dfa_block_fns(
            classes.data_ptr(), table.data_ptr(), c, s, nb, b, out.data_ptr(),
            _stream(classes.device))
    _build.check(rc, "dfa_block_fns")
    return out


def dfa_block_fns_route(num_classes: int, num_states: int, num_blocks: int,
                        block_size: int = 1024) -> dict:
    """The route K6 pass 1 takes for these shapes on the current card:
    {"route": "block a thread" (S <= 32: a thread carries a block's S chains)
    | "block a warp" (a warp walks a block, chains that meet merge),
    "table": "shared uint16" | "shared uint32" | "global", "chains_per_lane":
    the chains a lane carries before any merge (on the warp route of a pass
    of at most 1,024 start states), "merge_checks": the checks a block (0:
    no merging), "packed": whether blocks left with at most 4 chains at
    the first check walk on 32 to a warp, a lane each, "blocks_per_cta": the
    blocks a CTA walks at once (packed ones counted)}."""
    r = _build.library().dfa_block_fns_route(num_classes, num_states,
                                             num_blocks, block_size)
    return {"route": ("block a thread", "block a warp")[(r >> 2) & 1],
            "table": ("global", "shared uint32", "shared uint16")[r & 3],
            "chains_per_lane": (r >> 3) & 63, "merge_checks": (r >> 9) & 31,
            "packed": bool((r >> 14) & 1), "blocks_per_cta": r >> 15}


def _check_combine_args(fns, start) -> None:
    """What the combine checks without reading the device: the functions'
    shape and dtype, the start's form, an int start's range."""
    if fns.dim() != 2 or fns.dtype != torch.int32:
        raise TypeError("block functions must be an (NB, S) int32 tensor")
    nb, s = fns.shape
    if nb < 1 or s < 1:
        raise ValueError(f"no block functions to combine: shape {tuple(fns.shape)}")
    if nb * s >= 1 << 31:
        raise ValueError("block functions must stay below 2^31 entries")
    if isinstance(start, torch.Tensor):
        if start.numel() != 1 or start.device != fns.device:
            raise ValueError("start must be one element on the functions' device")
    elif not 0 <= int(start) < s:
        raise ValueError(f"start state {start} outside [0, {s})")


def check_fn_range(fns, start=0) -> None:
    """The combine's precondition, checked: every entry of ``fns`` (NB, S)
    and ``start`` lie in [0, S), else ``ValueError``. One ``aminmax`` over
    the functions and one host read of it with the start, so on the card
    it waits for the device."""
    _check_combine_args(fns, start)
    s = fns.shape[1]
    lo, hi = torch.aminmax(fns)
    vals = [lo.reshape(1), hi.reshape(1)]
    if isinstance(start, torch.Tensor):
        vals.append(start.reshape(1).to(torch.int32))
    vals = torch.cat(vals).tolist()
    if isinstance(start, torch.Tensor) and not 0 <= vals[2] < s:
        raise ValueError(f"start state {vals[2]} outside [0, {s})")
    if vals[0] < 0 or vals[1] >= s:
        raise ValueError(f"block function entries span [{vals[0]}, {vals[1]}],"
                         f" outside [0, {s})")


def dfa_fn_combine(fns, start=0):
    """K6's combine. ``fns`` is (NB, S) int32 block functions (NB >= 1),
    ``start`` an int in [0, S) or a one-element int32 tensor on their
    device. Returns (entry (NB,) int32, final () int32): entry[n] is the
    state in which block n is entered when the stream starts in ``start``,
    final the state after the last block.

    Contract, on both devices: every entry of ``fns`` and ``start`` lie in
    [0, S). Pass 1 (``dfa_block_fns``) writes no other entry, so
    ``dfa_scan_blocked`` combines its functions unchecked and never waits
    for the device here; functions built elsewhere go through
    ``dfa_engine.block_entry_states``, which checks them with
    ``check_fn_range`` first. The wrapper checks what needs no device read
    (shape, dtype, an int start). Out of range, the result is not defined:
    the kernel does not look (it reads such an entry as state 0), and the
    plain version raises ``check_fn_range``'s ``ValueError``, a check that
    costs the CPU no wait."""
    _check_combine_args(fns, start)
    nb, s = fns.shape
    if fns.device.type == "cpu":
        return dfa_fn_combine_plain(fns, start)
    _require_cuda(fns)
    dev = fns.device
    fns = fns.contiguous()
    first = torch.as_tensor(start, dtype=torch.int32, device=dev).reshape(1)
    entry = torch.empty(nb, dtype=torch.int32, device=dev)
    final = torch.empty(1, dtype=torch.int32, device=dev)
    lib = _build.library()
    scratch = torch.empty(lib.dfa_fn_combine_scratch(nb, s), dtype=torch.int32,
                          device=dev)
    bar = torch.zeros(1, dtype=torch.int32, device=dev)
    LAUNCHES["dfa_fn_combine"] += 1
    with torch.cuda.device(dev):
        rc = lib.dfa_fn_combine(fns.data_ptr(), nb, s, first.data_ptr(),
                                entry.data_ptr(), final.data_ptr(),
                                scratch.data_ptr(), bar.data_ptr(), _stream(dev))
    _build.check(rc, "dfa_fn_combine")
    return entry, final.reshape(())


# --------------------------------------------------------------- plain versions


def dfa_fn_combine_plain(fns, start=0):
    """Plain-torch combine: an exclusive prefix composition of the block
    functions by log-depth doubling (a gather and a copy of every function
    a round), then the column of ``start``. Its contract is
    ``dfa_fn_combine``'s; it checks the range with ``check_fn_range``."""
    check_fn_range(fns, start)
    prefix = fns
    n = prefix.shape[0]
    d = 1
    while d < n:  # prefix[i] = fns[i] after ... after fns[max(0, i - 2d + 1)]
        prefix = torch.cat([prefix[:d],
                            torch.gather(prefix[d:], 1, prefix[:-d].long())])
        d *= 2
    first = torch.as_tensor(start, dtype=torch.int32,
                            device=fns.device).reshape(1)
    col = torch.index_select(prefix, 1, first).reshape(-1).to(torch.int32)
    return torch.cat([first, col[:-1]]), col[-1]


def dfa_block_fns_plain(table, classes):
    """Plain-torch K6 pass 1: all S start states of every block as one
    (NB, S) tensor, one gather per byte."""
    nb, b = classes.shape
    c_dim, s_dim = table.shape
    flat = table.reshape(-1)
    states = torch.arange(s_dim, dtype=torch.int32, device=classes.device)
    states = states.expand(nb, s_dim)
    for t in range(b):
        states = _step(flat, c_dim, s_dim, states,
                       classes[:, t:t + 1].long()).to(torch.int32)
    return states


def _step(flat, c_dim: int, s_dim: int, state, cls):
    """One step of every lane: T[cls, state], or 0 out of range."""
    ok = (state >= 0) & (state < s_dim) & (cls >= 0) & (cls < c_dim)
    idx = torch.where(ok, cls * s_dim + state, 0)
    return torch.where(ok, torch.take(flat, idx), 0)


def _accepts(accept, s_dim: int, state):
    ok = (state >= 0) & (state < s_dim)
    return ok & torch.take(accept, torch.where(ok, state, 0).long())


def dfa_chain_plain(table, accept, cls_seq, entries, mode: str = "finals"):
    """Plain-torch K1: one loop iteration and a gather per step."""
    b, nb = cls_seq.shape
    c_dim, s_dim = table.shape
    flat = table.reshape(-1)
    state = entries.to(torch.int32)
    dev = cls_seq.device
    states = (torch.empty((b, nb), dtype=torch.int32, device=dev)
              if mode == "full" else None)
    acc = (torch.empty((b, nb), dtype=torch.bool, device=dev)
           if mode != "finals" else None)
    for t in range(b):
        if states is not None:
            states[t] = state
        if acc is not None:
            acc[t] = _accepts(accept, s_dim, state)
        state = _step(flat, c_dim, s_dim, state, cls_seq[t].long()).to(torch.int32)
    return state, states, acc


def dfa_chain_counts_plain(table, accept, cls_seq, entries,
                           num_streams: int | None = None):
    """Plain-torch K2: per-step accept visits added into an (N*S,) count."""
    b, nb = cls_seq.shape
    c_dim, s_dim = table.shape
    n = 1 if num_streams is None else num_streams
    flat = table.reshape(-1)
    dev = cls_seq.device
    base = (torch.arange(nb, device=dev) // max(nb // n, 1)) * s_dim
    visits = torch.zeros(n * s_dim, dtype=torch.int64, device=dev)
    state = entries.to(torch.int32)
    for t in range(b):
        hit = _accepts(accept, s_dim, state)
        visits.index_add_(0, base + torch.where(hit, state, 0), hit.long())
        state = _step(flat, c_dim, s_dim, state, cls_seq[t].long()).to(torch.int32)
    counts = visits.to(torch.int32).reshape(n, s_dim)
    return state, (counts if num_streams is not None else counts[0])
