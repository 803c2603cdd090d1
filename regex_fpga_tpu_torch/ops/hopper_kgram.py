"""K3: the k-gram chain pass on Hopper, with its plain versions.

``kgram_chain`` runs NB independent chains over k-gram class ids:
``(state, total) <- (T_k[c, state], total + A_k[c, state])`` per step, and
returns each lane's final state and accept total. ``kgram_chain_bytes`` runs
the same chains over raw text, k bytes a step, and derives each step's class
inside the kernel (``class_of`` per byte, then one pair map per level), so no
class-id tensor is built. The kernel is ``csrc/kgram_chain.cu``; it replaces
the TPU kernel ``regex_fpga_tpu/ops/pallas_kgram.py::_kernel`` without that
kernel's packed 128-lane table or its limit of 64 states.

Both take the tables that ``pack_ta`` builds once per automaton: the wide
(C, S, 2) int32 table of (T_k, A_k), and, when it can hold them, a narrow
form for shared memory: (C + 1) rows of (S + 1) uint16 or uint32 entries,
``count << count_shift | column * entry_bytes``, with a zero row and a zero
column where every class or state outside the table leads; a T_k entry
outside [0, S) is stored as column S. A row is padded to an odd number of
32-bit words (``row_entries``), which keeps the rows of one column in
different shared-memory banks. ``pack_maps`` packs ``class_of`` and
the pair maps of a ``KgramTables`` for ``kgram_chain_bytes``.

Layout, dispatch and out-of-range rules are those of ``hopper_dfa``:
``cls_seq`` is (B, NB) in either storage order (``text`` (B, NB, k)), CUDA
tensors launch the kernel, CPU tensors take the plain version.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import _build
from .hopper_dfa import _CLASS_DTYPES, _require_cuda, _step, _stream

__all__ = ["LAUNCHES", "KgramMaps", "PackedTa", "kgram_bytes_supported",
           "kgram_chain", "kgram_chain_bytes", "kgram_chain_bytes_plain",
           "kgram_chain_plain", "kgram_chain_route", "map_classes", "map_levels",
           "pack_maps", "pack_ta", "row_entries"]

#: Kernel launches since the last reset, one count per entry point.
LAUNCHES = {"kgram_chain": 0, "kgram_chain_bytes": 0}

_U32_COUNT_SHIFT = 24  # uint32 entries: counts below 256, S + 1 <= 2^22


def row_entries(num_states: int, entry_bytes: int) -> int:
    """Entries in a row of the narrow table: S + 1, rounded up until the row
    is an odd number of 32-bit words (the kernel computes the same)."""
    per_word = 4 // entry_bytes
    words = -(-(num_states + 1) // per_word) | 1
    return words * per_word


@dataclasses.dataclass(frozen=True)
class PackedTa:
    """T_k and A_k as the K3 wrappers take them (``pack_ta``)."""

    wide: torch.Tensor            # (C, S, 2) int32: (T_k, A_k)
    #: the narrow form, flat and padded to 16 bytes: int16 (the bits of
    #: uint16 entries) or int32, or None when no form holds the table
    narrow: torch.Tensor | None
    count_shift: int              # entry >> count_shift is the accept count

    @property
    def shape(self) -> tuple[int, int]:
        """(C, S)."""
        return tuple(self.wide.shape[:2])

    @property
    def device(self) -> torch.device:
        return self.wide.device

    @property
    def entry_bytes(self) -> int:
        """Bytes of a narrow entry: 2, 4, or 0 without a narrow form."""
        return 0 if self.narrow is None else self.narrow.element_size()

    def to(self, device) -> "PackedTa":
        return PackedTa(self.wide.to(device),
                        None if self.narrow is None else self.narrow.to(device),
                        self.count_shift)

    def unpack_narrow(self) -> tuple[np.ndarray, np.ndarray]:
        """The narrow form decoded: (columns (C + 1, S + 1), counts (C + 1,
        S + 1)) as int64 arrays; column S stands for a T_k entry outside
        [0, S), and row C and column S are the zero row and column."""
        c, s = self.shape
        eb = self.entry_bytes
        pitch = row_entries(s, eb)
        flat = self.narrow.cpu().numpy()
        flat = flat.view(np.uint16 if eb == 2 else np.uint32).astype(np.int64)
        e = flat[: (c + 1) * pitch].reshape(c + 1, pitch)
        assert not e[:, s + 1:].any()  # the padding of a row
        e = e[:, : s + 1]
        return (e & ((1 << self.count_shift) - 1)) // eb, e >> self.count_shift


def pack_ta(table: torch.Tensor, acc_table: torch.Tensor) -> PackedTa:
    """Pack T_k and A_k, both (C, S) int32, for the K3 wrappers, on the
    device that holds them. The narrow form is uint16 when the largest column
    offset, 2 * S, and the largest count fit in 16 bits together (k = 4: 3
    count bits, S <= 4,095), else uint32 (counts below 256, S < 2^22), else
    absent (also for a negative count): the kernel then reads the wide table
    from global memory."""
    if acc_table.shape != table.shape or table.dim() != 2:
        raise TypeError("table and acc_table must be (C, S) tensors of one shape")
    wide = torch.stack([table.to(torch.int32), acc_table.to(torch.int32)],
                       dim=-1).contiguous()
    c, s = table.shape
    t = table.cpu().numpy().astype(np.int64)
    a = acc_table.cpu().numpy().astype(np.int64)
    narrow, shift = None, 0
    if c and s and int(a.min()) >= 0:
        count_bits = int(a.max()).bit_length()
        if (2 * s).bit_length() + count_bits <= 16:
            dtype, shift = np.uint16, 16 - count_bits
        elif int(a.max()) < 256 and s + 1 <= 1 << 22:
            dtype, shift = np.uint32, _U32_COUNT_SHIFT
        else:
            dtype = None
        if dtype is not None:
            eb = np.dtype(dtype).itemsize
            col = np.where((t >= 0) & (t < s), t, s)
            body = np.zeros((c + 1, row_entries(s, eb)), dtype=np.int64)
            body[:c, :s] = (a << shift) | (col * eb)
            flat = np.zeros(-(-body.size * eb // 16) * 16 // eb, dtype=dtype)
            flat[: body.size] = body.reshape(-1)
            narrow = torch.from_numpy(
                flat.view(np.int16 if eb == 2 else np.int32)).to(table.device)
    return PackedTa(wide, narrow, shift)


@dataclasses.dataclass(frozen=True)
class KgramMaps:
    """``class_of`` and the pair maps of a k-gram automaton as
    ``kgram_chain_bytes`` takes them (``pack_maps``)."""

    #: class_of (256 entries), then each level's pair map, as the bits of
    #: uint16 values in one int16 tensor, padded to 16 bytes
    packed: torch.Tensor
    level_classes: tuple[int, ...]  # C_i per level (levels + 1 values)
    k: int

    @property
    def size(self) -> int:
        """Entries before the padding."""
        return 256 + sum(c * c for c in self.level_classes[:-1])

    def to(self, device) -> "KgramMaps":
        return KgramMaps(self.packed.to(device), self.level_classes, self.k)


def pack_maps(class_of, pair_maps, level_classes) -> KgramMaps:
    """Pack and validate the byte-to-class map (256,) and the pair maps
    (level i: (C_i * C_i,) -> C_{i+1}) of 1 to 3 levels. Every value must be
    a class of its level, so that the kernel needs no range check."""
    levels = len(pair_maps)
    if not 1 <= levels <= 3 or len(level_classes) != levels + 1:
        raise ValueError(f"{levels} pair maps for {len(level_classes)} levels")
    parts = [np.asarray(class_of).reshape(-1)] + [np.asarray(m).reshape(-1)
                                                  for m in pair_maps]
    sizes = [256] + [c * c for c in level_classes[:-1]]
    for part, size, classes in zip(parts, sizes, level_classes):
        if part.shape[0] != size:
            raise ValueError(f"a map has {part.shape[0]} entries, not {size}")
        if classes > 1 << 16 or part.min() < 0 or part.max() >= classes:
            raise ValueError(f"a map's values are not classes below {classes}")
    flat = np.concatenate(parts).astype(np.uint16)
    padded = np.zeros(-(-flat.size // 8) * 8, dtype=np.uint16)
    padded[: flat.size] = flat
    return KgramMaps(torch.from_numpy(padded.view(np.int16)),
                     tuple(int(c) for c in level_classes), 1 << levels)


def _check_args(ta, cls_seq, entries, last_dims: int = 0) -> tuple[int, int]:
    if not isinstance(ta, PackedTa):
        raise TypeError("ta must be the PackedTa that pack_ta builds")
    dev = cls_seq.device
    for name, t in (("ta", ta), ("entries", entries)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the input on {dev}")
    if cls_seq.dim() != 2 + last_dims:
        raise ValueError(f"the input must be {2 + last_dims}-D, got "
                         f"{tuple(cls_seq.shape)}")
    b, nb = cls_seq.shape[:2]
    if entries.shape != (nb,) or entries.dtype != torch.int32:
        raise TypeError(f"entries must be a ({nb},) int32 tensor")
    c, s = ta.shape
    if c * s >= 1 << 31 or b >= 1 << 31 or nb >= 1 << 31:
        raise ValueError("table, steps and lanes must each stay below 2^31")
    return b, nb


def _launch(name, ta, src, elem_bytes, ls, ss, maps, entries, nb, b):
    dev = src.device
    c, s = ta.shape
    entries = entries.contiguous()
    finals = torch.empty(nb, dtype=torch.int32, device=dev)
    totals = torch.empty(nb, dtype=torch.int32, device=dev)
    classes = (list(maps.level_classes) + [0, 0])[:3] if maps else [0, 0, 0]
    LAUNCHES[name] += 1
    with torch.cuda.device(dev):
        rc = _build.library().kgram_chain(
            src.data_ptr(), elem_bytes, ls, ss, maps.k if maps else 1,
            ta.narrow.data_ptr() if ta.narrow is not None else None,
            ta.entry_bytes, ta.count_shift, ta.wide.data_ptr(), c, s,
            maps.packed.data_ptr() if maps else None,
            maps.size if maps else 0, *classes,
            entries.data_ptr(), nb, b, finals.data_ptr(), totals.data_ptr(),
            _stream(dev),
        )
    _build.check(rc, name)
    return finals, totals


def kgram_chain(ta: PackedTa, cls_seq, entries):
    """K3 over class ids (B, NB), uint8, int16 or int32. Returns (finals
    (NB,) int32, totals (NB,) int32)."""
    b, nb = _check_args(ta, cls_seq, entries)
    if cls_seq.dtype not in _CLASS_DTYPES:
        raise TypeError(f"class ids must be uint8, int16 or int32, got {cls_seq.dtype}")
    if cls_seq.device.type == "cpu":
        return kgram_chain_plain(ta, cls_seq, entries)
    _require_cuda(cls_seq)
    if 1 not in cls_seq.stride():
        cls_seq = cls_seq.contiguous()
    return _launch("kgram_chain", ta, cls_seq, _CLASS_DTYPES[cls_seq.dtype],
                   cls_seq.stride(1), cls_seq.stride(0), None, entries, nb, b)


def kgram_bytes_supported(ta: PackedTa, maps: KgramMaps) -> bool:
    """Whether ``kgram_chain_bytes`` takes these tables on the device that
    holds them: always on the CPU (the plain version); on a card when the
    narrow table and the maps fit in shared memory together."""
    if ta.device.type != "cuda":
        return True
    return kgram_chain_route(ta, maps)["table_smem"]


def kgram_chain_bytes(ta: PackedTa, maps: KgramMaps, text, entries):
    """K3 over raw text: ``text`` is (B, NB, k) uint8, the k bytes of lane
    n's step t at ``text[t, n]``, contiguous. Returns (finals (NB,) int32,
    totals (NB,) int32), equal to ``kgram_chain`` over ``map_classes``."""
    b, nb = _check_args(ta, text, entries, last_dims=1)
    k = maps.k
    if text.dtype != torch.uint8 or text.shape[2] != k:
        raise TypeError(f"text must be (B, NB, {k}) uint8")
    if maps.level_classes[-1] != ta.shape[0]:
        raise ValueError("the maps and the table are not of one automaton")
    if text.device.type == "cpu":
        return kgram_chain_bytes_plain(ta, maps, text, entries)
    _require_cuda(text)
    if maps.packed.device != text.device:
        raise ValueError(f"maps are on {maps.packed.device}, text on {text.device}")
    if not kgram_bytes_supported(ta, maps):
        raise ValueError("the narrow table and the maps do not fit in shared "
                         "memory: map the classes (map_classes) and call "
                         "kgram_chain")
    st, sn, sk = text.stride()
    if (sk != 1 or st % k or sn % k or k not in (st, sn)
            or text.data_ptr() % k):
        # the kernel reads a step as one k-byte word: steps of k contiguous
        # bytes at addresses that are multiples of k, one of the strides a
        # single step (clone: contiguous() keeps a misaligned view as it is)
        text = text.clone(memory_format=torch.contiguous_format)
        st, sn, _ = text.stride()
    return _launch("kgram_chain_bytes", ta, text, k, sn // k, st // k, maps,
                   entries, nb, b)


def kgram_chain_route(ta: PackedTa, maps: KgramMaps | None = None,
                      class_dtype: torch.dtype = torch.int32,
                      num_lanes: int = 1) -> dict:
    """Where the kernel keeps its table on the current card: {"table":
    "shared uint16" | "shared uint32" | "global", "table_smem": bool,
    "ring": windows in the staging ring for ``num_lanes`` lanes}.
    With ``maps``: for raw text, the maps in shared memory beside the table
    ("global" then means that ``kgram_chain_bytes`` refuses the call)."""
    c, s = ta.shape
    elem = maps.k if maps else _CLASS_DTYPES[class_dtype]
    r = _build.library().kgram_chain_route(
        elem, c, s, ta.entry_bytes, maps.size if maps else 0, num_lanes)
    smem = bool(r & 1)
    table = f"shared uint{8 * ta.entry_bytes}" if smem else "global"
    return {"table": table, "table_smem": smem, "ring": r >> 4}


# --------------------------------------------------------------- plain versions


def kgram_chain_plain(ta: PackedTa, cls_seq, entries):
    """Plain-torch K3: one loop iteration and two gathers per step."""
    b, _ = cls_seq.shape
    c_dim, s_dim = ta.shape
    flat_t, flat_a = ta.wide[..., 0].reshape(-1), ta.wide[..., 1].reshape(-1)
    state = entries.to(torch.int32)
    total = torch.zeros_like(state)
    for t in range(b):
        cls = cls_seq[t].long()
        total += _step(flat_a, c_dim, s_dim, state, cls).to(torch.int32)
        state = _step(flat_t, c_dim, s_dim, state, cls).to(torch.int32)
    return state, total


def map_levels(class_of: torch.Tensor, pair_maps, level_classes,
               data: torch.Tensor) -> torch.Tensor:
    """Raw bytes (L,) uint8 to k-gram class ids (L / k,) int32 as tensor
    passes: ``class_of`` (256,) int32 per byte, then each level pairs
    neighbouring ids through its map ((C_i * C_i,) int32)."""
    cls = torch.index_select(class_of, 0, data.int())
    for remap, c in zip(pair_maps, level_classes):
        cls = torch.index_select(remap, 0, cls[0::2] * c + cls[1::2])
    return cls


def map_classes(maps: KgramMaps, data: torch.Tensor) -> torch.Tensor:
    """Map raw bytes (..., k * n) uint8 to k-gram class ids (..., n) int32
    on the device that holds ``data``, from the packed maps."""
    packed = maps.packed.to(data.device).int() & 0xFFFF  # the uint16 values
    sizes = [256] + [c * c for c in maps.level_classes[:-1]]
    class_of, *pair_maps = torch.split(packed[: sum(sizes)], sizes)
    cls = map_levels(class_of, pair_maps, maps.level_classes, data.reshape(-1))
    return cls.reshape(*data.shape[:-1], data.shape[-1] // maps.k)


def kgram_chain_bytes_plain(ta: PackedTa, maps: KgramMaps, text, entries):
    """Plain-torch ``kgram_chain_bytes``: the class mapping as tensor
    passes, then ``kgram_chain_plain``."""
    return kgram_chain_plain(ta, map_classes(maps, text)[..., 0], entries)
