"""Plain reference of RFC 4180 record starts: written from the pattern
alone,

    (?:[^"\\n]|"(?:[^"]|"")*")*\\n+

matched by maximal munch, one token a record with the LFs after it. A
field's bytes are anything but ``"`` and LF; a ``"`` opens a quoted
section, in which every byte but ``"`` is data and ``""`` is one quote; the
next lone ``"`` closes it. So a byte lies inside quotes exactly when an odd
number of ``"`` come before it in the stream, a record ends at an LF
outside quotes, and the LFs after it belong to it: a record starts at byte
0 and at each byte that is not an LF and follows an LF outside quotes.

That is a flag a byte and an exclusive ``cumsum`` mod 2, computed at once
as whole-array operations on the run's device (about 8 bytes a byte of
temporaries: 540 MB for a 64 MiB shard, run once the port is freed).
``count`` is the record starts after byte 0 and ``presplit`` all of them.
The control scans each 4,096-byte segment as a stream entered in the start
state: its quote parity starts even at every segment, as a speculative
scan that never checks its guess would have it.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Reference", "PAT", "record_starts"]

#: the pattern this scanner implements (the configuration's ``pat``)
PAT = '(?:[^"\\n]|"(?:[^"]|"")*")*\\n+'
SEGMENT = 4096
QUOTE, LF = ord('"'), ord("\n")


def record_starts(data: torch.Tensor, segment: int | None = None) -> torch.Tensor:
    """(n,) uint8 -> (n,) bool: the bytes that start a record, the stream
    scanned from byte 0; with ``segment``, each ``segment`` bytes' quote
    parity counted from that segment's first byte."""
    n = len(data)
    quote = (data == QUOTE).to(torch.int32)
    if segment is None:
        parity = torch.cumsum(quote, 0, dtype=torch.int32)
    else:
        rows = torch.zeros(-(-n // segment) * segment, dtype=torch.int32,
                           device=data.device)
        rows[:n] = quote
        parity = torch.cumsum(rows.view(-1, segment), 1,
                              dtype=torch.int32).view(-1)[:n]
    inside = ((parity - quote) & 1).bool()  # odd count of quotes before it
    lf = data == LF
    ends = lf & ~inside
    start = torch.ones(n, dtype=torch.bool, device=data.device)
    start[1:] = ends[:-1] & ~lf[1:]
    return start


class Reference:
    def __init__(self, config: dict, device, control: bool = False):
        if config["pat"] != PAT:
            raise ValueError("this scanner implements only the RFC 4180 "
                             "record pattern; the configuration states another")
        self.device = device
        self.segment = SEGMENT if control else None

    def _starts(self, stream) -> np.ndarray:
        if isinstance(stream, (bytes, bytearray)):
            stream = np.frombuffer(stream, np.uint8)
        data = torch.as_tensor(np.array(stream, np.uint8), device=self.device)
        if len(data) == 0:
            return np.zeros(0, np.int64)
        s = record_starts(data, self.segment)
        return torch.nonzero(s).flatten().cpu().numpy().astype(np.int64)

    def count(self, streams) -> list[int]:
        return [max(len(self._starts(s)) - 1, 0) for s in streams]

    def presplit(self, streams) -> list[np.ndarray]:
        return [self._starts(s) for s in streams]
