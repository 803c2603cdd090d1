"""Plain reference of the byte-level GPT-2 pre-split: a scanner of the
pattern's categories, written from the pattern alone.

    's|'t|'re|'ve|'m|'ll|'d| ?L+| ?N+| ?P+|W+

with L = [A-Za-z\\x80-\\xff], N = [0-9], W = [\\x00-\\x20] and P every other
byte, matched by maximal munch without backtracking: a token grows while
some alternative can still take the next byte, and the byte that none can
take starts the next token. Every byte starts some alternative. So:

- a W byte starts a token unless the byte before it is W (a W run takes
  every W byte, the space that opens ``' ?X+'`` included);
- a space that starts a token is taken by a following L, N or P byte, which
  then does not start one;
- otherwise an N byte continues an N byte before it, and a P byte (the
  quote among them) a P byte before it;
- a quote that starts a token opens a contraction: ``s t m d`` after it, or
  ``r v l`` (then ``e e l`` after those), belong to its token, and an L byte
  after the contraction's last byte starts a new token; else an L byte
  continues an L byte before it.

Each rule looks a few bytes back, so a stream is scanned at once as a few
whole-array operations on the run's device (about 15 temporaries of the
stream's size: 1 GB for a 64 MiB shard, run once the port is freed).
``count`` is the token starts after byte 0 and ``presplit`` all of them.
The control scans each 4,096-byte segment as a stream of its own entered
in the start state: a speculative scan that never checks its guess.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Reference", "PAT", "token_starts"]

#: the pattern this scanner implements (the configuration's ``pat``)
PAT = ("'s|'t|'re|'ve|'m|'ll|'d| ?[A-Za-z\\x80-\\xff]+| ?[0-9]+"
       "| ?[^\\x00-\\x20A-Za-z0-9\\x80-\\xff]+|[\\x00-\\x20]+")
SEGMENT = 4096


def _back(x: torch.Tensor, k: int, fill: bool = False) -> torch.Tensor:
    """``x`` shifted k bytes along each row: out[:, i] = x[:, i - k]."""
    out = torch.full_like(x, fill)
    out[:, k:] = x[:, :-k]
    return out


def token_starts(rows: torch.Tensor) -> torch.Tensor:
    """(R, n) uint8 -> (R, n) bool: the bytes that start a token, each row
    scanned as a stream of its own from byte 0 (bytes past a stream's end
    change nothing before it: every rule looks back)."""
    b = rows
    letter = ((b >= 65) & (b <= 90)) | ((b >= 97) & (b <= 122)) | (b >= 0x80)
    digit = (b >= 48) & (b <= 57)
    white = b <= 0x20
    punct = ~(letter | digit | white)

    def is_any(x, chars):
        return torch.isin(x, torch.tensor(list(chars), device=x.device))

    # a space that starts a token
    lead = (b == 0x20) & ~_back(white, 1)
    lead_1 = _back(lead, 1)
    # quotes and other P bytes start a token unless a P run or a leading
    # space is open before them
    p_start = punct & ~(_back(punct, 1) | lead_1)
    quote = p_start & (b == ord("'"))
    # contractions: their second byte, their third, and the byte after
    c1 = _back(quote, 1) & is_any(b, b"stmdrvl")
    b_1 = _back(b, 1, 0)
    c2 = _back(c1, 1) & (((b_1 == ord("r")) | (b_1 == ord("v"))) & (b == ord("e"))
                         | (b_1 == ord("l")) & (b == ord("l")))
    after = (_back(c1, 1) & ~c2) | _back(c2, 1)
    start = torch.where(
        white, ~_back(white, 1),
        torch.where(digit, ~(_back(digit, 1) | lead_1),
                    torch.where(punct, p_start,
                                ~(lead_1 | c1 | (_back(letter, 1) & ~after)))))
    start[:, 0] = True
    return start


class Reference:
    def __init__(self, config: dict, device, control: bool = False):
        if config["pat"] != PAT:
            raise ValueError("this scanner implements only the byte-level "
                             "GPT-2 pattern; the configuration states another")
        self.device = device
        self.control = control

    def _starts(self, stream) -> np.ndarray:
        data = torch.as_tensor(np.array(stream, np.uint8), device=self.device)
        n = len(data)
        if n == 0:
            return np.zeros(0, np.int64)
        if self.control:  # every segment a stream entered in the start state
            rows = torch.zeros(-(-n // SEGMENT) * SEGMENT, dtype=torch.uint8,
                               device=self.device)
            rows[:n] = data
            s = token_starts(rows.view(-1, SEGMENT))
            s[1:, 0] = False
            return torch.nonzero(s.reshape(-1)[:n]).flatten().cpu().numpy()
        return torch.nonzero(token_starts(data[None])[0]).flatten().cpu().numpy()

    def count(self, streams) -> list[int]:
        return [max(len(self._starts(s)) - 1, 0) for s in streams]

    def presplit(self, streams) -> list[np.ndarray]:
        return [self._starts(s).astype(np.int64) for s in streams]
