"""Plain reference of the cl100k_base pre-split over UTF-8: a scanner of
the pattern's categories on decoded code points, written from the pattern
alone.

    '(?i:[sdmt]|ll|ve|re)|X?L+|N{1,3}| ?P+[\\r\\n]*|W+

with L = \\p{L}, N = \\p{N}, W = \\s (White_Space), P every other code point
and X = P or W but \\r and \\n (Unicode 15.0.0 ranges in
``cl100k_classes.json`` beside this file), matched leftmost-first: at a
token's start the first alternative that matches wins, each quantifier
greedy. Every character starts some alternative, and each greedy run
ends where its class ends, so every rule looks a few characters around:

- a P run opens a token at its first character, unless a single space
  before it (a W run of one space) opens it (`` ?P+``); its token takes the
  \\r and \\n right after it, and the W run they begin loses them;
- the rest of a W run is one token (``W+``), except a run of one character
  that opens the next token: an X before an L run, a space before a P run;
- a quote that opens a token and is followed by s d m t (and S D M T, and
  U+017F, which folds to s) is a token of two characters, by ll ve re
  (any case) one of three; the L after it opens a token;
- otherwise a P run of one character opens the L run after it (``X?L+``),
  and an L run opens a token at its first character;
- an N run is cut into tokens of three from its first character.

Bytes are decoded as Python's decoder does, each well-formed sequence
(Unicode Table 3-7) one character; a byte of no such sequence is no
character: it stays in the token before it, and the next character starts
a new token, as if the text were cut there. Byte 0 starts the first piece.

A stream is scanned at once as whole-array operations on the run's device
(about 30 temporaries of its size, run once the port is freed). ``count``
is the token starts after byte 0 and ``presplit`` all of them. The control
decodes and scans each 4,096-byte segment as a stream of its own entered in
the start state: a speculative scan that never checks its guess.
"""

from __future__ import annotations

import functools
import json
from pathlib import Path

import numpy as np
import torch

__all__ = ["Reference", "PAT", "token_starts", "decode"]

#: the pattern this scanner implements (the configuration's ``pat``)
PAT = ("'(?i:[sdmt]|ll|ve|re)|[^\\r\\n\\p{L}\\p{N}]?\\p{L}+|\\p{N}{1,3}"
       "| ?[^\\s\\p{L}\\p{N}]+[\\r\\n]*|\\s+")
SEGMENT = 4096
_CLASSES = Path(__file__).with_name("cl100k_classes.json")
#: the letters after a quote, each with every code point folding to it
SDMT = (0x73, 0x53, 0x17F, 0x64, 0x44, 0x6D, 0x4D, 0x74, 0x54)


@functools.lru_cache(maxsize=1)
def _ranges() -> dict:
    return json.loads(_CLASSES.read_text())


def _member(cp: torch.Tensor, name: str) -> torch.Tensor:
    r = torch.tensor(_ranges()[name], dtype=torch.int64, device=cp.device)
    k = torch.searchsorted(r[:, 0].contiguous(), cp, right=True) - 1
    return (k >= 0) & (cp <= r[k.clamp(min=0), 1])


def decode(data: torch.Tensor, segment: int = 0):
    """(uint8 bytes on the device) -> (each character's first byte offset,
    its code point, its byte length), the characters in order. With
    ``segment``, a sequence that crosses a multiple of it is no character."""
    n = data.shape[0]
    b = torch.zeros(n + 3, dtype=torch.int64, device=data.device)
    b[:n] = data.long()
    b0, b1, b2, b3 = b[:n], b[1:n + 1], b[2:n + 2], b[3:n + 3]
    pos = torch.arange(n, device=data.device)
    has = lambda k: pos + k < n  # noqa: E731
    cont = lambda x: (x & 0xC0) == 0x80  # noqa: E731
    ln = torch.where(b0 < 0x80, 1, torch.where((b0 >= 0xC2) & (b0 <= 0xDF), 2,
                     torch.where((b0 >= 0xE0) & (b0 <= 0xEF), 3,
                                 torch.where((b0 >= 0xF0) & (b0 <= 0xF4), 4, 0))))
    lo1 = torch.where(b0 == 0xE0, 0xA0, torch.where(b0 == 0xF0, 0x90, 0x80))
    hi1 = torch.where(b0 == 0xED, 0x9F, torch.where(b0 == 0xF4, 0x8F, 0xBF))
    ok1 = has(1) & (b1 >= lo1) & (b1 <= hi1)
    ok2 = has(2) & cont(b2)
    ok3 = has(3) & cont(b3)
    valid = ((ln == 1) | ((ln == 2) & ok1) | ((ln == 3) & ok1 & ok2)
             | ((ln == 4) & ok1 & ok2 & ok3))
    if segment:
        valid &= (pos % segment) + ln <= segment
    lead = torch.nonzero(valid).flatten()
    b0, b1, b2, b3, ln = b0[lead], b1[lead], b2[lead], b3[lead], ln[lead]
    cp = torch.where(ln == 1, b0, torch.where(
        ln == 2, ((b0 & 0x1F) << 6) | (b1 & 0x3F), torch.where(
            ln == 3, ((b0 & 0x0F) << 12) | ((b1 & 0x3F) << 6) | (b2 & 0x3F),
            ((b0 & 0x07) << 18) | ((b1 & 0x3F) << 12) | ((b2 & 0x3F) << 6)
            | (b3 & 0x3F))))
    return lead, cp, ln


def token_starts(cp: torch.Tensor, cut: torch.Tensor) -> torch.Tensor:
    """(m,) code points, and (m,) bool: the text is cut before character i
    (no character links across a cut) -> (m,) bool: the characters that
    start a token."""
    m = cp.shape[0]
    if m == 0:
        return torch.zeros(0, dtype=torch.bool, device=cp.device)
    idx = torch.arange(m, device=cp.device)

    def pv(x):  # the character before, within the piece
        out = torch.zeros_like(x)
        out[1:] = x[:-1]
        return out & ~cut

    def nx(x):  # the character after, within the piece
        out = torch.zeros_like(x)
        out[:-1] = x[1:] & ~cut[1:]
        return out

    def is_any(points):
        return torch.isin(cp, torch.tensor(points, device=cp.device))

    letter, number, white = _member(cp, "L"), _member(cp, "N"), _member(cp, "White_Space")
    punct = ~(letter | number | white)
    nl = (cp == 0x0A) | (cp == 0x0D)
    space = cp == 0x20

    def run_start(x):  # for each character of an x run, where its run starts
        first = x & ~pv(x)
        return torch.cummax(torch.where(first, idx, 0), 0).values

    # \r and \n right after a P run belong to its token
    absorbed = nl & pv(punct)[run_start(nl)]
    white_tok = white & ~absorbed
    w_start = white_tok & ~pv(white_tok)
    w_single = w_start & ~nx(white)
    w_pre_l = w_single & ~nl & nx(letter)  # X before an L run
    w_pre_p = w_single & space & nx(punct)  # a space before a P run
    p_start = punct & ~pv(punct)
    p_tok = p_start & ~pv(w_pre_p)
    quote = p_tok & (cp == 0x27)
    c2 = quote & nx(is_any(SDMT))
    c3 = quote & ~nx(is_any(SDMT)) & (
        (nx(is_any((0x6C, 0x4C))) & nx(nx(is_any((0x6C, 0x4C)))))
        | (nx(is_any((0x76, 0x56))) & nx(nx(is_any((0x65, 0x45)))))
        | (nx(is_any((0x72, 0x52))) & nx(nx(is_any((0x65, 0x45))))))
    contraction = c2 | c3
    p_pre_l = p_tok & ~nx(punct) & nx(letter) & ~contraction
    l_tok = (letter & ~pv(letter) & ~pv(w_pre_l | p_pre_l | contraction)
             | letter & (pv(pv(c2)) | pv(pv(pv(c3)))))
    n_tok = number & ((idx - run_start(number)) % 3 == 0)
    start = w_start | p_tok | l_tok | n_tok
    start[0] = True
    return start


class Reference:
    def __init__(self, config: dict, device, control: bool = False):
        if config["pat"] != PAT:
            raise ValueError("this scanner implements only cl100k's pat in its "
                             "UTF-8 form; the configuration states another")
        self.device = device
        self.control = control

    def _starts(self, stream) -> np.ndarray:
        arr = (np.frombuffer(bytes(stream), np.uint8).copy()
               if isinstance(stream, (bytes, bytearray)) else np.array(stream, np.uint8))
        data = torch.as_tensor(arr, device=self.device)
        if len(data) == 0:
            return np.zeros(0, np.int64)
        seg = SEGMENT if self.control else 0
        lead, cp, ln = decode(data, seg)
        cut = torch.ones_like(lead, dtype=torch.bool)
        if len(lead):  # a byte of no character, or a segment's edge, between
            cut[1:] = lead[1:] != lead[:-1] + ln[:-1]
            if seg:
                cut[1:] |= lead[1:] // seg != lead[:-1] // seg
        first = lead[token_starts(cp, cut)]
        if seg:  # a segment entered in the start state flags no first character
            first = first[(first % seg != 0) | (first == 0)]
        zero = torch.zeros(1, dtype=first.dtype, device=first.device)
        return torch.unique(torch.cat([zero, first])).cpu().numpy().astype(np.int64)

    def count(self, streams) -> list[int]:
        return [max(len(self._starts(s)) - 1, 0) for s in streams]

    def presplit(self, streams) -> list[np.ndarray]:
        return [self._starts(s) for s in streams]
