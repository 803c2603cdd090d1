"""Plain reference of per-word occurrence counts: for every line of the
configuration's ``words``, the number of byte offsets at which the word's
UTF-8 bytes occur in the stream, overlapping and nested occurrences
included. It builds no automaton: the words are grouped by their length
in bytes, and for each length L every L-byte window of the stream is
looked up among that length's words.

A window's key is two polynomial hashes of its bytes, each modulo a prime
below 2^31 (Horner's rule, one byte a step, so no product leaves int64),
side by side in one int64. The words' keys are sorted once; a window's
candidate is found with ``torch.searchsorted`` and then held to the word
byte for byte, so the count is exact whatever the hashes do. Two words of
one length with one key make the build refuse. The windows of all lengths
are hashed together, one more byte a length, over blocks of ``BLOCK``
starts (about 80 bytes a start of temporaries), on the run's device. Each
match adds one to its word with ``bincount``; a duplicate line gets its
word's count.

The control scans each 4,096-byte segment alone: a window that crosses a
segment's edge is not counted, as a speculative scan that never checks its
seams would lose it.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Reference", "SEGMENT", "BLOCK"]

SEGMENT = 4096
BLOCK = 1 << 22
#: two primes below 2^31, the moduli of the two hashes
PRIMES = (2147483629, 2147483587)


def _key(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    return h1 * (1 << 31) + h2


class Reference:
    def __init__(self, config: dict, device, control: bool = False):
        self.device = torch.device(device)
        self.segment = SEGMENT if control else None
        lines = [w.encode("utf-8") for w in config["words"]]
        if not lines or min(map(len, lines)) == 0:
            raise ValueError("the words must be non-empty")
        distinct = sorted(set(lines))
        number = {w: i for i, w in enumerate(distinct)}
        #: each line's distinct word
        self.line_word = torch.tensor([number[w] for w in lines], device=self.device)
        self.num_words = len(distinct)
        self.longest = max(map(len, distinct))
        #: length -> (sorted keys, the words' bytes (n, L) and their numbers, in key order)
        self.groups: dict[int, tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}
        by_length: dict[int, list[bytes]] = {}
        for w in distinct:
            by_length.setdefault(len(w), []).append(w)
        for n, ws in sorted(by_length.items()):
            raw = torch.tensor(np.frombuffer(b"".join(ws), np.uint8).reshape(len(ws), n),
                               device=self.device)
            h1, h2 = self._hash(raw.long())
            keys = _key(h1, h2)
            order = torch.argsort(keys)
            keys = keys[order]
            if len(keys) > 1 and bool((keys[1:] == keys[:-1]).any()):
                raise ValueError(f"two words of {n} bytes share a hash key")
            ids = torch.tensor([number[w] for w in ws], device=self.device)
            self.groups[n] = (keys, raw[order], ids[order])

    @staticmethod
    def _hash(cols: torch.Tensor):
        """The two hashes of each row of (n, L) int64 bytes."""
        h1 = torch.zeros(cols.shape[0], dtype=torch.int64, device=cols.device)
        h2 = torch.zeros_like(h1)
        for j in range(cols.shape[1]):
            h1 = (h1 * 256 + cols[:, j]) % PRIMES[0]
            h2 = (h2 * 256 + cols[:, j]) % PRIMES[1]
        return h1, h2

    def _counts(self, stream) -> np.ndarray:
        if isinstance(stream, (bytes, bytearray)):
            stream = np.frombuffer(stream, np.uint8)
        data = torch.as_tensor(np.array(stream, np.uint8), device=self.device)
        n = len(data)
        per_word = torch.zeros(self.num_words, dtype=torch.int64, device=self.device)
        # the stream with room for the longest window past its end
        padded = torch.zeros(n + self.longest, dtype=torch.int64, device=self.device)
        padded[:n] = data
        for a in range(0, n, BLOCK):
            starts = torch.arange(a, min(a + BLOCK, n), device=self.device)
            h1 = torch.zeros(len(starts), dtype=torch.int64, device=self.device)
            h2 = torch.zeros_like(h1)
            for length in range(1, self.longest + 1):
                byte = padded[a + length - 1 : a + length - 1 + len(starts)]
                h1 = (h1 * 256 + byte) % PRIMES[0]
                h2 = (h2 * 256 + byte) % PRIMES[1]
                if length not in self.groups:
                    continue
                keys, raw, ids = self.groups[length]
                whole = starts + length <= n
                if self.segment is not None:  # the window lies in one segment
                    whole &= starts // self.segment == (starts + length - 1) // self.segment
                wkey = _key(h1, h2)
                at = torch.searchsorted(keys, wkey).clamp_(max=len(keys) - 1)
                hit = whole & (keys[at] == wkey)
                pos, at = starts[hit], at[hit]
                span = pos[:, None] + torch.arange(length, device=self.device)
                same = (padded[span] == raw[at].long()).all(1)
                per_word += torch.bincount(ids[at[same]], minlength=self.num_words)
        return per_word[self.line_word].cpu().numpy()

    def count_patterns(self, streams) -> list[np.ndarray]:
        return [self._counts(s) for s in streams]
