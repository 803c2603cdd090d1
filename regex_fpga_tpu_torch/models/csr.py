"""CSR automaton model — the decoded form of the reference memory images.

Layout contract (reverse-engineered in SURVEY.md SS2.3 from reference
``Design/FPGA.v:773,793`` address generation and ``FPGA.v:888-898`` word
decode):

```
word index            content
0 .. N                offsets[0..N]        (monotone nondecreasing, offsets[0]=0)
N+1 .. N+offsets[N]   transitions          word = (char << 24) | target_state
```

State ``i``'s out-edges occupy transition words ``offsets[i]..offsets[i+1]``.
A state is *accepting* iff its out-degree is zero (reference
``Design/FPGA.v:210-213`` — that is the only accept marker in the format).
State 0 is the start state (``FPGA.v:146-147``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .coe import read_coe

__all__ = ["CsrAutomaton", "split_words", "from_words", "load_coe", "byte_classes",
           "prefix_automaton"]


@dataclasses.dataclass(frozen=True)
class CsrAutomaton:
    """An NFA (or DFA) in CSR form, plus derived lookup structures."""

    offsets: np.ndarray       # (N+1,) int64, monotone, offsets[0] == 0
    trans_char: np.ndarray    # (E,) uint8   — byte label of each transition
    trans_target: np.ndarray  # (E,) int32   — target state of each transition

    @property
    def num_states(self) -> int:
        return len(self.offsets) - 1

    @property
    def num_transitions(self) -> int:
        return int(self.offsets[-1])

    @property
    def out_degree(self) -> np.ndarray:
        return np.diff(self.offsets)

    @property
    def accept_mask(self) -> np.ndarray:
        """Boolean (N,) — accepting iff out-degree 0 (SURVEY.md SS2.3)."""
        return self.out_degree == 0

    def edges(self, state: int) -> tuple[np.ndarray, np.ndarray]:
        lo, hi = int(self.offsets[state]), int(self.offsets[state + 1])
        return self.trans_char[lo:hi], self.trans_target[lo:hi]

    def is_dfa(self) -> bool:
        """True iff no state has two out-edges on the same byte."""
        keys = self.trans_char.astype(np.int64) + 256 * np.repeat(
            np.arange(self.num_states, dtype=np.int64), self.out_degree
        )
        return len(np.unique(keys)) == len(keys)

    def max_fanout(self) -> int:
        """Max number of targets for any (state, byte) pair (1 for a DFA)."""
        if self.num_transitions == 0:
            return 0
        keys = self.trans_char.astype(np.int64) + 256 * np.repeat(
            np.arange(self.num_states, dtype=np.int64), self.out_degree
        )
        _, counts = np.unique(keys, return_counts=True)
        return int(counts.max())

    def to_words(self) -> np.ndarray:
        """Re-encode to the flat word array (inverse of ``from_words``)."""
        trans = (self.trans_char.astype(np.uint32) << 24) | self.trans_target.astype(
            np.uint32
        )
        return np.concatenate(
            [self.offsets.astype(np.uint32), trans.astype(np.uint32)]
        )


def split_words(words: np.ndarray) -> int:
    """Find N (number of states) for a flat CSR word array.

    ``offsets`` is the monotone-nondecreasing prefix; the first transition
    word normally breaks monotonicity (its char bits make it large).  We take
    the longest monotone prefix, then walk back to the largest N for which the
    structural invariant ``(N+1) + words[N] + pad == len(words)`` holds with
    an all-zero pad tail (snort_16 ships one zero pad word — SURVEY.md SS2.3).
    """
    w = words.astype(np.int64)
    nondecr = np.nonzero(w[1:] < w[:-1])[0]
    prefix_len = int(nondecr[0]) + 1 if len(nondecr) else len(w)
    for n in range(prefix_len - 1, 0, -1):
        end = n + 1 + int(w[n])
        if end <= len(w) and (end == len(w) or not np.any(w[end:])):
            return n
    raise ValueError("not a CSR automaton image: no consistent offsets/transitions split")


def from_words(words: np.ndarray) -> CsrAutomaton:
    n = split_words(words)
    offsets = words[: n + 1].astype(np.int64)
    trans = words[n + 1 : n + 1 + int(offsets[-1])].astype(np.uint32)
    return CsrAutomaton(
        offsets=offsets,
        trans_char=(trans >> 24).astype(np.uint8),
        trans_target=(trans & 0xFFFFFF).astype(np.int32),
    )


def load_coe(path: str) -> CsrAutomaton:
    """Load a reference ``.coe`` memory image directly as a CsrAutomaton."""
    return from_words(read_coe(path))


def byte_classes(aut: CsrAutomaton) -> tuple[np.ndarray, int]:
    """Byte-equivalence classes: bytes that label identical transition sets.

    Returns ``(class_of_byte, num_classes)`` with ``class_of_byte`` shape
    (256,) int32.  Two bytes are equivalent iff for every state they reach the
    same target set — computed here by hashing each byte's full (state,
    target) edge multiset.  Shrinks the per-byte tables from 256 to C columns
    (C = 164 for l-7_filter, 74 for snort_16 — SURVEY.md SS2.1 #13-14).
    """
    sigs: dict[bytes, int] = {}
    class_of = np.zeros(256, dtype=np.int32)
    src = np.repeat(np.arange(aut.num_states, dtype=np.int64), aut.out_degree)
    order = np.lexsort((aut.trans_target, src, aut.trans_char))
    ch_s = aut.trans_char[order]
    pairs = np.stack([src[order], aut.trans_target[order].astype(np.int64)], axis=1)
    bounds = np.searchsorted(ch_s, np.arange(257))
    for b in range(256):
        sig = pairs[bounds[b] : bounds[b + 1]].tobytes()
        if sig not in sigs:
            sigs[sig] = len(sigs)
        class_of[b] = sigs[sig]
    return class_of, len(sigs)


def prefix_automaton(aut: CsrAutomaton, k: int) -> CsrAutomaton:
    """Self-consistent sub-automaton over ``aut``'s first ``k`` states.

    Transitions targeting states >= k are DROPPED, so this is NOT
    language-equivalent to ``aut`` (dropping edges can even flip a state
    to accepting under the out-degree-0 rule) — it is a shape-faithful
    slice of a real ruleset for validating engines at realistic state
    counts (e.g. the TP axis dryrun against ``CSR_BlockMem.coe``
    prefixes, r4 verdict item 7) where the ground truth is the same
    sub-automaton run through the golden oracle."""
    assert 0 < k <= aut.num_states
    keep = aut.trans_target < k
    new_off = np.zeros(k + 1, dtype=np.int64)
    chars, tgts = [], []
    for s in range(k):
        lo, hi = int(aut.offsets[s]), int(aut.offsets[s + 1])
        m = keep[lo:hi]
        chars.append(aut.trans_char[lo:hi][m])
        tgts.append(aut.trans_target[lo:hi][m])
        new_off[s + 1] = new_off[s] + int(m.sum())
    return CsrAutomaton(
        offsets=new_off,
        trans_char=(np.concatenate(chars) if chars
                    else np.empty(0, np.uint8)).astype(np.uint8),
        trans_target=(np.concatenate(tgts) if tgts
                      else np.empty(0, np.int32)).astype(np.int32),
    )
