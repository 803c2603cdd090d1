"""Tokenizer pre-split automaton: regex -> restartable scanning DFA.

Exposes the DFA engine as a regex pre-split stage for tokenization pipelines
(the framework-level capability called for in BASELINE.json config 4; the
reference has no software layer at all, so this is new TPU-native surface).

Construction: take the anchored token-pattern DFA and close it over restarts:

    delta_tok((s, _), b) = (delta(s, b), 0)        if delta(s, b) alive
                           (delta(start, b), 1)    if dead but b can start a token
                           (start, 1)              otherwise (fallback byte)

The boundary flag rides along as a doubled state space (2S states), so the
result is an ordinary dense DFA consumable by every engine in ``ops``
(including the fast MXU path) with ``accept`` = "a token started when this
state was entered".

``utf8=True`` (off by default, where a pattern builds exactly as before)
compiles a ``str`` pattern in the compiler's UTF-8 mode (``utf8.py``) and
matches it as a backtracking engine does:

- its alternatives are taken leftmost-first: once one matches, every later
  one is dropped, so ``'(?i:[sdmt]|ll|ve|re)|[^\\r\\n\\p{L}\\p{N}]?\\p{L}+|...``
  splits ``'strict`` as ``'s`` and ``trict``;
- a token restarts at a character, not a byte: a token that cannot take the
  next character ends before its first byte. The boundary flag is set on
  the character's LAST byte (where the character is known) and
  ``TokenizerMatcher`` walks it back to the first. Bytes that are part of no
  well-formed UTF-8 sequence (Unicode Table 3-7, as Python's decoder finds
  them) are no characters: they belong to the token before them, and the
  next character starts a new token (a run of them at the stream's start is
  a piece of its own). The construction carries a UTF-8 decoder beside the
  token state, and the result is minimized.

Semantics note (byte patterns): this is maximal-munch WITHOUT backtracking to the last
accepting position — a token ends at the first byte that cannot extend it.
For prefix-closed-per-category patterns (letter runs, digit runs, space
runs, punctuation runs — the GPT-2 pre-split shape) this equals greedy
leftmost-longest tokenization.  Patterns where a longer attempt can fail
after passing an accept state (e.g. ``ab|abc`` vs input "abd") would need
last-accept tracking; that is future work and documented here.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .regex import CompiledDfa, compile_pattern, minimize_dfa

__all__ = ["TokenizerDfa", "build_tokenizer_dfa", "GPT2_PRESPLIT", "boundaries_from_flags"]


# Byte-level approximation of the GPT-2 pre-tokenizer pattern
# ('s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+):
# unicode letter/number classes narrowed to the byte ranges that matter for
# ASCII + UTF-8 continuation handling (non-ASCII bytes treated as letters so
# multi-byte UTF-8 sequences stay glued to their run).
GPT2_PRESPLIT = (
    r"'s|'t|'re|'ve|'m|'ll|'d"
    r"| ?[A-Za-z\x80-\xff]+"
    r"| ?[0-9]+"
    r"| ?[^\x00-\x20A-Za-z0-9\x80-\xff]+"
    r"|[\x00-\x20]+"
)


@dataclasses.dataclass(frozen=True)
class TokenizerDfa:
    """Restartable scanning DFA over doubled states (s, boundary_flag)."""

    table: np.ndarray   # (256, 2S) int32
    accept: np.ndarray  # (2S,) bool — True iff boundary flag set
    start: int
    num_base_states: int
    #: UTF-8 mode: a flag marks a token's first character on its last byte
    utf8: bool = False


def build_tokenizer_dfa(pattern: str | bytes | CompiledDfa = GPT2_PRESPLIT, *,
                        utf8: bool = False) -> TokenizerDfa:
    if utf8:
        if not isinstance(pattern, CompiledDfa):
            from .utf8 import compile_ordered

            pattern = compile_ordered(pattern)
        return _utf8_tokenizer(pattern)
    dfa = (
        pattern
        if isinstance(pattern, CompiledDfa)
        else compile_pattern(pattern, anchored=True)
    )
    s = dfa.num_states
    base = dfa.table.astype(np.int64)  # (256, S)
    dead = dfa.dead
    start_row = base[:, dfa.start]  # (256,) delta(start, b)
    junk = 2 * s  # fallback state: the previous byte was a standalone token

    # restart target per byte: token-starting byte -> its state (flagged);
    # byte that can't start any token -> junk (also flagged)
    restart = np.where(start_row != dead, start_row + s, junk)  # (256,)

    # state space: [0,S) flag 0, [S,2S) flag 1, junk = 2S (flag 1)
    tok = np.empty((256, 2 * s + 1), dtype=np.int64)
    alive = base != dead  # (256, S)
    half = np.where(alive, base, restart[:, None])  # dead -> restart w/ flag
    # entering a live transition clears the flag; both halves behave the same
    tok[:, :s] = half
    tok[:, s : 2 * s] = half
    tok[:, junk] = restart  # every byte after a junk byte starts a new token

    accept = np.zeros(2 * s + 1, dtype=bool)
    accept[s:] = True
    # the dead state's own column: never reachable (we never map into dead),
    # keep it self-looping for safety
    tok[:, dead] = dead
    accept[dead] = accept[dead + s] = False

    return TokenizerDfa(
        table=tok.astype(np.int32),
        accept=accept,
        start=int(dfa.start),
        num_base_states=s,
    )


# UTF-8 decoder states: 0 = at a character boundary, else the bytes a
# sequence still needs; _CONT[u] = the byte range its next byte must lie in
# (Unicode Table 3-7), _NEXT[u] = the decoder state after it
_CONT = {1: (0x80, 0xBF), 2: (0x80, 0xBF), 3: (0x80, 0xBF), 4: (0xA0, 0xBF),
         5: (0x80, 0x9F), 6: (0x90, 0xBF), 7: (0x80, 0x8F)}
_NEXT = {1: 0, 2: 1, 3: 2, 4: 1, 5: 1, 6: 2, 7: 2}


def _lead_state(b: int) -> int:
    """The decoder state after byte b at a boundary: 0 for ASCII (a whole
    character), -1 for a byte that begins no well-formed sequence."""
    if b < 0x80:
        return 0
    if 0xC2 <= b <= 0xDF:
        return 1
    if b == 0xE0:
        return 4
    if b == 0xED:
        return 5
    if 0xE1 <= b <= 0xEF:
        return 2
    if b == 0xF0:
        return 6
    if 0xF1 <= b <= 0xF3:
        return 3
    if b == 0xF4:
        return 7
    return -1


def _utf8_tokenizer(dfa: CompiledDfa) -> TokenizerDfa:
    """The restartable DFA at character granularity (module docstring).

    States: ("B", s, flag) at a boundary, s the token's state (``dead``
    after bytes that are no character: the next character starts a token);
    ("M", u, s, r) inside a character, s the token's state and r the state
    a token restarted at this character would be in, u the decoder's."""
    start, dead = int(dfa.start), int(dfa.dead)
    lead = [_lead_state(b) for b in range(256)]
    # bytes that act alike everywhere: same base column, same UTF-8 role
    role = np.array([[lead[b]] + [int(lo <= b <= hi) for lo, hi in _CONT.values()]
                     for b in range(256)])
    _, reps, cls = np.unique(np.concatenate([dfa.table, role], axis=1), axis=0,
                             return_index=True, return_inverse=True)
    cls = cls.reshape(-1)
    base = dfa.table.tolist()  # base[b][s]: Python ints, quick to index

    def complete(s1: int, r1: int) -> tuple:
        if s1 != dead:
            return ("B", s1, 0)
        return ("B", r1, 1) if r1 != dead else ("B", dead, 1)

    def at_boundary(s: int, b: int) -> tuple:
        u = lead[b]
        if u == 0:
            return complete(base[b][s], base[b][start])
        if u < 0:
            return ("B", dead, 0)
        return ("M", u, base[b][s], base[b][start])

    def step(key: tuple, b: int) -> tuple:
        if key[0] == "B":
            return at_boundary(key[1], b)
        _, u, s, r = key
        lo, hi = _CONT[u]
        if not lo <= b <= hi:  # the sequence breaks: its bytes are no character
            return at_boundary(dead, b)
        s1, r1 = base[b][s], base[b][r]
        return complete(s1, r1) if _NEXT[u] == 0 else ("M", _NEXT[u], s1, r1)

    first = ("B", start, 0)
    ids = {first: 0}
    order = [first]
    rows = []
    for key in order:  # grows as states are found
        row = np.empty(len(reps), np.int64)
        for c, b in enumerate(reps):
            nxt = step(key, int(b))
            if nxt not in ids:
                ids[nxt] = len(order)
                order.append(nxt)
            row[c] = ids[nxt]
        rows.append(row[cls])
    table = np.stack(rows, axis=1).astype(np.int32)  # (256, N)
    accept = np.array([k[0] == "B" and k[2] == 1 for k in order], bool)
    tok = minimize_dfa(CompiledDfa(table=table, accept=accept, start=0,
                                   dead=ids.get(("B", dead, 0), 0)))
    return TokenizerDfa(table=tok.table, accept=tok.accept, start=int(tok.start),
                        num_base_states=dfa.num_states, utf8=True)


def boundaries_from_flags(match_mask: np.ndarray, final_flag: bool) -> np.ndarray:
    """Token-start byte offsets from an engine's match mask.

    Engines report accept(state *before* consuming byte i) at position i, and
    the flag marks "token started at the byte that entered this state", i.e.
    at byte i-1.  Position 0 always starts a token.  ``final_flag`` is
    ``accept[final_state]`` — a boundary at the last byte.
    """
    mask = np.asarray(match_mask, dtype=bool)
    starts = np.nonzero(mask[1:])[0]  # flag at i+1 => token start at byte i
    out = [0]
    out.extend((starts + 0).tolist())
    if final_flag and len(mask) > 0:
        out.append(len(mask) - 1)
    return np.unique(np.asarray(out, dtype=np.int64))
