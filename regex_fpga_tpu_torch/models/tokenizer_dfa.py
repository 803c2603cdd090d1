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

Semantics note: this is maximal-munch WITHOUT backtracking to the last
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

from .regex import CompiledDfa, compile_pattern

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


def build_tokenizer_dfa(pattern: str | bytes | CompiledDfa = GPT2_PRESPLIT) -> TokenizerDfa:
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
