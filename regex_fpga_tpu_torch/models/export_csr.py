"""Export compiled patterns to the reference CSR `.coe` format.

The reference ecosystem has no compiler — its rulesets were built by
tooling that was never published (SURVEY.md SS0).  This module closes the
loop: a pattern compiled here can be written as a `CSR_BlockMem`-style
memory image loadable by the reference FPGA design (format contract:
SURVEY.md SS2.3; word = (char << 24) | target, accept = out-degree 0).

Constraint of the reference format: accepting is encoded ONLY as
out-degree 0, so automata whose accept states have outgoing edges (e.g.
overlapping-match scanners) are not representable — exporting such a
pattern raises unless ``truncate_at_accept=True``, which drops accept-state
out-edges (first-match-per-path semantics, like the shipped rulesets).
"""

from __future__ import annotations

import numpy as np

from .coe import write_coe
from .csr import CsrAutomaton
from .regex import EpsNfa, _build, parse_pattern

__all__ = ["regex_to_csr", "regexes_to_csr", "export_coe"]


def regex_to_csr(
    pattern: str | bytes,
    unanchored: bool = True,
    truncate_at_accept: bool = True,
    max_states: int = 1 << 24,
) -> CsrAutomaton:
    """Compile a pattern to a reference-convention CSR NFA.

    Epsilon edges are eliminated by closure; state 0 is the start state and
    a fresh out-degree-0 state is appended as the accept sink (reference
    accept convention).  ``unanchored`` adds start self-loops on every byte
    (the shipped rulesets' hub structure, SURVEY.md SS2.3).

    A leading ``^`` anchor suppresses the hub self-loops (the CSR engine
    activates state 0 exactly once at reset, ``Design/FPGA.v:146-147``, so
    a hub-free start state IS start-anchoring).  A trailing ``$`` raises:
    the reference format has no stream-end concept."""
    pp = parse_pattern(pattern)
    if pp.end_anchored:
        raise ValueError(
            "'$' is not representable in the reference CSR format (its "
            "engine has no stream-end concept; matches fire as the stream "
            "flows)"
        )
    if pp.start_anchored:
        unanchored = False
    nfa = EpsNfa()
    entry, exit_ = _build(nfa, pp.node)

    # epsilon closure per state
    eps_adj: list[list[int]] = [[] for _ in range(nfa.n)]
    char_edges: list[list[tuple[frozenset, int]]] = [[] for _ in range(nfa.n)]
    for src, charset, dst in nfa.edges:
        if charset is None:
            eps_adj[src].append(dst)
        else:
            char_edges[src].append((charset, dst))

    def eclose(s: int) -> set:
        stack, seen = [s], {s}
        while stack:
            x = stack.pop()
            for t in eps_adj[x]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return seen

    closures = [eclose(s) for s in range(nfa.n)]

    # reachable subset of states under char transitions from the entry
    # closure; edges (src, byte, dst-closure-representative)
    # We keep the original state ids (plus accept sink) — the reference
    # format is an NFA so no determinization is needed; an edge s -b-> t
    # becomes s -b-> t' for every t' reachable: we simply connect to t and
    # rely on t's own closure-derived edges, with accepting handled via the
    # sink below.
    accept_sink = None
    edges: list[tuple[int, int, int]] = []  # (src, byte, dst)
    src_states = list(range(nfa.n))
    is_accepting = [exit_ in closures[s] for s in range(nfa.n)]

    out_edges: list[list[tuple[int, int]]] = [[] for s in range(nfa.n)]
    for s in range(nfa.n):
        # char edges available from s's closure
        for m in closures[s]:
            for charset, dst in char_edges[m]:
                for b in charset:
                    out_edges[s].append((b, dst))

    # map to reference convention: accepting states must be out-degree 0.
    # Add one sink state; every edge INTO an accepting state also targets
    # the sink... simpler exact approach: redirect edges into accepting
    # states to the sink when truncating, else error if accepting states
    # have out-edges.
    n = nfa.n
    sink = n  # out-degree 0 accept sink
    remap_edges: list[tuple[int, int, int]] = []
    for s in range(n):
        if is_accepting[s] and out_edges[s]:
            if not truncate_at_accept:
                raise ValueError(
                    "pattern's accept states continue; reference format "
                    "cannot express this (pass truncate_at_accept=True)"
                )
            continue  # drop accept-state out-edges
        for b, dst in out_edges[s]:
            target = sink if is_accepting[dst] else dst
            remap_edges.append((s, b, target))

    if unanchored:
        # hub: start state re-enters itself on every byte (in addition to
        # pattern edges) so matches begin anywhere
        start_edges = {(b, d) for (s, b, d) in remap_edges if s == entry}
        for b in range(256):
            if not any(eb == b and d == entry for (eb, d) in start_edges):
                remap_edges.append((entry, b, entry))

    # compact: renumber so entry becomes 0, keep only reachable states
    order = {entry: 0}
    work = [entry]
    adj: dict[int, list[tuple[int, int]]] = {}
    for s, b, d in remap_edges:
        adj.setdefault(s, []).append((b, d))
    while work:
        s = work.pop()
        for b, d in adj.get(s, ()):  # noqa: B007
            if d not in order:
                if len(order) >= max_states:
                    raise ValueError("state budget exceeded")
                order[d] = len(order)
                work.append(d)
    if sink not in order:
        order[sink] = len(order)  # keep an accept state even if unreachable

    m = len(order)
    buf_set: set[tuple[int, int, int]] = set()
    for s, b, d in remap_edges:
        if s in order and d in order:
            buf_set.add((order[s], b, order[d]))  # closure dupes collapse
    buf = sorted(buf_set)
    offsets = np.zeros(m + 1, dtype=np.int64)
    chars = np.array([b for (_, b, _) in buf], dtype=np.uint8)
    targets = np.array([d for (_, _, d) in buf], dtype=np.int32)
    srcs = np.array([s for (s, _, _) in buf], dtype=np.int64)
    offsets[1:] = np.cumsum(np.bincount(srcs, minlength=m))
    return CsrAutomaton(offsets=offsets, trans_char=chars, trans_target=targets)


def regexes_to_csr(
    patterns,
    truncate_at_accept: bool = True,
) -> tuple[CsrAutomaton, np.ndarray]:
    """Compile a SET of patterns into one reference-convention CSR NFA —
    the ruleset-compiler the reference ecosystem never published (its
    shipped `.coe` images are multi-rule automata of exactly this shape,
    SURVEY.md SS0/SS2.3).

    Each pattern keeps its own accept states, so the per-state match
    histogram attributes every match to its rule — the reference testbench's
    per-state counters (``testbench_BLK_Mem.sv:61-69``) become per-rule
    counters.  Returns ``(automaton, owner)`` where ``owner[s]`` is the
    pattern index owning state ``s`` (-1 for the shared hub state 0).

    Merging the per-pattern hubs into one state 0 is exact: every pattern
    automaton is unanchored, so state 0 self-loops on all bytes and stays
    active forever (the shipped rulesets' structure, SURVEY.md SS2.3) —
    extra in-edges to the merged hub change nothing.  The same argument
    holds when EVERY pattern is ``^``-anchored (no hub self-loops at all;
    state 0 is active exactly once).  MIXING anchored and unanchored rules
    in one ruleset is unsound (the unanchored rules keep the hub alive,
    which would re-fire the anchored rules at every byte) and raises.
    """
    anchored = [parse_pattern(p).start_anchored for p in patterns]
    if any(anchored) and not all(anchored):
        raise ValueError(
            "cannot mix ^-anchored and unanchored rules in one CSR "
            "ruleset: the shared always-active hub state would re-fire "
            "anchored rules at every byte — compile them as separate "
            "rulesets"
        )
    auts = [
        regex_to_csr(p, unanchored=True, truncate_at_accept=truncate_at_accept)
        for p in patterns
    ]
    owner = [-1]  # merged hub
    edges: set[tuple[int, int, int]] = set()
    next_id = 1
    for i, a in enumerate(auts):
        n = a.num_states
        remap = {0: 0}
        for s in range(1, n):
            remap[s] = next_id
            owner.append(i)
            next_id += 1
        for s in range(n):
            lo, hi = int(a.offsets[s]), int(a.offsets[s + 1])
            for j in range(lo, hi):
                edges.add((
                    remap[s],
                    int(a.trans_char[j]),
                    remap[int(a.trans_target[j])],
                ))
    buf = sorted(edges)
    m = next_id
    offsets = np.zeros(m + 1, dtype=np.int64)
    srcs = np.array([s for (s, _, _) in buf], dtype=np.int64)
    offsets[1:] = np.cumsum(np.bincount(srcs, minlength=m))
    aut = CsrAutomaton(
        offsets=offsets,
        trans_char=np.array([b for (_, b, _) in buf], dtype=np.uint8),
        trans_target=np.array([d for (_, _, d) in buf], dtype=np.int32),
    )
    return aut, np.asarray(owner, dtype=np.int64)


def export_coe(pattern: str | bytes, path: str, **kw) -> CsrAutomaton:
    """Compile and write a reference-format `.coe` memory image."""
    aut = regex_to_csr(pattern, **kw)
    write_coe(path, aut.to_words())
    return aut
