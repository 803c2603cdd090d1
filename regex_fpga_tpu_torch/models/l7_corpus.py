"""Protocol-pattern corpus at l7-filter scale (offline stand-in).

The reference's FIRST ruleset image, ``CSR_BlockMem.coe`` (2,794 states),
derives from the l7-filter protocol pattern collection (~120 ``.pat``
files of POSIX-ish regexes; the shipped trace files carry the ruleset
name, SURVEY.md §2.1 #13).  This environment is offline, so — like
``snort_corpus.py`` for the second image — this module generates a
faithful-scale stand-in: ~110 deterministic protocol patterns in the
real collection's shape mix (anchored banner greetings, binary
handshake magics, command alternations, version strings, unanchored
tokens; ~⅓ case-insensitive), each emitted as a well-formed ``.pat``
file for the ``models/l7.py`` parser, plus planted traffic so
end-to-end per-protocol attribution is assertable.
"""

from __future__ import annotations

import numpy as np

__all__ = ["gen_l7_patterns", "write_pat_dir", "gen_l7_traffic",
           "DEFAULT_N_PROTOCOLS"]

DEFAULT_N_PROTOCOLS = 110

_SYLL = ["net", "cast", "sync", "talk", "mesh", "link", "port", "data",
         "vox", "tube", "beam", "grid", "flux", "node", "pulse", "wire"]


def _name(i: int) -> str:
    return f"{_SYLL[i % len(_SYLL)]}{_SYLL[(i * 7 + 3) % len(_SYLL)]}{i}"


def _pattern(i: int, rng) -> tuple[str, str, bool, bytes]:
    """(name, pattern, ignore_case, sample_payload_that_matches)."""
    name = _name(i)
    fam = i % 5
    if fam == 0:
        # numeric banner greeting (ftp/smtp style), case-insensitive
        code = 200 + int(rng.integers(0, 500))
        pat = rf"^{code} [\x09-\x0d -~]*{name}"
        sample = f"{code} welcome to {name.upper()} service\r\n".encode()
        return name, pat, True, sample
    if fam == 1:
        # binary handshake magic (bittorrent style), anchored
        m1, m2 = int(rng.integers(1, 32)), int(rng.integers(128, 255))
        pat = rf"^\x{m1:02x}\x{m2:02x}{name}"
        sample = bytes([m1, m2]) + name.encode() + b"\x00payload"
        return name, pat, False, sample
    if fam == 2:
        # command alternation + version string (http style)
        cmds = [f"{name[:3]}get", f"{name[:3]}put", f"{name[:3]}sub"]
        pat = (rf"^({'|'.join(cmds)}) [\x20-\x7e]*{name}/"
               rf"[0-9]\.[0-9]")
        sample = (f"{cmds[int(rng.integers(0, 3))]} /index.html "
                  f"{name}/1.{int(rng.integers(0, 10))}\r\n").encode()
        return name, pat, False, sample
    if fam == 3:
        # unanchored scheme token (rtsp/sip style), case-insensitive
        pat = rf"{name}://[a-z0-9._-]+"
        sample = (f"GET {name}://host{i}.example/res "
                  f"OK\r\n").encode()
        return name, pat, True, sample
    # session header token, unanchored
    pat = rf"x-{name}-id: [0-9a-f][0-9a-f]+"
    hexid = "".join("0123456789abcdef"[int(x)]
                    for x in rng.integers(0, 16, 12))
    sample = f"HDR\r\nx-{name}-id: {hexid}\r\n\r\n".encode()
    return name, pat, False, sample


def gen_l7_patterns(n: int = DEFAULT_N_PROTOCOLS, seed: int = 13):
    """List of (name, pattern, ignore_case, sample) tuples."""
    rng = np.random.default_rng(seed)
    return [_pattern(i, rng) for i in range(n)]


def write_pat_dir(path, n: int = DEFAULT_N_PROTOCOLS, seed: int = 13):
    """Materialize the corpus as l7-filter ``.pat`` files under ``path``
    (the upstream on-disk format ``models/l7.py`` parses).  Returns the
    generated tuples."""
    import os

    pats = gen_l7_patterns(n, seed)
    for name, pat, icase, _ in pats:
        lines = [f"# synthetic l7-filter-scale pattern ({name})", name, pat]
        if icase:
            lines.append(f"userspace pattern={pat}")
            lines.append("userspace flags=REG_NOSUB REG_ICASE")
        with open(os.path.join(path, f"{name}.pat"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return pats


def gen_l7_traffic(n_payloads: int = 200, seed: int = 17,
                   n: int = DEFAULT_N_PROTOCOLS):
    """(payloads, planted): protocol samples mixed with random noise;
    ``planted`` maps payload index → protocol (rule) index."""
    rng = np.random.default_rng(seed)
    pats = gen_l7_patterns(n)
    payloads, planted = [], {}
    for i in range(n_payloads):
        if i % 3 == 0:
            ridx = int(rng.integers(0, len(pats)))
            payloads.append(pats[ridx][3])
            planted[i] = ridx
        else:
            payloads.append(
                rng.integers(0, 256, int(rng.integers(40, 400)),
                             dtype=np.uint8).tobytes())
    return payloads, planted
