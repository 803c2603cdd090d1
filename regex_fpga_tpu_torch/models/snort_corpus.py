"""Community-scale synthetic Snort ruleset + traffic generator.

The reference's own ruleset images derive from real Snort rules at
thousands-of-rules scale (``Block_Mem/CSR_BlockMem_snort_16.coe``:
9,514 states compiled from Snort rules, SURVEY.md §2.1 #14), but the
community rules are not bundled with the repository, so this module
generates a FAITHFUL-SCALE stand-in: ~3,000 deterministic rules whose
shape distribution mirrors the Snort 2.9 community ruleset —

* ~45% HTTP rules (``http_uri``/``http_header``/``http_client_body``
  contents, ``nocase``, pcre with ``/U``-style buffer flags that fall
  outside the compiler subset, ``flow:to_server,established``),
* ~20% ordered multi-content TCP rules with ``distance``/``within``
  chains and negated contents,
* ~20% binary-protocol rules (``|hex|`` contents, ``offset``/``depth``,
  ``byte_test``/``byte_jump``/``byte_extract``+``isdataat``, ``dsize``),
* ~15% miscellaneous: pcre-only rules, ``flowbits``/``threshold``/
  ``urilen`` (realistically unparsed → partial), ``fast_pattern`` hints.

Everything is seeded (``numpy.random.default_rng``) so tests, the bench
(``bench.py`` snort_scale section) and PARITY.md all describe the same
corpus.  The traffic generator plants a known subset of attacks into
HTTP/binary payloads so end-to-end alert recall is assertable.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = ["gen_community_rules", "gen_traffic", "DEFAULT_N_RULES"]

DEFAULT_N_RULES = 3000

# vocabulary pools (community-rules flavored)
_URI_DIRS = [
    "/cgi-bin/", "/admin/", "/wp-content/plugins/", "/scripts/",
    "/phpmyadmin/", "/manager/html/", "/api/v1/", "/owa/", "/uddi/",
    "/jmx-console/", "/struts/", "/cfide/", "/wls-wsat/", "/solr/",
    "/console/", "/vendor/", "/includes/", "/modules/", "/plugins/",
]
_URI_FILES = [
    "login.php", "setup.cgi", "upload.asp", "shell.jsp", "config.xml",
    "index.action", "admin.cgi", "test.php", "db.sql", "backup.tar",
    "wp-login.php", "xmlrpc.php", "cmd.exe", "root.exe", "passwd",
]
_PARAMS = ["id", "cmd", "action", "user", "file", "page", "query", "path"]
_AGENTS = [
    "sqlmap", "nikto", "masscan", "python-requests", "zgrab", "nmap",
    "Wget/1.", "curl/7.", "MSIE 6.0", "evilbot",
]
_BODY_TOKENS = [
    "union select", "<script>alert", "base64_decode(", "eval(",
    "exec(", "powershell -enc", "/bin/sh -i", "SELECT * FROM",
    "../../../../etc/passwd", "javascript:",
]
_HEX_MAGIC = [
    "|FF 53 4D 42|", "|03 00 00 0B|", "|00 01 86 A0|", "|4D 5A 90 00|",
    "|7F 45 4C 46|", "|CA FE BA BE|", "|DE AD BE EF|", "|01 01 08 0A|",
]
_CLASSTYPES = [
    "web-application-attack", "attempted-admin", "trojan-activity",
    "attempted-recon", "policy-violation", "attempted-user",
    "protocol-command-decode",
]


def _msg(i: int, fam: str) -> str:
    return f'msg:"SYNTH {fam} rule {i}"'


def _http_rule(i: int, rng) -> str:
    d = _URI_DIRS[int(rng.integers(len(_URI_DIRS)))]
    f = _URI_FILES[int(rng.integers(len(_URI_FILES)))]
    if rng.random() < 0.7:
        # most community contents are rule-specific paths — embed the
        # rule index so the literal set reaches faithful distinct-count
        # scale (a pure pool would dedup to ~450 literals; the real
        # ruleset has thousands)
        stem, _, ext = f.partition(".")
        f = f"{stem}{i}" + (f".{ext}" if ext else "")
    opts = ['flow:to_server,established',
            f'content:"{d}{f}"; http_uri']
    r = rng.random()
    if r < 0.35:
        opts[-1] += "; nocase"
    if rng.random() < 0.4:
        p = _PARAMS[int(rng.integers(len(_PARAMS)))]
        opts.append(f'content:"{p}="; http_uri; distance:0')
    if rng.random() < 0.3:
        a = _AGENTS[int(rng.integers(len(_AGENTS)))]
        opts.append(f'content:"User-Agent|3A| {a}"; http_header; nocase')
    pr = rng.random()
    if pr < 0.15:
        # community style /U (uri-buffer pcre) — outside the subset,
        # classifies partial, exactly as the real ruleset would here
        opts.append(r'pcre:"/\.(php|asp|jsp)\?\w+=/U"')
    elif pr < 0.3:
        p = _PARAMS[int(rng.integers(len(_PARAMS)))]
        opts.append(f'pcre:"/{p}=[0-9]{{1,8}}/i"')
    opts.append(f"classtype:{_CLASSTYPES[i % len(_CLASSTYPES)]}")
    opts.append(f"sid:{100000 + i}; rev:{1 + i % 5}")
    return ("alert tcp $EXTERNAL_NET any -> $HOME_NET $HTTP_PORTS ("
            + _msg(i, "http") + "; " + "; ".join(opts) + ";)")


def _body_rule(i: int, rng) -> str:
    t = _BODY_TOKENS[int(rng.integers(len(_BODY_TOKENS)))]
    p = _PARAMS[int(rng.integers(len(_PARAMS)))]
    opts = ['flow:to_server,established',
            f'content:"{p}="; http_client_body',
            f'content:"{t}"; http_client_body; distance:0; nocase']
    if rng.random() < 0.25:
        opts.append('content:!"multipart/form-data"; http_header')
    opts.append(f"sid:{100000 + i}")
    return ("alert tcp $EXTERNAL_NET any -> $HOME_NET $HTTP_PORTS ("
            + _msg(i, "body") + "; " + "; ".join(opts) + ";)")


def _chain_rule(i: int, rng) -> str:
    a = _BODY_TOKENS[int(rng.integers(len(_BODY_TOKENS)))]
    if rng.random() < 0.5:
        a = f"{a} v{i}"  # rule-specific variant (distinct-literal scale)
    w = int(rng.integers(8, 64))
    d = int(rng.integers(0, 8))
    opts = [f'content:"{a}"; nocase',
            f'content:"{_PARAMS[i % len(_PARAMS)]}{i % 331}"; '
            f'distance:{d}; within:{w}']
    if rng.random() < 0.35:
        opts.append('content:!"Referer|3A|"; nocase')
    if rng.random() < 0.3:
        opts.append(f"dsize:>{int(rng.integers(32, 512))}")
    opts.append(f"sid:{100000 + i}")
    return ("alert tcp any any -> $HOME_NET any ("
            + _msg(i, "chain") + "; " + "; ".join(opts) + ";)")


def _binary_rule(i: int, rng) -> str:
    m = _HEX_MAGIC[int(rng.integers(len(_HEX_MAGIC)))]
    opts = [f'content:"{m}"; offset:0; depth:8']
    r = rng.random()
    if r < 0.3:
        opts.append(
            f'byte_test:{int(rng.integers(1, 5))},>,'
            f'{int(rng.integers(64, 4096))},{int(rng.integers(0, 16))},'
            f'relative')
    elif r < 0.5:
        opts.append(
            f'byte_jump:4,{int(rng.integers(4, 16))},relative,align')
        opts.append(f'content:"{_HEX_MAGIC[(i + 1) % len(_HEX_MAGIC)]}"; '
                    f'within:{int(rng.integers(16, 64))}')
    elif r < 0.65:
        opts.append('byte_extract:2,2,rec_len,relative')
        opts.append('isdataat:rec_len,relative')
    if rng.random() < 0.4:
        opts.append(f"dsize:>{int(rng.integers(16, 128))}")
    opts.append(f"sid:{100000 + i}")
    return ("alert tcp $EXTERNAL_NET any -> $HOME_NET any ("
            + _msg(i, "bin") + "; " + "; ".join(opts) + ";)")


def _misc_rule(i: int, rng) -> str:
    r = rng.random()
    if r < 0.3:
        body = (f'pcre:"/admin[0-9]{{2,6}}/{"i" if i % 2 else ""}"; '
                f"sid:{100000 + i}")
    elif r < 0.5:
        # stateful options outside the payload matcher: partial, flagged
        body = (f'flowbits:isset,synth.bit{i % 7}; content:"/track{i % 97}"; '
                f"sid:{100000 + i}")
    elif r < 0.7:
        body = (f'content:"GET "; depth:4; urilen:>{int(rng.integers(64, 512))}; '
                f"sid:{100000 + i}")
    elif r < 0.85:
        body = (f'content:"{_AGENTS[i % len(_AGENTS)]}"; nocase; fast_pattern; '
                f'threshold:type limit, track by_src, count 1, seconds 60; '
                f"sid:{100000 + i}")
    else:
        d = _URI_DIRS[i % len(_URI_DIRS)]
        body = (f'content:"{d}"; http_raw_uri; content:"%2e%2e"; '
                f'http_raw_uri; distance:0; '
                f"sid:{100000 + i}")
    return ("alert tcp any any -> any any ("
            + _msg(i, "misc") + "; " + body + ";)")


def gen_community_rules(n_rules: int = DEFAULT_N_RULES, seed: int = 7
                        ) -> str:
    """Deterministic community-scale ruleset text (see module header)."""
    rng = np.random.default_rng(seed)
    lines = [
        "# synthetic community-scale corpus (offline stand-in; "
        "models/snort_corpus.py)",
        "var HOME_NET 10.0.0.0/8",
    ]
    fams = [(_http_rule, 0.45), (_chain_rule, 0.20), (_binary_rule, 0.20),
            (_body_rule, 0.07), (_misc_rule, 0.08)]
    cum = np.cumsum([w for _, w in fams])
    for i in range(n_rules):
        x = rng.random() * cum[-1]
        fn = fams[int(np.searchsorted(cum, x))][0]
        lines.append(fn(i, rng))
    return "\n".join(lines) + "\n"


# --------------------------------------------------------------------------
# traffic


@functools.lru_cache(maxsize=1)
def _default_corpus_attacks() -> tuple:
    """Plantable attacks recovered from the DEFAULT corpus's own rules
    (keeps corpus and traffic in sync); parsed once — callers invoke
    ``gen_traffic`` repeatedly (tests + bench) and re-parsing the 3,000
    rules per call measured ~0.3 s each."""
    from .snort import parse_snort_rules

    rules = parse_snort_rules(gen_community_rules())
    out = []
    for r in rules:
        cs = [c for c in r.contents if not c.negated]
        if (len(cs) == 1 and cs[0].buffer == "uri" and not r.pcre
                and not r.verify_ops[1:]):
            out.append((r.sid, cs[0].pattern))
        if len(out) >= 40:
            break
    return tuple(out)


def gen_traffic(n_payloads: int = 400, seed: int = 11,
                attack_every: int = 10):
    """(payloads, planted) — a traffic-like mix of benign HTTP requests,
    binary blobs and random noise, with a known attack planted into every
    ``attack_every``-th payload.  ``planted`` maps payload index → the
    sid that must alert there (rules from ``gen_community_rules`` with
    the same default seed)."""
    rng = np.random.default_rng(seed)
    payloads: list[bytes] = []
    planted: dict[int, int] = {}
    http_attacks = _default_corpus_attacks()
    for i in range(n_payloads):
        kind = rng.random()
        if i % attack_every == 0 and http_attacks:
            sid, pat = http_attacks[int(rng.integers(len(http_attacks)))]
            uri = pat.decode("latin-1")
            payloads.append(
                (f"GET {uri}?x={int(rng.integers(1e6))} HTTP/1.1\r\n"
                 f"Host: victim{i}.example\r\n\r\n").encode())
            planted[i] = sid
        elif kind < 0.6:
            d = _URI_DIRS[int(rng.integers(len(_URI_DIRS)))]
            payloads.append(
                (f"GET {d}page{int(rng.integers(999))}.html HTTP/1.1\r\n"
                 f"Host: ok{i}.example\r\n"
                 f"User-Agent: Mozilla/5.0 (bench)\r\n\r\n").encode())
        elif kind < 0.8:
            body = rng.integers(0, 256, int(rng.integers(64, 1024)),
                                dtype=np.uint8).tobytes()
            payloads.append(b"\x17\x03\x03" + body)
        else:
            payloads.append(
                rng.integers(0, 256, int(rng.integers(40, 400)),
                             dtype=np.uint8).tobytes())
    return payloads, planted
