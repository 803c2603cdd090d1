"""Command-line interface of the torch port: the JAX package's CLI
(``regex_fpga_tpu/__main__.py``) with the same subcommands, arguments,
output lines and exit codes, less ``corpus``, which waits for the port of
``parallel/``.

The reference's only "UI" is the testbench's final ``$display`` report
(``Simulation/testbench_BLK_Mem.sv:75-85``); the equivalents here:

  python -m regex_fpga_tpu_torch scan --coe RULESET.coe TRACE.mem [...]
      run the bit-exact NFA engine, print the per-state match histogram
  python -m regex_fpga_tpu_torch grep PATTERN FILE [...]
      scan files with a compiled DFA, print match-end offsets
  python -m regex_fpga_tpu_torch presplit FILE
      tokenizer pre-split boundaries
  python -m regex_fpga_tpu_torch conformance
      reproduce the four reference trace runs and verify the golden tables

and ``compile-rules``, ``acgrep``, ``rgrep``, ``snort`` and ``gen-corpus``.
Every matcher is built on ``--device`` (default ``cuda``, before or after
the subcommand): without a card a subcommand that builds one raises, as the
entry points do; ``--device cpu`` runs the plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def cmd_scan(args) -> int:
    from . import api
    from .utils.traces import REFERENCE_RUN_LENGTH, read_mem_trace

    m = api.compile_ruleset(args.coe, device=args.device)
    streams = []
    for path in args.traces:
        if path.endswith(".mem"):
            limit = None if args.full else REFERENCE_RUN_LENGTH
            streams.append(read_mem_trace(path, limit))
        else:
            streams.append(np.fromfile(path, dtype=np.uint8))
    rep = m.scan(streams)
    for i, path in enumerate(args.traces):
        print(f"# stream {i}: {path}")
        for state, count in sorted(rep.histogram(i).items()):
            print(f"state {state}: {count}")
    print(json.dumps({"total": rep.total, **json.loads(rep.metrics.to_json())}))
    return 0


def cmd_grep(args) -> int:
    from . import api

    m = api.compile_regex(args.pattern, device=args.device)
    status = 1
    for path in args.files:
        data = np.fromfile(path, dtype=np.uint8)
        if args.count:
            # grep -c throughput mode: k-gram engine, no per-position output
            n = m.count([data])
            if n:
                status = 0
            print(f"{path}:{n}")
            continue
        ends = m.findall_ends(data)
        if len(ends):
            status = 0
        for e in ends.tolist():
            print(f"{path}:{e}")
    return status


def cmd_compile_rules(args) -> int:
    """Compile a rule file (one regex per line, # comments) into a
    reference-format .coe ruleset image — the toolchain the reference
    ecosystem never published."""
    from . import api

    patterns = []
    for line in open(args.rules, "rb").read().splitlines():
        line = line.strip()
        if line and not line.startswith(b"#"):
            patterns.append(line)
    if not patterns:
        print("no rules found", file=sys.stderr)
        return 1
    rs = api.compile_regex_set(patterns, device=args.device)
    if rs.automaton is None:
        print("cannot export: mixed ^-anchored and unanchored rules have "
              "no single .coe image — split the rule file", file=sys.stderr)
        return 1
    rs.export_coe(args.output)
    print(
        f"{len(patterns)} rules -> {rs.automaton.num_states} states, "
        f"{len(rs.automaton.trans_char)} transitions -> {args.output}"
    )
    if args.scan:
        data = np.fromfile(args.scan, dtype=np.uint8)
        rep = rs.scan([data])
        for i, (p, c) in enumerate(zip(patterns, rep.rule_counts[0])):
            print(f"rule {i} ({p.decode('latin1')}): {int(c)} matches")
    return 0


def cmd_acgrep(args) -> int:
    """Multi-literal search (Aho–Corasick on the fast DFA engines)."""
    from . import api

    pats = [p.encode("latin1") for p in args.patterns]
    if args.patterns_file:
        for line in open(args.patterns_file, "rb").read().splitlines():
            if line and not line.startswith(b"#"):
                pats.append(line)
    m = api.compile_literals(pats, device=args.device)
    status = 1
    for path in args.files:
        data = np.fromfile(path, dtype=np.uint8)
        rep = m.scan_patterns([data])
        row = rep.pattern_counts[0]
        if row.sum():
            status = 0
        for pid, c in enumerate(row.tolist()):
            if c:
                print(f"{path}:{pats[pid].decode('latin1')}:{c}")
    return status


def cmd_rgrep(args) -> int:
    """Multi-regex search with Hyperscan-style literal prefiltering: rules
    with a required literal are guarded by one device Aho–Corasick pass, so
    clean files never pay the full NFA machinery (api.PrefilteredRuleSet)."""
    from . import api

    pats = [p.encode("latin1") for p in args.patterns]
    if args.patterns_file:
        for line in open(args.patterns_file, "rb").read().splitlines():
            line = line.strip()
            if line and not line.startswith(b"#"):
                pats.append(line)
    if not pats:
        print("no patterns given", file=sys.stderr)
        return 2
    if args.no_prefilter:
        m = api.compile_regex_set(pats, device=args.device)
    else:
        m = api.compile_regex_set_prefiltered(pats, device=args.device)
        print(f"# {m.num_prefiltered}/{m.num_rules} rules literal-prefiltered",
              file=sys.stderr)
    status = 1
    for path in args.files:
        data = np.fromfile(path, dtype=np.uint8)
        rep = m.scan([data])
        row = rep.rule_counts[0]
        if row.sum():
            status = 0
        for pid, c in enumerate(row.tolist()):
            if c:
                print(f"{path}:{pats[pid].decode('latin1')}:{c}")
    return status


def cmd_snort(args) -> int:
    """Scan files against a Snort .rules file (AC prefilter + verify).
    ``--coverage`` prints the per-rule enforcement report instead of
    scanning: which rules this pipeline enforces fully vs partially
    (content/pcre-only) and why (unenforced options, unparsed byte ops,
    pcre outside the compiler subset)."""
    from . import api

    if not args.coverage and not args.export_coe and not args.files:
        print("snort: FILES required unless --coverage or --export-coe "
              "is given", file=sys.stderr)
        return 2
    m = api.compile_snort(args.rules, device=args.device)
    print(f"# {m.num_rules} rules loaded", file=sys.stderr)
    if getattr(args, "export_coe", None):
        aut, owner, lits = m.export_coe(args.export_coe)
        print(f"# wrote {args.export_coe}: {aut.num_states} states, "
              f"{aut.num_transitions} transitions, {len(lits)} literals "
              f"(reference CSR_BlockMem format)", file=sys.stderr)
        if not args.files and not args.coverage:
            return 0
    if getattr(args, "coverage", False):
        rep = m.enforcement_report()
        s_ = rep["summary"]
        print(f"# enforced {s_['enforced']}/{s_['total']} rules fully; "
              f"{s_['partial']} partial "
              f"({s_['byte_ops_unparsed']} unparsed byte ops, "
              f"{s_['pcre_outside_subset']} pcre outside subset)",
              file=sys.stderr)
        for row in rep["rules"]:
            if args.partial_only and row["status"] == "enforced":
                continue
            print(json.dumps(row))
        return 0
    any_alert = False
    for path in args.files:
        data = np.fromfile(path, dtype=np.uint8)
        rep = m.scan([data])
        for a in rep.alerts[0]:
            any_alert = True
            sid = a.sid if a.sid is not None else "-"
            tag = "" if a.pcre_checked else (
                " [content-only]" if m.rules[a.rule_index].pcre else "")
            print(f"{path}: sid={sid} {a.msg}{tag}")
    return 0 if any_alert else 1


def cmd_gen_corpus(args) -> int:
    """Materialize the deterministic offline corpora used by the at-scale
    tests and the bench (same seeds, same content)."""
    if args.kind == "snort":
        from .models.snort_corpus import DEFAULT_N_RULES, gen_community_rules

        text = gen_community_rules(args.n or DEFAULT_N_RULES)
        with open(args.out, "w") as f:
            f.write(text)
        print(f"# wrote {args.out}: {text.count(chr(10)) - 2} rules",
              file=sys.stderr)
        return 0
    from .models.l7_corpus import DEFAULT_N_PROTOCOLS, write_pat_dir

    os.makedirs(args.out, exist_ok=True)
    pats = write_pat_dir(args.out, args.n or DEFAULT_N_PROTOCOLS)
    print(f"# wrote {len(pats)} .pat files under {args.out}",
          file=sys.stderr)
    return 0


def cmd_presplit(args) -> int:
    from . import api

    tok = api.compile_tokenizer(device=args.device)
    data = open(args.file, "rb").read()
    for piece in tok.pieces(data):
        sys.stdout.buffer.write(piece)
        sys.stdout.buffer.write(b"\n")
    return 0


def cmd_conformance(args) -> int:
    """The four-trace bit-exact gate (SURVEY.md SS4.2) as a CLI check.

    Diffs the COMPLETE per-state histogram of every trace/ruleset combo
    against the committed golden tables (models/golden_histograms.json) —
    the full testbench printout (testbench_BLK_Mem.sv:75-85), not totals.
    Without the reference fixtures it says so and returns 1.
    """
    from . import api
    from .models import load_golden_histograms
    from .utils.traces import RULESETS, load_trace_pair, reference_root

    if not os.path.isdir(reference_root()):
        print(f"conformance: no reference fixtures under {reference_root()} "
              f"(set REGEX_FPGA_REFERENCE)", file=sys.stderr)
        return 1
    golden = load_golden_histograms()
    ok = True
    for name, (coe_rel, _, _) in RULESETS.items():
        m = api.compile_ruleset(os.path.join(reference_root(), coe_rel),
                                device=args.device)
        lo, hi = load_trace_pair(name)
        rep = m.scan([lo, hi])
        for i, sname in enumerate(("lo", "hi")):
            counts = rep.counts[i]
            got = {int(s): int(c) for s, c in enumerate(counts) if c}
            want = golden[f"{name}/{sname}"]["histogram"]
            if got == want:
                print(f"{name}/{sname}: {sum(got.values())} matches over "
                      f"{len(got)} states — full histogram exact ok")
                continue
            ok = False
            missing = {s: c for s, c in want.items() if got.get(s) != c}
            extra = {s: c for s, c in got.items() if s not in want}
            print(f"{name}/{sname}: FAIL — "
                  f"{len(missing)} states wrong/missing "
                  f"(e.g. {dict(list(missing.items())[:5])}), "
                  f"{len(extra)} unexpected "
                  f"(e.g. {dict(list(extra.items())[:5])})")
    return 0 if ok else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="regex_fpga_tpu_torch")
    p.add_argument("--device", default="cuda",
                   help="torch device of the matchers (default: cuda; "
                        "cpu runs the plain PyTorch versions)")
    # --device is also taken after the subcommand; SUPPRESS keeps a
    # subcommand from overwriting a value given before it
    dev = argparse.ArgumentParser(add_help=False)
    dev.add_argument("--device", default=argparse.SUPPRESS,
                     help=argparse.SUPPRESS)
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_parser(name, **kw):
        return sub.add_parser(name, parents=[dev], **kw)

    s = add_parser("scan", help="scan traces with a .coe ruleset (NFA engine)")
    s.add_argument("--coe", required=True)
    s.add_argument("--full", action="store_true",
                   help="scan whole traces (default: the reference harness's "
                        "200,000-char limit)")
    s.add_argument("traces", nargs="+")
    s.set_defaults(fn=cmd_scan)

    s = add_parser("grep", help="scan files with a regex (DFA engine)")
    s.add_argument("pattern")
    s.add_argument("files", nargs="+")
    s.add_argument(
        "-c", "--count", action="store_true",
        help="print match-EVENT counts only (accept-state visits, the "
             "reference FPGA's counting semantics) via the k-gram "
             "throughput engine; use plain grep for span offsets",
    )
    s.set_defaults(fn=cmd_grep)

    s = add_parser(
        "compile-rules",
        help="compile a rule file (one regex/line) to a .coe ruleset",
    )
    s.add_argument("rules")
    s.add_argument("-o", "--output", required=True)
    s.add_argument("--scan", help="optionally scan a file and report per-rule counts")
    s.set_defaults(fn=cmd_compile_rules)

    s = add_parser(
        "acgrep", help="multi-literal search (Aho-Corasick, fast DFA engines)"
    )
    s.add_argument("-f", "--patterns-file",
                   help="file with one literal per line (# comments)")
    s.add_argument("-e", dest="patterns", action="append", default=[],
                   metavar="LITERAL", help="literal pattern (repeatable)")
    s.add_argument("files", nargs="+")
    s.set_defaults(fn=cmd_acgrep)

    s = add_parser(
        "rgrep",
        help="multi-regex search with literal prefiltering (Hyperscan-style)",
    )
    s.add_argument("-f", "--patterns-file",
                   help="file with one regex per line (# comments)")
    s.add_argument("-e", dest="patterns", action="append", default=[],
                   metavar="REGEX", help="regex pattern (repeatable)")
    s.add_argument("--no-prefilter", action="store_true",
                   help="skip the Aho-Corasick literal prefilter")
    s.add_argument("files", nargs="+")
    s.set_defaults(fn=cmd_rgrep)

    s = add_parser(
        "snort", help="scan files against a Snort .rules file"
    )
    s.add_argument("rules")
    s.add_argument("files", nargs="*", default=[])
    s.add_argument(
        "--coverage", action="store_true",
        help="print the per-rule enforcement report (JSON lines) instead "
             "of scanning",
    )
    s.add_argument(
        "--partial-only", action="store_true",
        help="with --coverage: show only partially-enforced rules",
    )
    s.add_argument(
        "--export-coe", metavar="PATH",
        help="write the ruleset's content literals as a reference-format "
             ".coe memory image (the unpublished 'rules -> CSR_BlockMem' "
             "pipeline)",
    )
    s.set_defaults(fn=cmd_snort)

    s = add_parser(
        "gen-corpus",
        help="write the offline community-scale rule corpora "
             "(models/snort_corpus.py / models/l7_corpus.py)",
    )
    s.add_argument("kind", choices=["snort", "l7"])
    s.add_argument("out", help="snort: .rules file path; l7: directory")
    s.add_argument("-n", type=int, default=None,
                   help="rule/protocol count (defaults per corpus)")
    s.set_defaults(fn=cmd_gen_corpus)

    s = add_parser("presplit", help="tokenizer pre-split a file")
    s.add_argument("file")
    s.set_defaults(fn=cmd_presplit)

    s = add_parser("conformance", help="run the reference conformance gate")
    s.set_defaults(fn=cmd_conformance)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
