"""The port's Snort matcher (regex_fpga_tpu_torch.api.SnortMatcher,
compile_snort) against regex_fpga_tpu.api on the CPU: stage 1 on the plain
versions of the literal engines (K2's plain version), stage 2 on the host.
Every rule text and payload of tests/test_snort.py (and the Snort cases of
tests/test_ingest_cli.py and tests/test_pos_endpos.py) is a case. Tolerance:
none; alerts (rule index, sid, msg, pcre_checked), prefilter candidates,
enforcement reports, verify results, converted values and exported words must
be equal."""

import functools
import random

import numpy as np
import pytest

from regex_fpga_tpu import api as japi
from regex_fpga_tpu.models import snort as jsnort
from regex_fpga_tpu.models.snort_corpus import gen_community_rules, gen_traffic
from regex_fpga_tpu.utils.config import EngineConfig
from regex_fpga_tpu_torch import api as tapi
from regex_fpga_tpu_torch.models import snort as tsnort

from test_snort import (BYTE_RULES, COMMUNITY_SAMPLE, EXTRACT_RULES,
                        HTTP_RULES, POSITIONAL_RULES, RULES, _req)


def rule(body: str) -> str:
    return f"alert tcp any any -> any any ({body})\n"


BIG = (b"GET /index.html HTTP/1.0\r\nHost: www.example.com\r\n"
       b"Accept: */*\r\n\r\n" + b"x" * 397) * 3000

# rules text -> the payloads tests/test_snort.py scans it with
GROUPS = {
    "basic": (RULES, [
        b"GET /scripts/CMD.EXE?/c+dir HTTP/1.0", b"...cmd.exe...", b"cmd_exe",
        b"xx\x90\x90\x90\x90yy", b"xx\x90\x90\x90yy", b"GET /index.php HTTP/1.1",
        b".php then GET /plain HTTP/1.1", b"POST /x HTTP/1.1\r\n\r\n",
        b"POST /x\r\nContent-Length: 3\r\n", b"GET /a?user=123 HTTP/1.1",
        b"GET /a?user=123", b"GET /a?user=abc", b"log Admin42 in",
        b"log adminXY in", b"GET /index.html HTTP/1.1\r\nHost: x\r\n\r\n",
        b"USER root\r\n"]),
    "file": (rule('msg:"t"; content:"abc"; sid:1;'), [b"xxabcxx"]),
    "positional": (POSITIONAL_RULES, [
        b"xxxxEXE", b"xxxxxxEXE", b"EXExxxx", b"GET /x", b" GET /x", b"..AB..",
        b"....AB", b"AB....", b".....AB", b"USER root", b"USER   root",
        b"USERroot", b"AA..BB", b"AA...BB", b"AA......AA..BB", b"HDR....XX",
        b"HDRXX....", b"HDR..XX..", b"HDR....", b"......V"]),
    "byte": (BYTE_RULES, [
        b"HDR." + (200).to_bytes(2, "big"), b"HDR." + (100).to_bytes(2, "big"),
        b"HDR.\x01", b"..LEN\x02\x01..", b"..LEN\x01\x02..", b"n=501;", b"n=500",
        b"n=499;", b"n=xx;", b"FLG\x81", b"FLG\x7f", b"NEG\x01", b"NEG\x00",
        b"BM\x5a", b"BM\x6a", b"JMP\x02..X", b"JMP\x02.X.", b"JMP\x63X",
        b"AL\x03" + b"." * 8 + b"Y", b"AL\x03" + b"." * 6 + b"Y..",
        b"FB\x04.Z..", b"FB\x04Z...", b"S:12" + b"." * 12 + b"Q",
        b"S:12" + b"." * 11 + b"Q.", b"DCE\x00\x00"]),
    "byte-flip": (
        rule('msg:"len guard"; content:"CMD"; byte_test:1,>,9,0,relative; '
             'sid:9400;')
        + rule('msg:"tlv walk"; content:"TLV"; byte_jump:1,0,relative; '
               'content:"END"; distance:0; within:3; sid:9401;'),
        [b"CMD\x0a", b"CMD\x05", b"TLV\x04....END", b"TLV\x02....END"]),
    "extract": (EXTRACT_RULES, [
        b"LEN\x05\x09", b"LEN\x05\x03", b"LEN", b"HDR\x05..END", b"HDR\x03..END",
        b"n=24" + b"x" * 49, b"n=24" + b"x" * 40, b"AB12345", b"AB123",
        b"xSHORT123", b"xSHORT12345", b"UV\x00"]),
    "pcre-boundary-dotall": (
        rule(r'msg:"wb"; content:"cat"; pcre:"/\bcat\b/"; sid:8000;')
        + rule('msg:"dotall"; content:"a"; pcre:"/a.b/s"; sid:8100;'),
        [b"the cat sat", b"concatenate", b"a\nb"]),
    # a pcre nested past the parser's recursion: RecursionError, not a
    # RegexError, files the rule as outside the subset on both sides
    "pcre-deep-nesting": (
        rule('msg:"deep"; content:"aaa"; pcre:"/' + "(" * 500 + "a"
             + ")" * 500 + '/"; sid:8200;')
        + rule('msg:"plain"; content:"aab"; pcre:"/a+b/"; sid:8201;'),
        [b"xaaay", b"aab", b"aaab", b"bbb"]),
    "community": (COMMUNITY_SAMPLE, [
        b"\x00" + (0x20000).to_bytes(3, "big") + b"SMB",
        b"\x00" + (0x100).to_bytes(3, "big") + b"SMB",
        b"\x18\x03\x02" + (0x4001).to_bytes(2, "big") + b"\x01",
        b"\x18\x03\x02" + (0x10).to_bytes(2, "big") + b"\x01",
        b"PORT 231,0,0,1,8,1\r\n", b"PORT 192,0,0,1,8,1\r\n",
        b"GET /scripts/..%255c../winnt/system32/CMD.exe?/c+dir HTTP/1.0",
        b"GET /cgi-bin/view?file=/etc/passwd HTTP/1.0",
        b"GET /index.php?page=http://evil.example/shell.txt",
        b"SITE exec /bin/sh -c id\r\n", b"USER " + b"A" * 150 + b"\r\n",
        b"\x12\x34\x00\x00\xfc\x00\x01", b"EXEC master..XP_CMDSHELL 'dir'",
        b"GET /q?=SELECT name FROM users HTTP/1.0",
        b"<html><SCRIPT>alert(1)</script>", b"NICK bot123\r\nJOIN #botnet99 key\r\n",
        b"SSH-1.99-OpenSSH_2.9\n", b"CONNECT evil.example:443 HTTP/1.1",
        b"CONNECT localhost:443 HTTP/1.1", b"USER " + b"A" * 150,
        b"USER " + b"A" * 100, b"USER " + b"A" * 99, b"JOIN #abc", b"",
        BIG[:700_000] + b"GET /q?=SELECT name FROM users HTTP/1.0\r\n"
        + BIG[700_000:] + b"USER " + b"B" * 150 + b"\r\n"]),
    "greedy": (rule('msg:"p"; content:"AA"; content:"BB"; sid:1;'),
               [b"BB" + b"AA" * 200_000]),
    "within": (rule('msg:"w"; content:"AA"; content:"BB"; within:4; sid:2;'),
               [b"AA......AA..BB "]),
    "window-backtracking": (
        rule('msg:"w"; content:"AA"; content:"BB"; within:4; sid:3;'),
        [b"A" * 320_000 + b"CCCCBB", b"A" * 1000 + b"AABB"]),
    "coverage": (
        rule('msg:"a"; content:"X"; byte_test:1,>,2,0,dce; sid:1;')
        + rule('msg:"b"; content:"Y"; flow:to_server; sid:2;')
        + rule('msg:"c"; content:"Z"; sid:3;'), [b"X\x09 Y Z"]),
    "var-after-content": (rule('msg:"x"; content:"B"; byte_extract:1,0,w; '
                               'within:w; sid:11;'), [b"B\x09xxx"]),
    "var-before-content": (rule('msg:"y"; content:"H"; byte_extract:1,0,w; '
                                'content:"V"; within:w; sid:12;'),
                           [b"H\x04..V", b"H\x01..V"]),
    "undefined-var": (rule('msg:"v"; content:"V"; depth:varlen; sid:9006;'),
                      [b"......V"]),
    "cli": (
        'alert tcp any any -> any 80 (msg:"cmd.exe access"; '
        'content:"cmd.exe"; nocase; sid:1002;)\n'
        'alert tcp any any -> any 80 (msg:"with pcre"; content:"user="; '
        'pcre:"/user=[0-9]+/"; sid:6000;)\n',
        [b"GET /scripts/CMD.EXE?/c dir HTTP/1.0 user=99", b"nothing to see"]),
    "http": (HTTP_RULES, [
        _req(uri=b"/a/../etc/passwd"), _req(body=b"see ../ here"),
        b"random ../ bytes", _req(method=b"POST"), _req(uri=b"/POST"),
        _req(headers=b"user-agent: EVIL\r\nHost: x\r\n"),
        _req(body=b"User-Agent: evil"), _req(method=b"POST", body=b"a=1&cmd=ls"),
        _req(uri=b"/cmd=ls"), _req(headers=b"Cookie: SESSID=abc\r\n"),
        _req(headers=b"X-Note: SESSID=abc\r\n"), _req(uri=b"/admin/login.php"),
        _req(uri=b"/login.php/admin"), _req(uri=b"/index.html"),
        _req(uri=b"/index-cgi"), _req(uri=b"/index", body=b"cgi"),
        _req(uri=b"/x/zzz"), _req(uri=b"/z/x"), _req(uri=b"/y")]),
    "buffer-negation-window": (
        'alert tcp any any -> any 80 (msg:"n"; content:"/index"; http_uri; '
        'content:!"X"; http_uri; within:100; sid:21;)',
        [b"GET /index.html HTTP/1.1\r\nX: 1\r\n\r\n",
         b"GET /indexX HTTP/1.1\r\nA: 1\r\n\r\n"]),
    "buffer-byte-op-ordering": (
        'alert tcp any any -> any 80 (msg:"a"; content:"ndex"; '
        'byte_test:1,=,46,0,relative; http_uri; sid:1;)\n'
        'alert tcp any any -> any 80 (msg:"b"; content:"/y"; http_uri; '
        'isdataat:1; byte_test:1,>,2,0,relative; sid:2;)\n'
        'alert tcp any any -> any 80 (msg:"c"; content:"/y"; http_uri; '
        'byte_test:1,>,2,4; sid:3;)\n'
        'alert tcp any any -> any 80 (msg:"d"; content:"/y"; http_uri; '
        'content:"Host"; byte_test:1,>,2,0,relative; sid:4;)\n',
        [b"GET /index.html HTTP/1.1\r\n\r\n",
         b"GET /y HTTP/1.1\r\nHost: zz\r\n\r\n"]),
    "cross-buffer": (
        'alert tcp any any -> any 80 (msg:"x"; content:"/admin"; http_uri; '
        'content:"evil"; distance:0; sid:31;)\n'
        'alert tcp any any -> any 80 (msg:"y"; content:"GET"; http_method; '
        'content:"sess"; http_cookie; distance:2; sid:32;)\n',
        [b"GET /admin HTTP/1.1\r\n\r\nevil", b"GET /admin HTTP/1.1\r\n\r\nfine"]),
    "dropped-extract": (
        'alert tcp any any -> any 80 (msg:"e"; content:"/y"; http_uri; '
        'byte_extract:1,0,v,relative; byte_test:1,>,v,4; sid:5;)',
        [b"GET /y HTTP/1.1\r\n\r\n"]),
    "dsize": (
        rule('msg:"eq"; content:"A"; dsize:5; sid:41;')
        + rule('msg:"gt"; content:"A"; dsize:>10; sid:42;')
        + rule('msg:"lt"; content:"A"; dsize:<4; sid:43;')
        + rule('msg:"rng"; content:"A"; dsize:3<>6; sid:44;')
        + rule('msg:"var"; content:"A"; dsize:oops; sid:45;'),
        [b"A" * 5, b"A" * 3, b"A" * 6, b"A" * 11, b"A" * 10]),
    "dead-extract-offset": (
        'alert tcp any any -> any 80 (msg:"d"; content:"/y"; http_uri; '
        'byte_extract:1,0,v,relative; content:"zz"; offset:v; sid:61;)',
        [b"GET /y HTTP/1.1\r\nX: zz\r\n\r\n"]),
    "negated-cross-buffer": (
        'alert tcp any any -> any 80 (msg:"n"; content:"/y"; http_uri; '
        'content:!"bad"; distance:0; within:3; sid:62;)',
        [b"GET /y HTTP/1.1\r\nX: bad\r\n\r\n"]),
    "uri-normalized": (
        'alert tcp any any -> any 80 (msg:"u"; content:"/admin/login"; '
        'http_uri; sid:71;)',
        [b"GET /admin/login HTTP/1.1\r\n\r\n",
         b"GET /%61dmin/login HTTP/1.1\r\n\r\n",
         b"GET /x/../admin/./login HTTP/1.1\r\n\r\n",
         b"GET /other HTTP/1.1\r\nX: /admin/login\r\n\r\n"]),
    "raw-uri": (
        'alert tcp any any -> any 80 (msg:"r"; content:"%61dmin"; '
        'http_raw_uri; sid:72;)\n'
        'alert tcp any any -> any 80 (msg:"n"; content:"admin"; '
        'http_uri; sid:73;)',
        [b"GET /%61dmin HTTP/1.1\r\n\r\n", b"GET /admin HTTP/1.1\r\n\r\n"]),
    "uri-nocase-windows": (
        'alert tcp any any -> any 80 (msg:"nc"; content:"ADMIN"; '
        'http_uri; nocase; sid:74;)\n'
        'alert tcp any any -> any 80 (msg:"w"; content:"/a"; http_uri; '
        'content:"secret"; http_uri; distance:0; within:8; sid:75;)',
        [b"GET /%41dMiN HTTP/1.1\r\n\r\n", b"GET /%61__secret HTTP/1.1\r\n\r\n",
         b"GET /%61_________secret HTTP/1.1\r\n\r\n"]),
    "uri-gate": (
        'alert tcp any any -> any 80 (msg:"p"; content:"/hidden"; '
        'http_uri; sid:76;)', [b"GET /%68idden HTTP/1.1\r\n\r\n"]),
    "uri-negation": (
        'alert tcp any any -> any 80 (msg:"ng"; content:"/app"; '
        'http_uri; content:!"debug"; http_uri; sid:77;)',
        [b"GET /app/run HTTP/1.1\r\n\r\n", b"GET /app/%64ebug HTTP/1.1\r\n\r\n",
         b"GET /app HTTP/1.1\r\nX: debug\r\n\r\n"]),
    "urilen": (
        'alert tcp any any -> any 80 (msg:"gt"; content:"GET "; depth:4; '
        'urilen:>10; sid:81;)\n'
        'alert tcp any any -> any 80 (msg:"rng"; urilen:3<>8; content:"GET "; '
        'sid:82;)\n'
        'alert tcp any any -> any 80 (msg:"raw"; urilen:>10,raw; '
        'content:"GET "; sid:83;)\n'
        'alert tcp any any -> any 80 (msg:"bad"; urilen:oops; content:"GET "; '
        'sid:84;)\n',
        [b"GET /0123456789a HTTP/1.1\r\n\r\n", b"GET /abc HTTP/1.1\r\n\r\n",
         b"GET /%61%62%63%64%65 HTTP/1.1\r\n\r\n", b"GET_NOSPACE"]),
    "negated-dead-offset": (
        'alert tcp any any -> any 80 (msg:"a"; content:"/y"; http_uri; '
        'byte_extract:1,0,v,relative; content:!"zz"; offset:v; sid:91;)',
        [b"GET /y HTTP/1.1\r\nzz: x\r\n\r\n"]),
    "negated-undefined-depth": (
        rule('msg:"b"; content:"AAA"; byte_extract:2,0,vv,relative,dce; '
             'content:!"ZZZ"; depth:vv; sid:92;'), [b"AAA....ZZZ"]),
    "export-coe": (
        'alert tcp any any -> any 80 (msg:"a"; content:"cmd.exe"; sid:1;)\n'
        'alert tcp any any -> any 80 (msg:"b"; content:"/etc/passwd"; '
        'http_uri; sid:2;)\n'
        'alert tcp any any -> any any (msg:"c"; content:"|90 90|X"; '
        'content:!"skip"; sid:3;)\n',
        [b"xx cmd.exe yy /etc/passwd zz \x90\x90X cmd.exe"]),
    "export-cli": (rule('msg:"x"; content:"XYZ"; sid:1;'), [b"..XYZ.."]),
    "fast-pattern-only": (
        rule('msg:"a"; content:"foo"; fast_pattern:only; sid:1;')
        + rule('msg:"b"; content:"bar"; fast_pattern; sid:2;'),
        [b"xfoox", b"xbarx", b"FOO bar"]),
}
CASES = [(name, i) for name, (_, payloads) in GROUPS.items()
         for i in range(len(payloads))]
#: payloads above 64 KiB scan in 8 KiB chunks on both sides: the plain
#: versions walk the chain steps in Python, and a default 64 MiB chunk of
#: a length with few factors of two runs on a few lanes (shrink_blocks)
LARGE = EngineConfig(chunk_bytes=1 << 13)


@functools.cache
def matchers(rules: str, config: EngineConfig = EngineConfig()):
    return (japi.compile_snort(rules, config),
            tapi.compile_snort(rules, config, device="cpu"))


def alert_rows(report) -> list:
    return [[(a.rule_index, a.sid, a.msg, a.pcre_checked) for a in alerts]
            for alerts in report.alerts]


def assert_reports_equal(got, want):
    assert alert_rows(got) == alert_rows(want)
    assert got.prefilter_candidates == want.prefilter_candidates
    assert got.content_report is None and want.content_report is None
    assert [got.sids(i) for i in range(len(got.alerts))] == \
        [want.sids(i) for i in range(len(want.alerts))]


@pytest.mark.parametrize("group,index", CASES,
                         ids=[f"{g}-{i}" for g, i in CASES])
def test_snort_scan_matches_jax(group, index):
    rules, payloads = GROUPS[group]
    payload = payloads[index]
    jm, tm = (matchers(rules, LARGE) if len(payload) > 1 << 16
              else matchers(rules))
    assert_reports_equal(tm.scan(payload), jm.scan(payload))
    if len(payload) <= 1 << 16:
        arr = np.frombuffer(payload, np.uint8)
        assert_reports_equal(tm.scan(arr), jm.scan(arr))


@pytest.mark.parametrize("group", list(GROUPS))
def test_snort_batch_and_report_match_jax(group):
    """All of a group's payloads in one scan (the ragged batch of stage 1),
    and the enforcement report."""
    rules, payloads = GROUPS[group]
    jm, tm = matchers(rules)
    small = [p for p in payloads if len(p) < 4096]
    if small:
        assert_reports_equal(tm.scan(small), jm.scan(small))
    assert tm.enforcement_report() == jm.enforcement_report()
    assert tm.num_rules == jm.num_rules


def test_compile_snort_from_file_and_errors(tmp_path):
    p = tmp_path / "x.rules"
    p.write_text(GROUPS["file"][0])
    jm, tm = japi.compile_snort(str(p)), tapi.compile_snort(str(p), device="cpu")
    assert tm.num_rules == jm.num_rules == 1
    assert_reports_equal(tm.scan(b"xxabcxx"), jm.scan(b"xxabcxx"))
    with pytest.raises(ValueError, match="no rules parsed"):
        tapi.compile_snort("# nothing here\n", device="cpu")


def test_pcre_tables_refuse_any_exception_as_jax():
    """A pcre that trips the parser with something other than RegexError
    (here RecursionError) is outside the subset; the scan goes on and the
    rule is reported as partially enforced, as in the JAX package."""
    rules = GROUPS["pcre-deep-nesting"][0]
    pat = tsnort.pcre_to_pattern("/" + "(" * 500 + "a" + ")" * 500 + "/")
    with pytest.raises(RecursionError):
        tapi.compile_pattern(pat.encode(), anchored=False)
    jm, tm = matchers(rules)
    assert tm._pcre_tables(0) is None and jm._pcre_tables(0) is None
    assert tm._pcre_tables(1)[0] == jm._pcre_tables(1)[0] == "dfa"
    got, want = tm.scan(b"xaaay"), jm.scan(b"xaaay")
    assert_reports_equal(got, want)
    assert alert_rows(got) == [[(0, 8200, "deep", False)]]
    assert tm.enforcement_report() == jm.enforcement_report()


def test_pcre_hit_matches_jax():
    """The pcre check (native walk, Pike VM for \\b) and its tables, on the
    payloads of test_pcre_hit_native_matches_python."""
    jm, tm = matchers(COMMUNITY_SAMPLE + GROUPS["pcre-boundary-dotall"][0])
    payloads = [b"USER " + b"A" * 150, b"USER " + b"A" * 100,
                b"USER " + b"A" * 99, b"JOIN #abc", b"", b"the cat sat",
                b"concatenate", b"a\nb"]
    kinds = set()
    for idx in range(tm.num_rules):
        jt, tt = jm._pcre_tables(idx), tm._pcre_tables(idx)
        assert (jt is None) == (tt is None)
        if tt is None:
            continue
        assert tt[0] == jt[0]
        kinds.add(tt[0])
        if tt[0] == "dfa":
            for g, w in zip(tt[1:], jt[1:]):
                np.testing.assert_array_equal(g, w)
        for raw in payloads:
            assert tm._pcre_hit(idx, raw) == jm._pcre_hit(idx, raw), (idx, raw)
    assert kinds == {"dfa", "host"}


def content_fuzz(mod, seed: int = 5, trials: int = 400):
    """test_verify_fuzz_vs_bruteforce_oracle's seeded rules and payloads,
    built from ``mod`` (the JAX package's or the port's models.snort)."""
    rnd = random.Random(seed)
    lits = [b"A", b"AB", b"BA", b"B"]
    out = []
    for _ in range(trials):
        ncont = rnd.randint(1, 3)
        contents = []
        for i in range(ncont):
            kw = {}
            if rnd.random() < 0.3:
                kw["offset"] = rnd.randint(0, 6)
            if rnd.random() < 0.3:
                kw["depth"] = rnd.randint(1, 8)
            if i > 0 and rnd.random() < 0.4:
                kw["distance"] = rnd.randint(0, 3)
            if i > 0 and rnd.random() < 0.4:
                kw["within"] = rnd.randint(1, 6)
            contents.append(mod.SnortContent(
                pattern=rnd.choice(lits),
                negated=(rnd.random() < 0.2 and ncont > 1), **kw))
        r = mod.SnortRule(action="alert", proto="tcp", header="", msg="f",
                          sid=1, contents=tuple(contents), pcre=None,
                          options=())
        raw = bytes(rnd.choice(b"AB.") for _ in range(rnd.randint(0, 10)))
        out.append((r, [raw]))
    return out


def byte_op_fuzz(mod, seed: int = 17, trials: int = 400):
    """test_byte_op_verify_fuzz_vs_bruteforce_oracle's seeded verify
    programs and payloads, built from ``mod``."""
    rnd = random.Random(seed)
    lits = [b"A", b"AB", b"B"]
    out = []
    for _ in range(trials):
        ops = []
        nvars = 0
        for i in range(rnd.randint(2, 4)):
            kind = rnd.random()
            if kind < 0.4 or i == 0:
                kw = {}
                if i > 0 and rnd.random() < 0.4:
                    kw["within"] = rnd.randint(1, 6)
                if i > 0 and rnd.random() < 0.3:
                    kw["distance"] = rnd.randint(0, 2)
                ops.append(mod.SnortContent(pattern=rnd.choice(lits), **kw))
            elif kind < 0.55:
                ops.append(mod.ByteTest(
                    count=1, op=rnd.choice(["<", ">", "=", "&"]),
                    negate=rnd.random() < 0.3,
                    value=(f"v{rnd.randint(0, nvars - 1)}"
                           if nvars and rnd.random() < 0.5
                           else rnd.randint(0, 4)),
                    offset=rnd.randint(0, 2), relative=rnd.random() < 0.7))
            elif kind < 0.7:
                ops.append(mod.ByteJump(count=1, offset=rnd.randint(0, 2),
                                        relative=rnd.random() < 0.7,
                                        multiplier=rnd.choice([1, 1, 2])))
            elif kind < 0.85:
                ops.append(mod.ByteExtract(count=1, offset=rnd.randint(0, 2),
                                           name=f"v{nvars}",
                                           relative=rnd.random() < 0.7,
                                           multiplier=rnd.choice([1, 2])))
                nvars += 1
            else:
                ops.append(mod.IsDataAt(
                    pos=(f"v{rnd.randint(0, nvars - 1)}"
                         if nvars and rnd.random() < 0.5
                         else rnd.randint(0, 8)),
                    relative=rnd.random() < 0.7, negate=rnd.random() < 0.3))
        contents = tuple(o for o in ops if isinstance(o, mod.SnortContent))
        r = mod.SnortRule(action="alert", proto="tcp", header="", msg="f",
                          sid=1, contents=contents, pcre=None, options=(),
                          verify_ops=tuple(ops))
        raws = [bytes(rnd.choice(b"AB\x00\x01\x02\x03")
                      for _ in range(rnd.randint(0, 12))) for _ in range(4)]
        out.append((r, raws))
    return out


def bare_matcher(cls, r):
    """A matcher that holds one rule and nothing else: ``_verify`` reads
    only ``rules``."""
    m = cls.__new__(cls)
    m.rules = [r]
    return m


@pytest.mark.parametrize("fuzz", [content_fuzz, byte_op_fuzz])
def test_verify_fuzz_matches_jax(fuzz):
    got_cases, want_cases = fuzz(tsnort), fuzz(jsnort)
    n = 0
    for (tr, raws), (jr, jraws) in zip(got_cases, want_cases):
        assert raws == jraws
        tm, jm = bare_matcher(tapi.SnortMatcher, tr), bare_matcher(
            japi.SnortMatcher, jr)
        for raw in raws:
            assert tm._verify(0, raw, raw.lower()) == \
                jm._verify(0, raw, raw.lower()), (tr, raw)
            n += 1
    assert n in (400, 1600)


BYTE_OPS = [  # (ByteTest keyword arguments, payload, position)
    (dict(count=2), b"\x01\x02\x03", 0),
    (dict(count=2, endian="little"), b"\x01\x02\x03", 1),
    (dict(count=4), b"\xff\x00\x00\x01", 0),
    (dict(count=4), b"\xff\x00\x00", 0),
    (dict(count=1), b"\x80", -1),
    (dict(count=3, string=True, base=10), b"  -42x", 0),
    (dict(count=5, string=True, base=10), b"  -42x", 0),
    (dict(count=4, string=True, base=10), b"+17", 0),
    (dict(count=4, string=True, base=16), b"ff;z", 0),
    (dict(count=3, string=True, base=8), b"778", 0),
    (dict(count=2, string=True, base=10), b"xx", 0),
    (dict(count=2, string=True, base=10), b"12", 2),
    (dict(count=10, string=True, base=10), b"123", 1),
]


@pytest.mark.parametrize("kw,raw,pos", BYTE_OPS)
def test_byte_convert_matches_jax(kw, raw, pos):
    args = dict(op="=", negate=False, value=0, offset=0, **kw)
    assert tapi._byte_convert(raw, pos, tsnort.ByteTest(**args)) == \
        japi._byte_convert(raw, pos, jsnort.ByteTest(**args))


@pytest.mark.parametrize("v,mask", [(0x5A, 0xF0), (0x6A, 0xF0), (0xFFFF, 0x0FF0),
                                    (0x1234, 0x1), (7, 0x6), (0, 0x80)])
def test_apply_bitmask_matches_jax(v, mask):
    assert tapi._apply_bitmask(v, mask) == japi._apply_bitmask(v, mask)


def test_byte_op_tables_match_jax():
    assert set(tapi._BYTE_OPS) == set(japi._BYTE_OPS)
    for op in tapi._BYTE_OPS:
        for v, x in ((3, 5), (5, 5), (6, 5), (0x81, 0x80)):
            assert tapi._BYTE_OPS[op](v, x) == japi._BYTE_OPS[op](v, x)
    assert tapi._MATCH_ENFORCED_OPTS == japi._MATCH_ENFORCED_OPTS
    assert tapi._METADATA_OPTS == japi._METADATA_OPTS
    assert tapi._SCOPE_OPTS == japi._SCOPE_OPTS


@pytest.mark.parametrize("group", ["export-coe", "export-cli", "basic"])
def test_export_coe_matches_jax(group, tmp_path):
    jm, tm = matchers(GROUPS[group][0])
    want = jm.export_coe(str(tmp_path / "j.coe"))
    got = tm.export_coe(str(tmp_path / "t.coe"))
    assert (tmp_path / "t.coe").read_bytes() == (tmp_path / "j.coe").read_bytes()
    np.testing.assert_array_equal(got[0].to_words(), want[0].to_words())
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


def test_community_corpus_matches_jax():
    """The 3,000-rule community-scale corpus over gen_traffic(400): every
    alert, candidate list and report row, and every planted sid alerts."""
    rules = gen_community_rules()
    payloads, planted = gen_traffic(400)
    jm, tm = japi.compile_snort(rules), tapi.compile_snort(rules, device="cpu")
    got, want = tm.scan(payloads), jm.scan(payloads)
    assert_reports_equal(got, want)
    assert tm.enforcement_report() == jm.enforcement_report()
    for i, sid in planted.items():
        assert sid in got.sids(i), (i, sid)
    assert sum(map(len, got.prefilter_candidates)) > 10_000


def test_fast_pattern_only_matches_jax():
    """tests/test_pos_endpos.py::test_fast_pattern_only_not_metadata."""
    jm, tm = matchers(GROUPS["fast-pattern-only"][0])
    rows = {r["sid"]: r for r in tm.enforcement_report()["rules"]}
    assert rows[1]["status"] == "partial"
    assert rows[1]["unenforced_options"] == ["fast_pattern"]
    assert rows[2]["status"] == "enforced"
    assert tm.enforcement_report() == jm.enforcement_report()
