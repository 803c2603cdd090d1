"""The torch port's re_compat (regex_fpga_tpu_torch.re_compat) against
regex_fpga_tpu.re_compat on the same inputs, on the CPU, and against Python
``re`` where tests/test_re_compat.py and tests/test_captures.py assert that
the two agree (greedy patterns, no prefix-ordered alternations). Tolerance:
none; every span, group, lastindex and returned string must be equal."""

import re

import numpy as np
import pytest
import torch

from regex_fpga_tpu import re_compat as jrc
from regex_fpga_tpu_torch import re_compat as trc
from regex_fpga_tpu_torch.models.regex import RegexError

from test_torch_spans import assert_match_equal

CPU = {"device": "cpu"}
TEXT = (
    b"The year 1984 was followed by 1985, then 2001: a space odyssey.  "
    b"IPv4 10.0.42.255 and 192.168.1.1 appear; emails a@b.co x_1@y.org.  "
    b"   whitespace   runs\t\tand\nnewlines \xff\x00 binary too. 7 42 999"
)
AGREEING = [rb"\d+", rb"[a-z]+", rb"\s+", rb"\d+\.\d+\.\d+\.\d+",
            rb"[A-Za-z_][A-Za-z0-9_]*@[a-z]+\.[a-z]+", rb"19[0-9]{2}",
            rb"(\w+)@(\w+)\.(\w+)", rb"\b[a-z]+\b", rb"(?m)^\w+",
            rb"(\d)(\d)\2?", rb"(?<= )\d+"]


@pytest.mark.parametrize("pat", AGREEING)
def test_pattern_methods_match_jax_and_re(pat):
    got, want = trc.compile(pat, **CPU), jrc.compile(pat)
    ref = re.compile(pat)
    assert got.groups == want.groups == ref.groups
    assert got.groupindex == want.groupindex
    for name in ("search", "match", "fullmatch"):
        for args in ((), (5,), (5, 60), (70, 20)):
            g = getattr(got, name)(TEXT, *args)
            assert_match_equal(g, getattr(want, name)(TEXT, *args))
            r = getattr(ref, name)(TEXT, *args)
            assert (g is None) == (r is None)
            if r is not None:
                assert g.regs == r.regs and g.re is got
    gm = list(got.finditer(TEXT))
    for g, w in zip(gm, want.finditer(TEXT), strict=True):
        assert_match_equal(g, w)
    assert [m.span() for m in gm] == [m.span() for m in ref.finditer(TEXT)]
    assert [m.span() for m in got.finditer(TEXT, 9, 150)] == \
        [m.span() for m in ref.finditer(TEXT, 9, 150)]
    assert got.findall(TEXT) == want.findall(TEXT) == ref.findall(TEXT)
    assert got.findall(TEXT, 3, 90) == ref.findall(TEXT, 3, 90)
    assert got.split(TEXT) == want.split(TEXT) == ref.split(TEXT)
    assert got.split(TEXT, 2) == ref.split(TEXT, maxsplit=2)
    assert got.subn(b"<\\g<0>>", TEXT) == want.subn(b"<\\g<0>>", TEXT) == \
        ref.subn(b"<\\g<0>>", TEXT)
    assert got.sub(lambda m: m.group()[:1], TEXT, 4) == \
        ref.sub(lambda m: m.group()[:1], TEXT, 4)


def test_module_functions_match_jax_and_re():
    cases = [
        ("findall", (r"(\w+)=(\d+)", "a=1 bb=22")),
        ("findall", (r"(\w+)=\d+", "a=1 bb=22")),
        ("split", (r"(,)", "a,b,c")),
        ("split", (r"(\s)(\s)?", "a  b c")),
        ("sub", (r"(\w+)@(\w+)", r"\2 at \1", "bob@host and eve@door")),
        ("sub", (r"(?P<a>\d+)-(?P<b>\d+)", r"\g<b>:\g<a>", "1-2, 30-40")),
        ("sub", (r"(a)(b)?", r"[\1|\2]", "ab a")),
        ("sub", (r"x", r"\\n\n", "axa")),
        ("subn", (r"(\d)", r"<\1>", "a1b2")),
        ("subn", (r"\s+", " ", "a  b\tc", 1)),
        ("findall", (r"[0-9]+", "année 2026!")),
        ("split", (r",", "α,β")),
    ]
    for name, args in cases:
        got = getattr(trc, name)(*args, **CPU)
        assert got == getattr(jrc, name)(*args) == getattr(re, name)(*args), \
            (name, args)
    for name in ("search", "match", "fullmatch"):
        for pat, s in ((rb"\d+", b"a1b22"), (rb"[a-z]+", b"abc1"),
                       (rb"[a-z0-9]+", b"abc1")):
            assert_match_equal(getattr(trc, name)(pat, s, **CPU),
                               getattr(jrc, name)(pat, s))
    assert [m.regs for m in trc.finditer(r"(?P<n>\d+)", "a1b22", **CPU)] == \
        [m.regs for m in jrc.finditer(r"(?P<n>\d+)", "a1b22")]


@pytest.mark.parametrize("flags,pat,text", [
    (jrc.IGNORECASE, rb"abc", b"ABC abc AbC"),
    (jrc.DOTALL, r"a.b", "a\nb axb"),
    (jrc.MULTILINE, r"^(\w+) (\w+)$", "foo bar\nbar foo\nfoo\n\nbaz foo"),
    (jrc.MULTILINE, r"foo$", "foo bar\nbar foo\nfoo\n\nbaz foo"),
    (jrc.VERBOSE, r"""\d+   # the integer part
                      \.    # the dot
                      \d+ [ ]""", "pi 3.14  e 2.71 x"),
    (jrc.I | jrc.S, r"A.B", "a\nb"),
])
def test_flags_match_jax_and_re(flags, pat, text):
    got = trc.findall(pat, text, flags, **CPU)
    assert got == jrc.findall(pat, text, flags) == re.findall(pat, text, flags)
    repl = "#" if isinstance(text, str) else b"#"
    assert trc.sub(pat, repl, text, flags=flags, **CPU) == \
        re.sub(pat, repl, text, flags=flags)
    assert trc.IGNORECASE == re.IGNORECASE and trc.MULTILINE == re.MULTILINE
    assert trc.DOTALL == re.DOTALL and trc.VERBOSE == re.VERBOSE


@pytest.mark.parametrize("n", [0, 5, 4099, 20_011])
def test_count_and_scan_match_jax(n):
    """``count`` on a pattern of at most 32 states rides the k-gram engine
    (K3's plain version here)."""
    rng = np.random.default_rng(n)
    data = bytes(rng.choice(list(b"ab 12.x"), size=n).astype(np.uint8))
    got, want = trc.compile(rb"[0-9]+\.[0-9]", **CPU), jrc.compile(rb"[0-9]+\.[0-9]")
    assert got._m.num_states <= 32 and got._m._kgram() is not None
    assert got.count(data) == want.count(data) == \
        len(re.findall(rb"(?=[0-9]\.[0-9])", data))
    np.testing.assert_array_equal(got.scan(data).counts, want.scan(data).counts)
    assert trc.count(rb"a", data, **CPU) == data.count(b"a")


def test_escape_expand_errors_and_cache():
    for s in ["a.b*c", "(x)|[y]{2}", "plain", "a\\b$^", b"a.b(c)\\d"]:
        assert trc.escape(s) == jrc.escape(s)
        assert trc.fullmatch(trc.escape(s), s, **CPU) is not None
    m = trc.search(r"(?P<k>\w+)=(\d+)", "n=42", **CPU)
    assert m.expand(rb"\g<k>:\2") == b"n:42"
    assert m.expand(rb"\1/\g<0>") == b"n/n=42"
    for bad in (r"\q", "bad\\"):
        with pytest.raises(trc.error):
            trc.sub(r"(a)", bad, "a", **CPU)
    with pytest.raises(RegexError):
        trc.compile(rb"a{2,1}", **CPU)
    with pytest.raises(ValueError):
        trc.compile(rb"a", 256, **CPU)
    # the device is part of the cache key
    p1 = trc.compile(rb"\d+", **CPU)
    assert trc.compile(rb"\d+", **CPU) is p1
    p2 = trc.compile(rb"\d+", device=torch.device("cpu"))
    assert p2 is not p1 and p2._m.device == p1._m.device
    trc.purge()
    assert trc.compile(rb"\d+", **CPU) is not p1
    assert trc._compile_cached.cache_info().currsize == 1
    assert repr(p1) == "re_compat.compile(b'\\\\d+')"
