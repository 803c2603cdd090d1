"""Torch port API (regex_fpga_tpu_torch.api) against regex_fpga_tpu.api under
EngineConfig(scan_backend="device"), on the same seeded numpy inputs: every
count, position, offset and iteration count must be exactly equal."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

from regex_fpga_tpu import api as japi
from regex_fpga_tpu.models.regex import CompiledDfa
from regex_fpga_tpu.utils.config import EngineConfig
from regex_fpga_tpu_torch import api as tapi

from conftest import random_dfa_table

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SMALL = EngineConfig(scan_backend="device", num_blocks=64, chunk_bytes=1 << 13)
FRAG = (b"The quick brown fox jumps over 1234 lazy dogs, it's 99.5% fine!  "
        b"pre-split   benchmark text \xc3\xa9t\xc3\xa9 2026... ")
TEXT = (FRAG * 300)[:20_011]
PATTERNS = [rb"[a-z]+[0-9]|foo|\s\s", rb"ab+c|\d{2}", rb"[a-z]+@[a-z]+"]


def matchers(pattern, config=SMALL, **kw):
    if pattern is None:
        return (japi.compile_tokenizer(config=config),
                tapi.compile_tokenizer(config=config, device="cpu"))
    return (japi.compile_regex(pattern, config=config, **kw),
            tapi.compile_regex(pattern, config=config, device="cpu", **kw))


def assert_reports_equal(got, want):
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.total == want.total
    assert got.metrics.engine == want.metrics.engine
    assert got.metrics.iterations == want.metrics.iterations
    assert got.metrics.converged == want.metrics.converged
    assert (got.match_positions is None) == (want.match_positions is None)
    if want.match_positions is not None:
        for g, w in zip(got.match_positions, want.match_positions):
            np.testing.assert_array_equal(g, w)


def random_stream(seed, n, alphabet=b"abc123 x@.\n"):
    rng = np.random.default_rng(seed)
    return np.frombuffer(bytes(rng.choice(list(alphabet), size=n)), np.uint8)


@pytest.mark.parametrize("pattern", [None, *PATTERNS])
@pytest.mark.parametrize("collect_positions", [False, True])
def test_scan_single_stream_matches_jax(pattern, collect_positions):
    jm, tm = matchers(pattern)
    data = TEXT if pattern is None else random_stream(1, 20_011).tobytes()
    assert_reports_equal(tm.scan(data, collect_positions=collect_positions),
                         jm.scan(data, collect_positions=collect_positions))


@pytest.mark.parametrize("pattern", [None, PATTERNS[1]])
def test_scan_equal_batch_matches_jax(pattern):
    jm, tm = matchers(pattern)
    rng = np.random.default_rng(3)
    batch = rng.integers(0, 256, size=(5, 6000)).astype(np.uint8)
    got, want = tm.scan(batch), jm.scan(batch)
    assert want.metrics.engine == "dfa-fast-batch"
    assert_reports_equal(got, want)


def test_scan_ragged_batch_with_256_classes_matches_jax():
    """C = 256, so the ragged path's stall class is id 256 and its chunk
    needs int32 class ids."""
    rng = np.random.default_rng(4)
    table, accept = random_dfa_table(rng, 40, 3)
    dfa = CompiledDfa(table=table, accept=accept, start=0, dead=39)
    jm = japi.DfaMatcher(dfa, SMALL)
    tm = tapi.DfaMatcher(dfa, SMALL, device="cpu")
    assert tm.tables.num_classes == 256
    streams = [rng.integers(0, 256, size=n).astype(np.uint8)
               for n in (10, 3000, 17, 0, 9000, 1)]
    got, want = tm.scan(streams), jm.scan(streams)
    assert want.metrics.engine == "dfa-fast-batch-ragged"
    assert_reports_equal(got, want)


def test_scan_ragged_tokenizer_matches_jax():
    jm, tm = matchers(None)
    rng = np.random.default_rng(5)
    text = np.frombuffer(TEXT, np.uint8)
    streams = [text[a:a + n] for a, n in
               zip(rng.integers(0, 5000, 6), (100, 12000, 1, 777, 0, 4096))]
    assert_reports_equal(tm.scan(streams), jm.scan(streams))


@pytest.mark.parametrize("sizes", [(100_000, 120_000, 70_000),
                                   (200, 150_000, 0)])
def test_scan_ragged_long_rows_match_jax(sizes):
    """Rows that average more than 64 KiB in a chunk are copied to the
    device one by one; shorter ones go up as one concatenation."""
    cfg = EngineConfig(scan_backend="device", num_blocks=64,
                       chunk_bytes=1 << 17)
    jm, tm = matchers(None, config=cfg)
    text = np.frombuffer(FRAG * 3000, np.uint8)
    streams = [text[i:i + n] for i, n in enumerate(sizes)]
    assert_reports_equal(tm.scan(streams), jm.scan(streams))


@pytest.mark.parametrize("pattern", [None, *PATTERNS])
@pytest.mark.parametrize("n", [0, 1, 5, 63, 1024, 20_011])
def test_count_matches_jax(pattern, n):
    """count() rides the k-gram engine for S <= 32 (the tokenizer) and the
    k=1 counts engine above it, with serial tails; both equal JAX."""
    jm, tm = matchers(pattern)
    data = np.frombuffer(TEXT[:n], np.uint8)
    assert tm.count([data]) == jm.count([data])


def test_count_kgram_chunked_carry_matches_jax():
    cfg = EngineConfig(scan_backend="device", chunk_bytes=512, num_blocks=16)
    jm, tm = matchers(None, config=cfg)
    assert tm._kgram() is not None
    data = np.frombuffer(TEXT[:9001], np.uint8)
    assert tm.count(data) == jm.count(data) == tm.scan(data).total


def test_stream_scanner_resume_matches_jax():
    jm, tm = matchers(PATTERNS[2])
    data = (b"mail me a@b or c@d thanks " * 400)
    for chunks in ([len(data)], [1, 332, len(data) - 333],
                   [7, 4000, len(data) - 4007]):
        js, ts = jm.stream_scanner(), tm.stream_scanner()
        off = 0
        for n in chunks:
            js.feed(data[off:off + n])
            ts.feed(data[off:off + n])
            off += n
        np.testing.assert_array_equal(ts.state_counts, js.state_counts)
        assert ts.total == js.total
    ts = tm.stream_scanner()
    ts.feed(data[:333])
    resumed = tapi.compile_regex(PATTERNS[2], config=SMALL,
                                 device="cpu").stream_scanner(
        resume=ts.checkpoint())
    resumed.feed(data[333:])
    np.testing.assert_array_equal(resumed.state_counts,
                                  jm.scan(data).counts[0])
    assert resumed.histogram() == jm.scan(data).histogram()


@pytest.mark.parametrize("n", [1, 2, 3, 100, 20_011, -4099])
def test_presplit_and_pieces_match_jax(n):
    """Synthetic text, and seeded random bytes for n < 0."""
    jm, tm = matchers(None)
    text = TEXT[:n] if n > 0 else random_stream(-n, -n, bytes(range(256))).tobytes()
    np.testing.assert_array_equal(tm.presplit(text), jm.presplit(text))
    assert tm.pieces(text) == jm.pieces(text)
    assert tm.presplit(b"").shape == (0,)


@pytest.mark.parametrize("chunk_bytes", [1 << 26, 2048])
def test_exact_fallback_matches_jax(chunk_bytes):
    """A parity-flavoured pattern with a tiny Jacobi budget does not
    converge; both packages take the exact path and agree. The port's exact
    path is blocked over whole 1024-byte blocks and serial over the rest:
    4160 bytes leave a 64-byte tail, and 2048-byte chunks a tail chunk."""
    cfg = EngineConfig(scan_backend="device", num_blocks=1024, max_iters=2,
                       min_block_bytes=1, chunk_bytes=chunk_bytes)
    jm, tm = matchers(r"a(aa)*", config=cfg, anchored=True)
    for n in (3072, 4160):
        data = b"a" * n
        got, want = tm.scan(data), jm.scan(data)
        assert not got.metrics.converged
        assert_reports_equal(got, want)
        assert_reports_equal(tm.scan(data, collect_positions=True),
                             jm.scan(data, collect_positions=True))
        assert tm.count(data) == jm.count(data)
    batch = [b"a" * 3072, b"a" * 3072]
    assert_reports_equal(tm.scan(batch), jm.scan(batch))
    ragged = [b"a" * 3072, b"a" * 1001]
    assert_reports_equal(tm.scan(ragged), jm.scan(ragged))


def test_empty_inputs():
    jm, tm = matchers(PATTERNS[0])
    assert_reports_equal(tm.scan(b""), jm.scan(b""))
    assert tm.count(b"") == 0


@pytest.mark.parametrize("backend", ["auto", "host"])
def test_unported_backends_raise(backend):
    """Both backends are ported now: "host" runs the native walker, as in
    JAX, and "auto" (the default) routes on the card's priors, which may
    choose another engine than JAX's TPU priors; the histograms are equal
    either way."""
    cfg = EngineConfig(scan_backend=backend)
    tm = tapi.compile_tokenizer(config=cfg, device="cpu")
    jm = japi.compile_tokenizer(config=cfg)
    if backend == "host":
        assert_reports_equal(tm.scan(TEXT), jm.scan(TEXT))
        assert tm.scan(TEXT).metrics.engine == "dfa-host-native"
    else:
        got, want = tm.scan(TEXT), jm.scan(TEXT)
        np.testing.assert_array_equal(got.counts, want.counts)
        assert got.total == want.total
    assert tapi.DEFAULT_CONFIG.scan_backend == "auto"


def test_unported_surface_raises():
    """Patterns with assertions, lazy quantifiers or backreferences route to
    the host matchers, as in JAX; what raises there is the device-throughput
    surface, which those patterns cannot have."""
    for pattern in (r"\bfoo\b", r"a+?b", r"(a)\1"):
        tm = tapi.compile_regex(pattern, device="cpu")
        assert type(tm).__name__ == type(japi.compile_regex(pattern)).__name__
        with pytest.raises(NotImplementedError, match="streaming DFA engines"):
            tm.scan(b"foo")
        assert tm.finditer(b"a foo aab aa") == \
            japi.compile_regex(pattern).finditer(b"a foo aab aa")


def chip_smoke_imports():
    """Every module that chip_smoke.py imports, at any depth of its code."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
            names.update(f"{node.module}.{alias.name}" for alias in node.names
                         if node.module.startswith("regex_fpga_tpu_torch"))
    return sorted(names)


def test_port_imports_no_jax():
    """The machine with the card has no JAX: the port, its API (the NFA
    matcher and its device engines included) and chip_smoke.py import
    neither JAX nor any module of the JAX package, at any depth: after every
    port module is imported and driven, sys.modules holds no regex_fpga_tpu
    module. That covers the package-level ``__init__`` exports and
    ``utils.native``."""
    names = chip_smoke_imports()
    assert "regex_fpga_tpu_torch.api" in names
    assert not [n for n in names if n == "jax" or n.startswith("jax.")
                or n.split(".")[0] == "regex_fpga_tpu"], names
    modules = [n for n in names if n.split(".")[0] in ("regex_fpga_tpu_torch",)]
    code = (
        "import importlib, os, sys\n"
        "import chip_smoke\n"
        f"for name in {modules!r}:\n"
        "    try:\n"
        "        importlib.import_module(name)\n"
        "    except ModuleNotFoundError:\n"
        "        mod, _, attr = name.rpartition('.')\n"
        "        getattr(importlib.import_module(mod), attr)\n"
        "import regex_fpga_tpu_torch.ops.dfa_engine\n"
        "import regex_fpga_tpu_torch.ops.router\n"
        "import regex_fpga_tpu_torch.utils.profiling\n"
        "import regex_fpga_tpu_torch.ops.kgram\n"
        "import regex_fpga_tpu_torch.ops.dfa_take\n"
        "import regex_fpga_tpu_torch.ops.hopper_nfa\n"
        "import regex_fpga_tpu_torch.ops.lazy_scan\n"
        "import regex_fpga_tpu_torch.ops.nfa_engine\n"
        "import regex_fpga_tpu_torch.native\n"
        "import regex_fpga_tpu_torch.__main__ as cli\n"
        "assert cli.main(['--device', 'cpu', 'gen-corpus', 'snort', "
        "os.devnull, '-n', '3']) == 0\n"
        "import pkgutil, regex_fpga_tpu_torch\n"
        "for info in pkgutil.walk_packages(regex_fpga_tpu_torch.__path__,\n"
        "                                  'regex_fpga_tpu_torch.'):\n"
        "    importlib.import_module(info.name)\n"
        "import regex_fpga_tpu_torch.re_compat as rc\n"
        "import regex_fpga_tpu_torch.models.captures\n"
        "import regex_fpga_tpu_torch.models.backtrack\n"
        "assert rc.findall(rb'(\\w+)=(\\d+)', b'a=1 bb=22', device='cpu') == "
        "[(b'a', b'1'), (b'bb', b'22')]\n"
        "assert rc.search(rb'(\\w)\\1', b'abba', device='cpu').span() == (1, 3)\n"
        "assert rc.search(rb'\\bb\\w+', b'abba bob', device='cpu').span() == (5, 8)\n"
        "lits = regex_fpga_tpu_torch.api.compile_literals([b'ab', b'b'], device='cpu')\n"
        "assert lits.finditer(b'abab') == [(0, 2, 0), (1, 2, 1), (2, 4, 0), (3, 4, 1)]\n"
        "m = regex_fpga_tpu_torch.api.compile_tokenizer(device='cpu')\n"
        "assert m.count(b'hello world') == m.scan(b'hello world').total\n"
        "from regex_fpga_tpu_torch.models import regexes_to_csr\n"
        "aut = regexes_to_csr([b'wor', b'l+d'])[0]\n"
        "for st in ('lazy', 'lazy-device', 'active-set'):\n"
        "    nm = regex_fpga_tpu_torch.api.compile_ruleset(aut, strategy=st, device='cpu')\n"
        "    assert nm.scan([b'hello world!', b'world']).total == 3\n"
        "    nm.stream_scanner().feed(b'hello world')\n"
        "ids = regex_fpga_tpu_torch.api.compile_snort('alert tcp any any -> any "
        "any (msg:\"a\"; content:\"ab\"; pcre:\"/ab+c/\"; sid:1;)', device='cpu')\n"
        "assert ids.scan([b'xabbc', b'ab']).sids() == [1]\n"
        "for pkg in ('ops', 'utils', 'models', 'parallel', 'utils.native'):\n"
        "    mod = importlib.import_module('regex_fpga_tpu_torch.' + pkg)\n"
        "    assert all(hasattr(mod, n) for n in mod.__all__), pkg\n"
        "from regex_fpga_tpu_torch.utils.native import dfa_scan_native\n"
        "import numpy as np\n"
        "t = np.array([[1, 1], [0, 0]], np.int32)\n"
        "assert dfa_scan_native(t, np.arange(256) % 2, np.array([0, 1]), "
        "np.frombuffer(b'ab', np.uint8))[2] == 1\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'regex_fpga_tpu'))\n"
        "assert not bad, bad\n"
        "print('no-jax-ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "no-jax-ok" in out.stdout
