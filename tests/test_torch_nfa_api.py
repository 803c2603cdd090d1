"""Torch port of the NFA matcher API (NfaMatcher, NfaStreamScanner,
LazyStreamScanner, compile_ruleset) against regex_fpga_tpu.api on the same
seeded inputs. Tolerance: none; counts, totals, positions and checkpoints
must be equal, and a checkpoint of either package resumes in the other."""

import os
import subprocess
import sys

import numpy as np
import pytest

from regex_fpga_tpu import api as japi
from regex_fpga_tpu.models import nfa_scan as oracle
from regex_fpga_tpu.utils.config import EngineConfig
from regex_fpga_tpu_torch import api as tapi
from regex_fpga_tpu_torch import native
from regex_fpga_tpu_torch.models import gen_l7_traffic, l7_corpus_nfa, write_coe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRATEGIES = ["lazy", "lazy-device", "active-set"]
# chunks of 1000 bytes: the active-set engine carries across them
SMALL = EngineConfig(chunk_bytes=1000)


def flows(n, seed=31, size=None):
    payloads, _ = gen_l7_traffic(max(n, 1) * 12, seed=seed)
    data = np.frombuffer(b"".join(payloads), np.uint8)
    sizes = size or [int(x) for x in
                     np.random.default_rng(seed).integers(0, 3000, size=n)]
    sizes = [sizes] * n if isinstance(sizes, int) else sizes
    offs = np.cumsum([0, *sizes])
    return [data[a:b].copy() for a, b in zip(offs[:-1], offs[1:])]


@pytest.fixture(scope="module")
def aut():
    return l7_corpus_nfa()


def assert_reports_equal(got, want):
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.total == want.total
    assert got.metrics.engine == want.metrics.engine
    assert got.metrics.streams == want.metrics.streams
    assert got.metrics.bytes_scanned == want.metrics.bytes_scanned
    assert (got.match_positions is None) == (want.match_positions is None)
    for g, w in zip(got.match_positions or [], want.match_positions or []):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("data", ["one", "equal", "ragged"])
def test_scan_matches_jax(aut, strategy, data):
    streams = {"one": flows(1, size=4000)[0], "equal": np.stack(flows(3, size=1500)),
               "ragged": flows(4)}[data]
    got = tapi.NfaMatcher(aut, SMALL, strategy, device="cpu").scan(streams)
    want = japi.NfaMatcher(aut, SMALL, strategy=strategy).scan(streams)
    assert_reports_equal(got, want)
    rows = [streams] if data == "one" else list(streams)
    for row, s_ in zip(got.counts, rows):
        np.testing.assert_array_equal(row, oracle(aut, s_))
    assert got.total > 0


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_collect_positions_match_jax(aut, strategy):
    streams = flows(2, seed=5)
    got = tapi.NfaMatcher(aut, SMALL, strategy, device="cpu").scan(
        streams, collect_positions=True)
    want = japi.NfaMatcher(aut, SMALL, strategy=strategy).scan(
        streams, collect_positions=True)
    assert_reports_equal(got, want)
    assert sum(len(p) for p in got.match_positions) > 0


def test_compile_ruleset_from_coe(aut, tmp_path):
    path = str(tmp_path / "l7.coe")
    write_coe(path, aut.to_words())
    data = flows(1, size=5000)[0]
    for strategy in STRATEGIES:
        got = tapi.compile_ruleset(path, strategy=strategy, device="cpu")
        want = japi.compile_ruleset(path, strategy=strategy)
        assert got.num_states == want.num_states == aut.num_states
        assert_reports_equal(got.scan(data), want.scan(data))


def test_dense_table_only_for_positions(aut):
    """The lazy and active-set paths never build the dense (C, S+1, K)
    table; collect_positions does, and it equals the JAX package's."""
    for strategy in STRATEGIES:
        m = tapi.NfaMatcher(aut, SMALL, strategy, device="cpu")
        m.scan(flows(2))
        assert m._tables is None
    m.scan(flows(1)[0], collect_positions=True)
    assert m._tables is not None
    np.testing.assert_array_equal(
        m.tables.delta.numpy(),
        np.asarray(japi.NfaMatcher(aut, strategy="active-set").tables.delta))


def test_active_set_overflow_raises(aut):
    cfg = EngineConfig(active_bound=2)
    data = flows(1, size=3000)[0]
    with pytest.raises(RuntimeError, match="active-set bound exceeded"):
        japi.NfaMatcher(aut, cfg, strategy="active-set").scan(data)
    with pytest.raises(RuntimeError, match="active-set bound exceeded"):
        tapi.NfaMatcher(aut, cfg, "active-set", device="cpu").scan(data)
    with pytest.raises(ValueError, match="strategy"):
        tapi.NfaMatcher(aut, cfg, "dense", device="cpu")


def same_checkpoint(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray) or isinstance(b[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k] and type(a[k]) is type(b[k]), k


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_stream_scanner_checkpoints_interchange(aut, strategy):
    """Feed the first part to one package, resume the checkpoint in the
    other, feed the rest: both directions equal the one-shot oracle, and the
    two packages' checkpoints are equal key by key, dtypes included."""
    data = flows(1, size=6000)[0]
    want = oracle(aut, data)
    jm = japi.NfaMatcher(aut, SMALL, strategy=strategy)
    tm = tapi.NfaMatcher(aut, SMALL, strategy, device="cpu")
    js, ts = jm.stream_scanner(), tm.stream_scanner()
    same_checkpoint(ts.checkpoint(), js.checkpoint())
    for part in (data[:2500], data[2500:2501]):
        js.feed(part)
        ts.feed(part)
    same_checkpoint(ts.checkpoint(), js.checkpoint())
    to_port = tm.stream_scanner(resume=js.checkpoint())
    to_jax = jm.stream_scanner(resume=ts.checkpoint())
    to_port.feed(data[2501:])
    to_jax.feed(data[2501:])
    np.testing.assert_array_equal(to_port.state_counts, want)
    np.testing.assert_array_equal(to_jax.state_counts, want)
    same_checkpoint(to_port.checkpoint(), to_jax.checkpoint())
    # a checkpoint taken before the first feed resumes too
    fresh = tapi.NfaMatcher(aut, SMALL, strategy, device="cpu").stream_scanner(
        resume=jm.stream_scanner().checkpoint())
    fresh.feed(data)
    np.testing.assert_array_equal(fresh.state_counts, want)


def test_native_walker_is_the_portable_build():
    """The port's walker is built from native/golden_scan.cpp into
    build/native/ without -march=native, every LazyDfa and native helper
    of the port uses it, and the committed native/libgolden_scan.so is never
    opened (checked in a fresh process, by its memory map)."""
    assert "-march=native" not in " ".join(native.GXX_FLAGS)
    code = (
        "import re\n"
        "from regex_fpga_tpu_torch import api, native\n"
        "from regex_fpga_tpu_torch.models import regexes_to_csr\n"
        "aut = regexes_to_csr([b'abc', b'b+d', b'x[0-9]y'])[0]\n"
        "m = api.compile_ruleset(aut, device='cpu')\n"
        "rep = m.scan([b'xxabcxx bbd x5y', b'abcabc'], collect_positions=True)\n"
        "assert rep.total == 3, rep.total  # no accept entered by a last byte\n"
        "m.stream_scanner().feed(b'abc')\n"
        "api.compile_ruleset(aut, strategy='lazy-device', device='cpu').scan(b'abc' * 50)\n"
        "assert m.lazy_dfa._native is native.library()\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert 'native/libgolden_scan.so' not in maps\n"
        "found = set(re.findall(r'\\S*/build/native/libgolden_scan_[0-9a-f]{16}\\.so', maps))\n"
        "assert len(found) == 1, found\n"
        "print('native-ok', found.pop())\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lib = out.stdout.split()[-1]
    assert os.path.dirname(lib) == os.path.join(REPO, "build", "native")
