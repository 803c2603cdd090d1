"""EngineConfig() in the port: its default ``scan_backend="auto"`` routes
between the device engines and the host walker (the same histograms either
way), and ``"host"`` forces the walker, raising without it. compile_regex, compile_literals,
compile_tokenizer and compile_regex_set under a plain EngineConfig() and a
non-default chunk_bytes, on device="cpu", against the JAX package under the
same config. Tolerance: none; every count, offset and span must be equal."""

import numpy as np
import pytest

from regex_fpga_tpu import api as japi
from regex_fpga_tpu.utils.config import EngineConfig as JConfig
from regex_fpga_tpu_torch import api as tapi
from regex_fpga_tpu_torch.utils.config import EngineConfig

from test_torch_api import FRAG, PATTERNS

TEXT = (FRAG * 200)[:13_337]
STREAMS = [TEXT[:4000], TEXT[100:2100], TEXT[7:7], TEXT[:4000]]
CONFIGS = {"default": {}, "chunk 4 KiB": {"chunk_bytes": 4096},
           "chunk 1 KiB, 16 lanes": {"chunk_bytes": 1024, "num_blocks": 16}}


def assert_scan_equal(got, want):
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.total == want.total


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("pattern", PATTERNS)
def test_compile_regex_under_engine_config(config, pattern):
    tc, jc = EngineConfig(**CONFIGS[config]), JConfig(**CONFIGS[config])
    assert tc.scan_backend == jc.scan_backend == "auto"
    tm = tapi.compile_regex(pattern, config=tc, device="cpu")
    jm = japi.compile_regex(pattern, config=jc)
    assert_scan_equal(tm.scan(TEXT), jm.scan(TEXT))
    assert_scan_equal(tm.scan(STREAMS), jm.scan(STREAMS))
    assert tm.count(TEXT) == jm.count(TEXT)
    np.testing.assert_array_equal(tm.findall_ends(TEXT), jm.findall_ends(TEXT))
    assert tm.finditer(TEXT) == jm.finditer(TEXT)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_other_entry_points_under_engine_config(config):
    tc, jc = EngineConfig(**CONFIGS[config]), JConfig(**CONFIGS[config])
    words = [b"quick", b"fox", b"99", b"t\xc3\xa9", b"lazy dogs"]
    tl = tapi.compile_literals(words, tc, device="cpu")
    jl = japi.compile_literals(words, jc)
    for data in (TEXT, STREAMS):
        np.testing.assert_array_equal(tl.scan_patterns(data).pattern_counts,
                                      jl.scan_patterns(data).pattern_counts)
    tt = tapi.compile_tokenizer(config=tc, device="cpu")
    jt = japi.compile_tokenizer(config=jc)
    np.testing.assert_array_equal(tt.presplit(TEXT), jt.presplit(TEXT))
    assert_scan_equal(tt.scan(STREAMS), jt.scan(STREAMS))
    rules = [rb"[a-z]+[0-9]", rb"^The", rb"fox|dogs"]
    tr = tapi.compile_regex_set(rules, tc, device="cpu")
    jr = japi.compile_regex_set(rules, jc)
    np.testing.assert_array_equal(tr.scan(STREAMS).rule_counts,
                                  jr.scan(STREAMS).rule_counts)


def test_default_config_is_the_jax_default():
    assert tapi.DEFAULT_CONFIG == EngineConfig()
    m = tapi.compile_regex(PATTERNS[0], device="cpu")
    assert m.config.scan_backend == "auto"
    assert_scan_equal(m.scan(TEXT), japi.compile_regex(PATTERNS[0]).scan(TEXT))


@pytest.mark.parametrize("entry", ["regex", "literals", "tokenizer", "snort"])
def test_host_backend_raises(entry, monkeypatch):
    """scan_backend="host" runs the native walker, equal to the JAX
    package's; without the walker a forced "host" raises at the first
    scan."""
    from regex_fpga_tpu_torch import native

    cfg, jcfg = EngineConfig(scan_backend="host"), JConfig(scan_backend="host")
    rule = 'alert tcp any any -> any any (msg:"a"; content:"ab"; sid:1;)'
    compile_ = {
        "regex": lambda api, c: api.compile_regex(PATTERNS[0], config=c),
        "literals": lambda api, c: api.compile_literals([b"ab", b"fox"], c),
        "tokenizer": lambda api, c: api.compile_tokenizer(config=c),
        "snort": lambda api, c: api.compile_snort(rule, c),
    }[entry]
    scan = {
        "regex": lambda m: m.scan(STREAMS).counts,
        "literals": lambda m: m.scan_patterns(STREAMS).pattern_counts,
        "tokenizer": lambda m: m.scan(STREAMS).counts,
        "snort": lambda m: [[a.sid for a in row]
                            for row in m.scan([b"xxab", b"fox", b""]).alerts],
    }[entry]
    got, want = scan(compile_(_CpuApi, cfg)), scan(compile_(japi, jcfg))
    assert [np.asarray(r).tolist() for r in got] == \
        [np.asarray(r).tolist() for r in want]
    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(RuntimeError, match="native host walker"):
        scan(compile_(_CpuApi, cfg))


class _CpuApi:
    """The port's compile functions on device="cpu"."""

    def __getattr__(self, name):
        fn = getattr(tapi, name)
        return lambda *a, **k: fn(*a, device="cpu", **k)


_CpuApi = _CpuApi()
