"""The port's engine router (regex_fpga_tpu_torch.ops.router) and the host
backend of DfaMatcher, on the CPU (device="cpu").

The decisions are held to the port's documented calibration points (the
H100 priors in router.py), the probe cache and the margin to monkeypatched
probes, and the real probes run at a small size. Under scan_backend="host"
and "auto" every matcher is held to the JAX package's DfaMatcher under
"host" and "device": counts, finals, positions and count(), with and without
include_final_match, on 1, 3, 4 and 16 streams and a ragged batch.
Tolerance: none; every count, offset and state must be equal."""

import copy
import dataclasses

import numpy as np
import pytest

from regex_fpga_tpu import api as japi
from regex_fpga_tpu.utils.config import EngineConfig as JConfig
from regex_fpga_tpu_torch import api as tapi
from regex_fpga_tpu_torch import native
from regex_fpga_tpu_torch.ops import router
from regex_fpga_tpu_torch.utils.config import EngineConfig

from chip_smoke import WORDS
from test_torch_api import FRAG

SMALL = {"chunk_bytes": 4096, "num_blocks": 64}
TEXT = (FRAG * 120)[:11_111]


@pytest.fixture(autouse=True)
def _fresh_router_session():
    """Probe results are cached process-wide; isolate every test."""
    router.reset_session()
    yield
    router.reset_session()


def forced(m, backend):
    out = copy.copy(m)
    out.config = dataclasses.replace(m.config, scan_backend=backend)
    return out


@pytest.fixture(scope="module")
def ac_matchers():
    """The 300-keyword Aho-Corasick automaton (S=836) in both packages."""
    t = tapi.compile_literals(WORDS[:300], EngineConfig(**SMALL), device="cpu")
    j = japi.compile_literals(WORDS[:300], JConfig(**SMALL))
    assert t.num_states == j.num_states == 836
    return t, j


# ------------------------------------------------------------ the model


def test_decisions_at_calibration_points():
    """The documented points (router.py's module docstring, measured in
    chip_smoke.py's phase 7): small calls go to the host and large scans
    stay on the device, whatever S is; a batch of thousands of short rows
    goes to the host where its (rows, S) histogram is large (the Snort
    batch at S >= 836) and stays on the device at S = 23; forcing overrides
    the model."""
    snort_batch = (4000, 771_893)  # rows, bytes of the Snort traffic
    for s, c in ((23, 10), (836, 36), (996, 68), (1036, 47), (4008, 36)):
        assert router.choose_scan_backend(s, c, 1, workload_bytes=4096) == "host"
        assert router.choose_scan_backend(s, c, 4, workload_bytes=4096) == "host"
        for rows in (1, 4, 64):
            for size in (1 << 20, 64 << 20):
                assert router.choose_scan_backend(
                    s, c, rows, workload_bytes=size) == "device"
        assert router.choose_scan_backend(
            s, c, snort_batch[0], workload_bytes=snort_batch[1]) == \
            ("device" if s == 23 else "host")
    assert router.choose_scan_backend(836, 36, 1, mode="device",
                                      workload_bytes=1) == "device"
    assert router.choose_scan_backend(23, 10, 64, mode="host",
                                      workload_bytes=1 << 30) == "host"
    with pytest.raises(ValueError, match="scan_backend"):
        router.choose_scan_backend(23, 10, 1, mode="tpu")


@pytest.mark.parametrize("s,c", [(23, 10), (836, 36), (1036, 48), (4008, 36)])
@pytest.mark.parametrize("rows,nbytes", [(1, 4096), (1, 1 << 20), (4, 1 << 20),
                                         (64, 64 << 20), (4000, 771_893)])
def test_decision_follows_the_model(s, c, rows, nbytes):
    """"auto" takes the engine whose modeled seconds are fewer."""
    dev = router.device_seconds(s, c, nbytes, rows)
    host = router.host_seconds(s, nbytes, rows)
    want = "device" if dev <= host else "host"
    assert router.choose_scan_backend(s, c, rows, workload_bytes=nbytes) == want


def test_model_reproduces_the_priors(monkeypatch):
    """Without a card the device engine is the plain version and the model
    prices the copy alone; on the card it adds the rate of K2's route, which
    it reads from the kernel's plan (here: a route handed in)."""
    for s, c in ((23, 10), (836, 36), (4008, 36)):
        assert router.device_route(s, c) is None
        assert router.device_count_bps(s, c) == pytest.approx(
            router.DEVICE_COPY_BPS)
        w = 1 << 20
        assert router.device_seconds(s, c, w, 1) == pytest.approx(
            router.DEVICE_CALL_S + w / router.device_count_bps(s, c))
        assert router.device_count_bps(s, c, w) == pytest.approx(
            w / router.device_seconds(s, c, w))
    assert router.host_count_bps(1) == router.HOST_SINGLE_BPS
    assert router.host_count_bps(4) == router.HOST_MULTI_BPS
    row = router.HOST_ROW_S + 836 * router.HOST_ROW_STATE_S
    assert router.host_seconds(836, 4000, 3) == pytest.approx(
        3 * router.HOST_CALL_S + 4000 / router.HOST_CORE_BPS + 3 * row)
    assert router.host_seconds(836, 64 << 20, 1) == pytest.approx(
        router.HOST_SPEC_CALL_S + (64 << 20) / router.HOST_SINGLE_BPS + row)
    assert router.host_seconds(836, 64 << 20, 8) == pytest.approx(
        router.HOST_CALL_S + (64 << 20) / router.HOST_MULTI_BPS + 8 * row)
    monkeypatch.setattr(router, "device_route", lambda s, c: "shared uint16")
    assert router.device_seconds(836, 36, 64 << 20, 8) == pytest.approx(
        router.DEVICE_CALL_S + (64 << 20) * (
            1 / router.DEVICE_BATCH_COPY_BPS
            + 1 / router.DEVICE_ROUTE_BPS["shared uint16"])
        + 8 * (router.DEVICE_ROW_S + 836 * router.DEVICE_ROW_STATE_S))


@pytest.mark.parametrize("n_streams", [1, 3])
def test_host_speculative_walk_cost(n_streams, monkeypatch):
    """Below 4 streams each stream walks on its own: serially (one
    HOST_CALL_S) below HOST_SPEC_MIN_BYTES, speculatively (one
    HOST_SPEC_CALL_S) from there; 4 streams or more make one multi-cursor
    call whatever their length."""
    row = router.HOST_ROW_S + 23 * router.HOST_ROW_STATE_S
    for per, call in ((router.HOST_SPEC_MIN_BYTES - 1, router.HOST_CALL_S),
                      (router.HOST_SPEC_MIN_BYTES, router.HOST_SPEC_CALL_S),
                      (1 << 20, router.HOST_SPEC_CALL_S)):
        w = per * n_streams
        assert router.host_seconds(23, w, n_streams) == pytest.approx(
            n_streams * (call + row) + w / router.HOST_CORE_BPS)
    w = 4 * (1 << 20)
    assert router.host_seconds(23, w, 4) == pytest.approx(
        router.HOST_CALL_S + 4 * row + w / router.HOST_MULTI_BPS)
    # the speculative walk's threshold is native.dfa_scan_speculative's own
    data = np.zeros(router.HOST_SPEC_MIN_BYTES - 1, np.uint8)
    t = np.zeros((1, 2), np.int32)
    calls = []
    real = native.dfa_scan_multi
    monkeypatch.setattr(native, "dfa_scan_multi",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cls, acc = np.zeros(256, np.int32), np.array([False, True])
    native.dfa_scan_speculative(t, cls, acc, data)
    assert calls == []
    native.dfa_scan_speculative(t, cls, acc, np.append(data, np.uint8(0)))
    assert calls


def test_probed_rate_keeps_the_batch_copy(monkeypatch):
    """A probed device rate (one stream, upload included) replaces the
    single-stream copy and the route term; a batch still pays its stacking
    on the host on top of it."""
    monkeypatch.setattr(router, "device_route", lambda s, c: "shared uint32")
    w, rows = 64 << 20, 4
    extra = 1 / router.DEVICE_BATCH_COPY_BPS - 1 / router.DEVICE_COPY_BPS
    per_row = rows * (router.DEVICE_ROW_S + 23 * router.DEVICE_ROW_STATE_S)
    router.record_device_rate(23, 10, 8e9)
    assert router.session_rates() == {"device_bps:shared uint32": 8e9}
    assert router.device_count_bps(23, 10) == pytest.approx(8e9)
    assert router.device_seconds(23, 10, w, 1) == pytest.approx(
        router.DEVICE_CALL_S + w / 8e9)
    assert router.device_seconds(23, 10, w, rows) == pytest.approx(
        router.DEVICE_CALL_S + w * (1 / 8e9 + extra) + per_row)
    # the batch's modeled rate stays below the probed single-stream rate
    assert router.device_count_bps(23, 10, w, rows) < 0.5 * 8e9


# ------------------------------------------------------- probes and margin


@pytest.fixture
def contested(monkeypatch):
    """Priors under which a large S=836 batch of 16 streams is contested:
    the two engines' modeled seconds are equal."""
    route = router.device_route(836, 36)
    w = router.PROBE_MIN_WORKLOAD
    dev = router.device_seconds(836, 36, w, 16)
    monkeypatch.setattr(router, "HOST_CALL_S", 0.0)
    monkeypatch.setattr(router, "HOST_ROW_S", 0.0)
    monkeypatch.setattr(router, "HOST_ROW_STATE_S", 0.0)
    monkeypatch.setattr(router, "HOST_MULTI_BPS", w / dev)
    assert router.host_seconds(836, w, 16) == pytest.approx(dev)
    return route


def test_probe_cache_and_measured_decisions(ac_matchers, monkeypatch, contested):
    """The first large contested call probes both engines once, caches the
    rates for the session and routes on them; later calls reuse the cache;
    forced modes and small workloads never probe."""
    calls = {"host": 0, "dev": 0}

    def fake_host(tables, n):
        calls["host"] += 1
        router.record_host_rate(n, 20.0e9)
        return 20.0e9

    def fake_dev(tables, *a):
        calls["dev"] += 1
        router.record_device_rate(tables.num_states, tables.num_classes, 0.5e9)
        return 0.5e9

    monkeypatch.setattr(router, "probe_host", fake_host)
    monkeypatch.setattr(router, "probe_device", fake_dev)
    dts = ac_matchers[0].tables
    w = router.PROBE_MIN_WORKLOAD
    router.choose_scan_backend(836, 36, 16, tables=dts, workload_bytes=w - 1)
    assert calls == {"host": 0, "dev": 0}
    router.choose_scan_backend(836, 36, 16, mode="device", tables=dts,
                               workload_bytes=w)
    assert calls == {"host": 0, "dev": 0}
    got = router.choose_scan_backend(836, 36, 16, tables=dts, workload_bytes=w)
    assert got == "host" and calls == {"host": 1, "dev": 1}
    got = router.choose_scan_backend(836, 36, 16, tables=dts, workload_bytes=w)
    assert got == "host" and calls == {"host": 1, "dev": 1}
    assert router.host_count_bps(16) == 20.0e9
    assert router.device_count_bps(836, 36) == pytest.approx(0.5e9)
    assert router.session_rates() == {"host_multi_bps": 20.0e9,
                                      router._device_key(contested): 0.5e9}
    # a flipped measurement flips the decision
    router.reset_session()
    monkeypatch.setattr(router, "probe_host", lambda t, n: (
        router.record_host_rate(n, 0.1e9), 0.1e9)[1])
    monkeypatch.setattr(router, "probe_device", lambda t, *a: (
        router.record_device_rate(t.num_states, t.num_classes, 30e9), 30e9)[1])
    assert router.choose_scan_backend(836, 36, 16, tables=dts,
                                      workload_bytes=w) == "device"


def test_probe_outside_band_uses_prior(ac_matchers, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("probed")

    monkeypatch.setattr(router, "probe_host", boom)
    monkeypatch.setattr(router, "probe_device", boom)
    dts = ac_matchers[0].tables
    assert router.choose_scan_backend(23, 10, 1, tables=dts,
                                      workload_bytes=1 << 40) == "device"
    # a small call far on the host's side, and a contested call without
    # tables to probe: the priors decide
    assert router.choose_scan_backend(836, 36, 1, tables=dts,
                                      workload_bytes=4096) == "host"
    w, rows = 1 << 30, 100_000
    ratio = (router.host_seconds(836, w, rows)
             / router.device_seconds(836, 36, w, rows))
    assert router.PROBE_BAND[0] <= ratio <= router.PROBE_BAND[1]
    assert router.choose_scan_backend(836, 36, rows, workload_bytes=w) == \
        ("device" if ratio >= 1 else "host")


def test_device_margin_in_probed_band(ac_matchers, monkeypatch, contested):
    """Once probed, the band asks the device to beat the host by
    DEVICE_MARGIN: near parity routes to the host."""
    w = router.PROBE_MIN_WORKLOAD
    dev = router.device_seconds(836, 36, w, 16)
    per_byte = (dev - router.DEVICE_CALL_S - 16 * (
        router.DEVICE_ROW_S + 836 * router.DEVICE_ROW_STATE_S)) / w
    dev_bps = 1 / per_byte
    host_bps = w / dev * 1.1  # the host 10% slower than the device
    monkeypatch.setattr(router, "probe_host", lambda t, n: (
        router.record_host_rate(n, host_bps), host_bps)[1])
    monkeypatch.setattr(router, "probe_device", lambda t, *a: (
        router.record_device_rate(836, 36, dev_bps * 1.2), dev_bps)[1])
    dts = ac_matchers[0].tables
    assert router.DEVICE_MARGIN > 1.1
    got = router.choose_scan_backend(836, 36, 16, tables=dts, workload_bytes=w)
    assert got == "host"
    # a clear device win still routes to the device
    router.reset_session()
    router.record_host_rate(16, host_bps / 4)
    router.record_device_rate(836, 36, dev_bps)
    assert router.choose_scan_backend(836, 36, 16, tables=dts,
                                      workload_bytes=w) == "device"


def test_real_probes_smoke(ac_matchers, monkeypatch):
    """The probes run end to end at a small size on the CPU tables and
    cache positive rates; a second probe returns the cached number."""
    monkeypatch.setattr(router, "PROBE_HOST_BYTES", 1 << 16)
    tables = ac_matchers[0].tables
    hb = router.probe_host(tables, 16)
    hs = router.probe_host(tables, 1)
    db = router.probe_device(tables, chunk_bytes=1 << 14, num_blocks=64)
    assert hb > 0 and hs > 0 and db > 0
    assert set(router.session_rates()) == {
        "host_multi_bps", "host_single_bps",
        router._device_key(router.device_route(836, 36))}
    assert router.probe_host(tables, 16) == hb
    assert router.probe_device(tables, chunk_bytes=1 << 14, num_blocks=64) == db


def test_failing_device_probe_raises(ac_matchers, monkeypatch, contested):
    """No probe error is swallowed: a device probe that fails raises out of
    the router, and out of the matcher's scan."""
    from regex_fpga_tpu_torch.ops import dfa_fast

    def broken(*a, **k):
        raise RuntimeError("device engine failed")

    monkeypatch.setattr(router, "probe_host",
                        lambda t, n: (router.record_host_rate(n, 1e9), 1e9)[1])
    monkeypatch.setattr(dfa_fast, "dfa_scan_fast", broken)
    with pytest.raises(RuntimeError, match="device engine failed"):
        router.choose_scan_backend(836, 36, 16, tables=ac_matchers[0].tables,
                                   workload_bytes=router.PROBE_MIN_WORKLOAD)


def test_forced_host_without_the_walker_raises(ac_matchers, monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(RuntimeError, match="native host walker"):
        router.choose_scan_backend(836, 36, 1, mode="host")
    # "auto" without the walker runs the device
    assert router.choose_scan_backend(836, 36, 1, workload_bytes=1) == "device"
    t = ac_matchers[0]
    assert t.scan(TEXT).metrics.engine != "dfa-host-native"
    with pytest.raises(RuntimeError, match="native host walker"):
        forced(t, "host").scan(TEXT)


# ------------------------------------------ the host backend against JAX


def stream_sets():
    text = np.frombuffer(TEXT, np.uint8)
    rng = np.random.default_rng(5)
    lens = rng.integers(0, 3000, size=7)
    return {
        "1": [text],
        "3": [text[:4000], text[100:2100], text[:0]],
        "4": list(text[:8000].reshape(4, 2000)),
        "16": list(text[:8000].reshape(16, 500)),
        "ragged": [text[o:o + n] for o, n in zip(rng.integers(0, 8000, 7), lens)],
    }


def matcher_pairs(backend):
    """(port matcher under ``backend``, JAX matcher under "host", JAX
    matcher under "device") for every DFA entry point."""
    tc = EngineConfig(scan_backend=backend, **SMALL)
    jh = JConfig(scan_backend="host", **SMALL)
    jd = JConfig(scan_backend="device", **SMALL)
    rule = 'alert tcp any any -> any any (msg:"a"; content:"fox"; sid:1;)'
    return {
        "regex": (tapi.compile_regex(rb"[a-z]+[0-9]|fo+", config=tc, device="cpu"),
                  japi.compile_regex(rb"[a-z]+[0-9]|fo+", config=jh),
                  japi.compile_regex(rb"[a-z]+[0-9]|fo+", config=jd)),
        "literals": (tapi.compile_literals(WORDS[:40] + [b"fox"], tc, device="cpu"),
                     japi.compile_literals(WORDS[:40] + [b"fox"], jh),
                     japi.compile_literals(WORDS[:40] + [b"fox"], jd)),
        "tokenizer": (tapi.compile_tokenizer(config=tc, device="cpu"),
                      japi.compile_tokenizer(config=jh),
                      japi.compile_tokenizer(config=jd)),
        "snort prefilter": (tapi.compile_snort(rule, tc, device="cpu")._exact,
                            japi.compile_snort(rule, jh)._exact,
                            japi.compile_snort(rule, jd)._exact),
    }


@pytest.mark.parametrize("backend", ["host", "auto"])
@pytest.mark.parametrize("final", [True, False])
@pytest.mark.parametrize("entry", ["regex", "literals", "tokenizer",
                                   "snort prefilter"])
def test_host_and_auto_match_jax(backend, final, entry):
    tm, jh, jd = matcher_pairs(backend)[entry]
    for m in (tm, jh, jd):
        m.include_final_match = final
    for name, streams in stream_sets().items():
        got, want_h, want_d = tm.scan(streams), jh.scan(streams), jd.scan(streams)
        np.testing.assert_array_equal(got.counts, want_h.counts)
        np.testing.assert_array_equal(got.counts, want_d.counts)
        assert got.total == want_h.total
        if backend == "host":
            assert got.metrics.engine == want_h.metrics.engine == "dfa-host-native"
            # the finals of the host walk, stream by stream
            np.testing.assert_array_equal(tm._host_scan_counts(streams)[1],
                                          jh._host_scan_counts(streams)[1])
        assert tm.count(streams) == jh.count(streams) == jd.count(streams)
        if name in ("1", "3"):
            gp = tm.scan(streams, collect_positions=True).match_positions
            wp = jh.scan(streams, collect_positions=True).match_positions
            for g, w in zip(gp, wp):
                np.testing.assert_array_equal(g, w)
    if entry == "literals":
        streams = stream_sets()["ragged"]
        np.testing.assert_array_equal(tm.scan_patterns(streams).pattern_counts,
                                      jd.scan_patterns(streams).pattern_counts)


def test_rule_sets_and_snort_under_host():
    """compile_regex_set (NFA strategies: the router does not apply) and the
    prefiltered set and the Snort matcher (a literal-set prefilter each:
    routed) give the JAX package's results under "host"."""
    tc, jc = EngineConfig(scan_backend="host"), JConfig(scan_backend="host")
    rules = [rb"fox", rb"[0-9]+\.[0-9]", rb"^The", rb"lazy dogs"]
    streams = stream_sets()["ragged"] + [np.frombuffer(TEXT, np.uint8)]
    for compile_ in (lambda api, c, **k: api.compile_regex_set(rules, c, **k),
                     lambda api, c, **k: api.compile_regex_set_prefiltered(
                         rules, c, **k)):
        got = compile_(tapi, tc, device="cpu").scan(streams).rule_counts
        want = compile_(japi, jc).scan(streams).rule_counts
        np.testing.assert_array_equal(got, want)
    rule = ('alert tcp any any -> any any (msg:"m"; content:"dogs"; '
            'content:"fine"; sid:7;)')
    payloads = [bytes(s) for s in streams]
    got = tapi.compile_snort(rule, tc, device="cpu").scan(payloads)
    want = japi.compile_snort(rule, jc).scan(payloads)
    assert [[a.sid for a in r] for r in got.alerts] == \
        [[a.sid for a in r] for r in want.alerts]
    assert got.prefilter_candidates == want.prefilter_candidates


def test_count_routes_only_with_the_kgram_gate_off(ac_matchers, monkeypatch):
    """count() asks the router only where the k-gram engine is off (S above
    KGRAM_MAX_STATES); the tokenizer counts on the k-gram engine."""
    asked = []
    tok = tapi.compile_tokenizer(config=EngineConfig(scan_backend="host", **SMALL),
                                 device="cpu")
    t = forced(ac_matchers[0], "host")
    for m in (tok, t):
        real = m._host_backend
        monkeypatch.setattr(m, "_host_backend",
                            lambda *a, real=real, m=m: asked.append(m) or real(*a))
    tok.count(TEXT)
    assert asked == []
    assert t.count(TEXT) == ac_matchers[1].count(TEXT)
    assert asked == [t]
