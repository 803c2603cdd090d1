"""count() on automata whose speculative chunks never settle: a K3 part
whose Jacobi rounds run out takes the exact fallback in place, counts only,
on the device bytes K3 was given and from the chunk's entry state (exact,
since every chunk before it settled), and the stream goes on from the
fallback's final state. Nothing is scanned twice.

Held to ``scan(...).total`` and to a serial walk, on the RFC 4180 record
pattern (quote parity) and on the parity of the odd bytes, at a small
``EngineConfig``: 4-KiB chunks, 64 K3 lanes of 16 steps, and two Jacobi
rounds, which settle no chunk of quoted records or random bytes."""

from typing import Callable, NamedTuple

import numpy as np
import pytest

from regex_fpga_tpu_torch import api
from regex_fpga_tpu_torch.models import CompiledDfa
from regex_fpga_tpu_torch.utils.config import EngineConfig
from test_torch_csv_records import CONFIG, records, serial_starts

CHUNK = 1 << 12
SMALL = EngineConfig(num_blocks=64, min_block_bytes=16, chunk_bytes=CHUNK,
                     max_iters=2, scan_backend="device")


class Case(NamedTuple):
    matcher: api.DfaMatcher
    text: Callable[[int, int], np.ndarray]   # (bytes, seed): chunks diverge
    plain: Callable[[int], np.ndarray]       # bytes on which every guess holds
    walk: Callable[[np.ndarray], int]        # the serial count
    accepting_end: Callable[[np.ndarray], np.ndarray]  # a variant ending accepting


def csv_case() -> Case:
    tok = api.compile_tokenizer(CONFIG["pat"], config=SMALL, device="cpu",
                                **CONFIG["port"]["kwargs"])

    def text(n, seed):
        return np.frombuffer(records(n, seed), np.uint8)

    def ending_on_a_record_start(t):
        # the record starts are the pattern's tokens: one at the stream's
        # last byte is its end-of-stream match
        s = next(s for s in serial_starts(t.tobytes()) if s > CHUNK + CHUNK // 2)
        return t[: s + 1]

    return Case(tok, text, lambda n: np.frombuffer(b"x,y\n" * (n // 4), np.uint8),
                lambda t: max(len(serial_starts(t.tobytes())) - 1, 0),
                ending_on_a_record_start)


def parity_case() -> Case:
    """Each byte with its low bit set flips the state; state 1 accepts."""
    table = np.tile(np.array([[0, 1]], np.int32), (256, 1))
    table[1::2] = [1, 0]
    m = api.DfaMatcher(CompiledDfa(table=table, accept=np.array([False, True]),
                                   start=0, dead=-1), SMALL, device="cpu")

    def walk(t):
        # state 1 before a byte counts, and after the last one
        return int((np.cumsum(t & 1) % 2).sum())

    def odd_total(t):
        # the last byte's low bit set so that the odd bytes are odd in number
        t = t.copy()
        t[-1] ^= 1 - int((t & 1).sum()) % 2
        return t

    return Case(m, lambda n, seed: np.random.default_rng(seed).integers(
                    0, 256, n, dtype=np.uint8),
                lambda n: np.full(n, 32, np.uint8), walk, odd_total)


@pytest.fixture(scope="module", params=["csv", "parity"])
def case(request) -> Case:
    return csv_case() if request.param == "csv" else parity_case()


def check(case: Case, streams, monkeypatch) -> list[int]:
    """count() of ``streams`` against ``scan(...).total`` and the serial
    walk; returns the lengths of the parts count() handed the exact
    fallback, each asked for counts only and given device bytes."""
    m = case.matcher
    calls = []
    real = m._exact_fallback

    def spy(data, start, collect_matches=True):
        assert not collect_matches and data.device == m.device
        calls.append(len(data))
        return real(data, start, collect_matches=collect_matches)

    with monkeypatch.context() as patch:
        patch.setattr(m, "_exact_fallback", spy)
        got = m.count(streams)
    assert got == m.scan(streams).total == sum(case.walk(s) for s in streams)
    return calls


def test_every_chunk_diverges(case, monkeypatch):
    for seed in (2**31 + 22, 7):
        stream = case.text(3 * CHUNK, seed)
        assert check(case, [stream], monkeypatch) == [CHUNK] * 3


def test_a_converged_chunk_then_a_diverged_one(case, monkeypatch):
    """The first chunk's guesses all hold (no quote; no odd byte): K3's
    total and final state carry into the second, which falls back."""
    stream = np.concatenate([case.plain(CHUNK), case.text(CHUNK, 3)])
    assert check(case, [stream], monkeypatch) == [CHUNK]


def test_a_diverged_part_then_a_k1_tail(case, monkeypatch):
    """2,050 bytes: a K3 part of 2,048 (32 lanes of 16 steps, two whole
    blocks), then 2 bytes on K1/K2 from the fallback's final state."""
    stream = np.concatenate([case.text(CHUNK, 4), case.text(2050, 5)])
    assert check(case, [stream], monkeypatch) == [CHUNK, 2048]


def test_a_part_with_a_serial_tail(case, monkeypatch):
    """2,944 bytes: a K3 part of 32 lanes of 23 steps, two whole 1,024-byte
    blocks and a serial tail of 896 bytes, read back and walked on the
    host; 4,000 bytes: 3,968 (896 serial) then 32 on K1/K2."""
    assert check(case, [case.text(2944, 6)], monkeypatch) == [2944]
    assert check(case, [case.text(4000, 7)], monkeypatch)[0] == 3968


def test_a_stream_ending_accepting(case, monkeypatch):
    """The end-of-stream match counts, from the last chunk's final state:
    without it the count is one less."""
    stream = case.accepting_end(case.text(3 * CHUNK, 8))
    assert check(case, [stream], monkeypatch)
    with monkeypatch.context() as patch:
        patch.setattr(case.matcher, "include_final_match", False)
        assert case.matcher.count(stream) == case.walk(stream) - 1


def test_several_streams(case, monkeypatch):
    """Diverged and converged streams in one call: each starts anew."""
    streams = [case.text(2 * CHUNK, 9), case.plain(2 * CHUNK),
               case.text(2944, 10), case.plain(100), case.text(CHUNK + 2050, 11)]
    assert check(case, streams, monkeypatch) == [CHUNK] * 2 + [2944, CHUNK, 2048]
