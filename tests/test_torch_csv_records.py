"""RFC 4180 record starts on the port (the ``csv-records-rfc4180``
configuration of ``benchmark/``): ``compile_tokenizer`` of its pattern
counts and splits CSV records exactly, on the CPU, where the fast engine's
guesses never settle and every call ends on the exact fallback.

Quote parity decides whether an LF ends a record, so the automaton never
resynchronizes: a lane that guesses its entry state wrong passes the error
to every lane after it. Held to Python's ``csv`` module (on streams that
start at a record), to a serial walk of the pattern, and to the benchmark's
plain reference."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import gen
from benchmark.corpora.csv_reviews import row_starts
from benchmark.reference import csv_records
from regex_fpga_tpu_torch import api
from regex_fpga_tpu_torch.utils.config import EngineConfig

CONFIG = json.loads((Path(__file__).resolve().parents[1] / "benchmark" / "configs"
                     / "csv-records-rfc4180.json").read_text())
#: 4-KiB chunks; 2,048 bytes take 128 K1 lanes of 16 bytes, 32 K3 lanes of
#: 64 and two of the fallback's 1,024-byte blocks
SMALL = EngineConfig(num_blocks=128, min_block_bytes=16, chunk_bytes=1 << 12,
                     scan_backend="device")
#: one record in the corpus's shape with a doubled quote, a comma and an LF
#: in its quoted text
RECORD = b'r1,u1,b1,4,2020-02-29,"a ""b"",\nc",0,1,2\n\n'


@pytest.fixture(scope="module")
def tok():
    return api.compile_tokenizer(CONFIG["pat"], config=SMALL, device="cpu",
                                 **CONFIG["port"]["kwargs"])


@pytest.fixture(scope="module")
def ref():
    return csv_records.Reference(CONFIG, "cpu")


def records(n: int, seed: int) -> bytes:
    """``n`` bytes of the corpus's records drawn as the shard traffic draws
    them: the first starts at byte 0."""
    g = torch.Generator()
    g.manual_seed(seed)
    return gen.text(CONFIG["corpus"], n, g).numpy().tobytes()


def serial_starts(data: bytes) -> list[int]:
    """The pattern's record starts by a serial walk from byte 0."""
    out, inside, ended = [0] if data else [], False, False
    for i, b in enumerate(data):
        if ended and b != 10:
            out.append(i)
            ended = False
        if b == 34:
            inside = not inside
        elif b == 10 and not inside:
            ended = True
    return out


def check(tok, ref, data: bytes) -> list[int]:
    """count() and presplit() against the serial walk and the reference."""
    want = serial_starts(data)
    arr = np.frombuffer(data, np.uint8)
    np.testing.assert_array_equal(tok.presplit(arr), want)
    np.testing.assert_array_equal(ref.presplit([arr])[0], want)
    assert tok.count(arr) == ref.count([arr])[0] == max(len(want) - 1, 0)
    return want


@pytest.mark.parametrize("seed,n", [(2**31 + 4180, 8192), (5, 8000), (2**40 + 7, 12_345)])
def test_count_and_presplit_equal_csv(tok, ref, seed, n):
    """Seeded streams of the corpus's records, in two and three chunks, a
    serial tail after the last whole block where n is not a multiple of
    1,024: Python's csv, the reference and the port agree, with 0
    differences, and the fast engine reports that it did not converge."""
    data = records(n, seed)
    assert check(tok, ref, data) == row_starts(data)
    assert not tok.scan(np.frombuffer(data, np.uint8)).metrics.converged


def _seams() -> bytes:
    """2,048 bytes, one record: its quoted text has ``""`` across every
    multiple of 16 bytes from 32 on, so each K1 lane (16 bytes), K3 lane
    (64) and fallback block (1,024) after the first begins between the two
    quotes of an escaped one; LFs inside the quotes make a misread parity
    show as records."""
    head = b'r,u,b,4,2020-02-29,"' + b"a" * 11 + b'"'  # 32 bytes, a quote last
    body = (b'"' + b"bbbbbb\nbbbbbbb" + b'"') * 124
    tail = b'"",0,1,2\n'
    data = head + body + tail + b"\n" * (2048 - 32 - len(body) - len(tail))
    assert len(data) == 2048
    assert all(data[k - 1 : k + 1] == b'""' for k in range(32, 2032, 16))
    return data


def _in_quotes(data: bytes, after: int) -> int:
    """The first offset from ``after`` on that lies inside a quoted field,
    its byte no quote."""
    q = np.cumsum(np.frombuffer(data, np.uint8) == 34)
    return next(i for i in range(after, len(data))
                if q[i - 1] % 2 and data[i] != 34)


def test_shard_cut_inside_a_quoted_field(tok, ref):
    """Both ends inside a quoted field: the pattern reads the shard from
    its byte 0 outside quotes, so the quoted text is read as records."""
    data = records(16_384, 41)
    a = _in_quotes(data, 1024)
    cut = data[a : _in_quotes(data, a + 3000)]
    check(tok, ref, cut)
    assert not tok.scan(np.frombuffer(cut, np.uint8)).metrics.converged


@pytest.mark.parametrize("case", ["seams", "lfs", "quote_ends", "quote_alone"])
def test_edge_streams(tok, ref, case):
    if case == "seams":
        data = _seams()
        assert check(tok, ref, data) == [0] == row_starts(data)
    elif case == "lfs":
        assert check(tok, ref, b"\n" * 3000) == [0]
    elif case == "quote_ends":  # a quote at byte 0 and at the last byte
        data = records(6000, 9)
        a = data.index(b',"') + 1
        b = data.rindex(b'",')
        data = data[a : b + 1]
        assert data[0] == data[-1] == 34 and len(data) > 2048
        check(tok, ref, data)
    else:
        for data in (b'"', b'"' * 2049, b'"' + b"x\n" * 1200 + b'"'):
            check(tok, ref, data)


@pytest.mark.parametrize("end", range(len(RECORD) + 1))
def test_record_cut_at_every_offset(tok, ref, end):
    """Whole records, blank lines to fill, then ``RECORD[:end]``: 2,048
    bytes, so the cut falls at the end of the fallback's last block."""
    whole = records(4000, 3)
    whole = whole[: whole.rindex(b"\n\n", 0, 2048 - len(RECORD)) + 2]
    data = whole + b"\n" * (2048 - end - len(whole)) + RECORD[:end]
    assert len(data) == 2048
    want = check(tok, ref, data)
    assert want == row_starts(data)


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_exact_on_the_card(cuda):
    """The edge streams above on the card's kernels (K3, K1/K2, K6, its
    combine, pass 2) at the test's lane shapes and the benchmark's, then
    64 MiB shards of the pool at the benchmark's engine settings: one that
    starts at a record and one cut where the draw falls (inside a quoted
    field four times in five); each held to the plain reference, and none
    converging."""
    ref = csv_records.Reference(CONFIG, cuda)
    small = api.compile_tokenizer(CONFIG["pat"], config=SMALL, device=cuda)
    full = api.compile_tokenizer(CONFIG["pat"], config=EngineConfig(**CONFIG["engine"]),
                                 device=cuda)
    data = records(16_384, 41)
    a = _in_quotes(data, 1024)
    quoted = records(6000, 9)
    quoted = quoted[quoted.index(b',"') + 1 : quoted.rindex(b'",') + 1]
    whole = records(4000, 3)
    whole = whole[: whole.rindex(b"\n\n", 0, 2048 - len(RECORD)) + 2]
    streams = [records(12_345, 2**40 + 7), data[a : _in_quotes(data, a + 3000)], _seams(),
               b"\n" * 3000, quoted, b'"' * 2049, b'"' + b"x\n" * 1200 + b'"']
    streams += [whole + b"\n" * (2048 - end - len(whole)) + RECORD[:end]
                for end in range(len(RECORD) + 1)]
    for tok in (small, full):
        for s in streams:
            check(tok, ref, s)
    g = torch.Generator()
    g.manual_seed(2**31 + 4180)
    text = gen.text(CONFIG["corpus"], 2 << 26, g).numpy()
    for shard in (text[: 1 << 26], text[1 << 26 :]):
        want = ref.presplit([shard])[0]
        np.testing.assert_array_equal(full.presplit(shard), want)
        assert full.count(shard) == len(want) - 1
        rep = full.scan(shard)
        assert not rep.metrics.converged and rep.total == full.count(shard)
