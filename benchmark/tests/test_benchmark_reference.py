"""The plain reference against a serial scan written from the pattern's
alternatives with Python's ``re``, and against the port's plain CPU path;
its control breaks the guarantee."""

import json
import re

import numpy as np
import pytest

from benchmark import cells, gen
from benchmark.reference import tokenizer

CONFIG = json.loads((cells.HERE / "configs" / "gpt2-pretok-bytes.json").read_text())
#: bytes where the pattern's alternatives part: quotes, contraction
#: letters, the classes' edges, spaces and other whitespace
ALPHABET = np.frombuffer(b"'''sstrrvvellmmddxXZ  \n\t\x00019!.\x7f\x80\xc3\xff", np.uint8)


def serial_starts(data: bytes) -> list[int]:
    """Maximal munch without backtracking, a byte at a time: a token grows
    while the bytes so far are a prefix of some alternative's match."""
    alts = [re.compile(a) for a in (
        rb"'(s|t|re?|ve?|m|ll?|d)", rb" ?[A-Za-z\x80-\xff]*", rb" ?[0-9]*",
        rb" ?[^\x00-\x20A-Za-z0-9\x80-\xff]*", rb"[\x00-\x20]+")]
    starts, i = [], 0
    while i < len(data):
        starts.append(i)
        j = i + 1
        while j < len(data) and any(a.fullmatch(data[i:j + 1]) for a in alts):
            j += 1
        i = j
    return starts


def _streams(seed, n=300):
    rng = np.random.default_rng(seed)
    out = [rng.choice(ALPHABET, k) for k in rng.integers(0, 40, n)]
    out.append(np.frombuffer(b"it's   they'll 're 'rx 'lx 1,000.5  caf\xc3\xa9 !?\n\n", np.uint8))
    return out


def test_pattern_is_the_configurations():
    assert CONFIG["pat"] == tokenizer.PAT
    with pytest.raises(ValueError):
        tokenizer.Reference(dict(CONFIG, pat=CONFIG["source_pat"]), "cpu")


@pytest.mark.parametrize("seed", [1, 2])
def test_reference_equals_a_serial_scan(seed):
    ref = tokenizer.Reference(CONFIG, "cpu")
    streams = _streams(seed)
    for s, got in zip(streams, ref.presplit(streams)):
        assert got.tolist() == serial_starts(bytes(s)), bytes(s)
    assert ref.count(streams) == [max(len(serial_starts(bytes(s))) - 1, 0)
                                  for s in streams]


def test_reference_equals_the_port():
    from regex_fpga_tpu_torch.api import compile_tokenizer

    m = compile_tokenizer(CONFIG["pat"], device="cpu")
    ref = tokenizer.Reference(CONFIG, "cpu")
    docs = gen.documents(CONFIG["corpus"])
    streams = _streams(3, 100) + [np.frombuffer(d, np.uint8) for d in docs[:6]]
    assert ref.count(streams) == [m.count(s) for s in streams]
    for got, want in zip(ref.presplit(streams), [m.presplit(s) for s in streams]):
        assert np.array_equal(got, want)


def test_the_control_breaks_the_guarantee():
    doc = [np.frombuffer(max(gen.documents(CONFIG["corpus"]), key=len), np.uint8)]
    good = tokenizer.Reference(CONFIG, "cpu")
    bad = tokenizer.Reference(CONFIG, "cpu", control=True)
    assert good.count(doc) != bad.count(doc)
    # short of a segment, the control is the reference
    short = [doc[0][:4096]]
    assert good.count(short) == bad.count(short)
