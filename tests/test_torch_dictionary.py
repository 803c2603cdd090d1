"""The jieba dictionary deployment at a small size on the CPU: the port's
per-pattern counts (``LiteralSetMatcher.count_patterns``, the fold of K2's
histogram on the device) held to the plain reference
``benchmark/reference/dictionary_counts.py``, the reference held to a
brute-force ``bytes.find`` count, its control read wrong, the device fold
held to ``AhoCorasick.pattern_counts``, and ``scan_patterns``' answers."""

import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.corpora import zh_unigram
from benchmark.reference.dictionary_counts import SEGMENT, Reference
from regex_fpga_tpu_torch import api
from regex_fpga_tpu_torch.utils.config import EngineConfig

CONFIG_FILE = (Path(__file__).resolve().parents[1] / "benchmark" / "configs"
               / "jieba-dict-349k.json")
#: 64 lanes of at least 16 bytes, 16-KiB chunks: 64 KiB of text takes five
#: chunks, those of an odd length padded in front
SMALL = EngineConfig(num_blocks=64, min_block_bytes=16, chunk_bytes=1 << 14,
                     scan_backend="device")


@functools.lru_cache(maxsize=1)
def dictionary() -> tuple[list[str], list[int]]:
    conf = json.loads(CONFIG_FILE.read_text(encoding="utf-8"))
    return conf["words"], conf["freqs"]


@functools.lru_cache(maxsize=4)
def sample(seed: int, size: int = 2000) -> tuple[list[str], list[int]]:
    """``size`` dictionary lines drawn from the seed, with the words'
    prefixes and suffixes that are dictionary words themselves (nested
    occurrences), and both lines of the dictionary's duplicate, ``B超``."""
    words, freqs = dictionary()
    line = {w: i for i, w in enumerate(words)}
    rng = np.random.default_rng(seed)
    picked = [int(i) for i in rng.choice(len(words), size // 2, replace=False)]
    seen = set(picked)
    for i in list(picked):
        w = words[i]
        for part in [w[:k] for k in range(1, len(w))] + [w[k:] for k in range(1, len(w))]:
            j = line.get(part)
            if j is not None and j not in seen and len(picked) < size - 2:
                picked.append(j)
                seen.add(j)
    dup = [i for i, w in enumerate(words) if w == "B超"]
    picked += [i for i in range(len(words)) if i not in seen][: size - 2 - len(picked)]
    picked += dup
    return [words[i] for i in picked], [freqs[i] for i in picked]


def text(words, freqs, nbytes: int, seed: int) -> bytes:
    """``nbytes`` of the generator's text over ``words``."""
    docs = zh_unigram.documents(words, freqs, total_bytes=nbytes, seed=seed)
    return "\n\n".join(docs).encode("utf-8")[:nbytes]


def brute(words, data: bytes) -> np.ndarray:
    """Each word's occurrences by ``bytes.find``, overlapping ones included."""
    out = np.zeros(len(words), np.int64)
    for k, w in enumerate(words):
        b, at = w.encode("utf-8"), data.find(w.encode("utf-8"))
        while at >= 0:
            out[k] += 1
            at = data.find(b, at + 1)
    return out


def test_sample_holds_nested_words_and_the_duplicate():
    words, _ = sample(23)
    assert len(words) == 2000 and words.count("B超") == 2
    as_set = set(words)
    nested = [w for w in as_set if any(w[:k] in as_set or w[k:] in as_set
                                       for k in range(1, len(w)))]
    assert len(nested) > 200


@pytest.mark.parametrize("seed", [23, 2**31 + 5, 2**40 + 17])
def test_count_patterns_equals_the_reference(seed):
    words, freqs = sample(seed)
    m = api.compile_literals(words, config=SMALL, device="cpu")
    ref = Reference({"words": words}, "cpu")
    data = text(words, freqs, 70_000, seed)
    rng = np.random.default_rng(seed)
    for _ in range(3):  # odd offsets and odd lengths: cuts inside characters
        a = int(rng.integers(0, 2000)) * 2 + 1
        piece = data[a : a + 65_536 - int(rng.integers(0, 500)) * 2 - 1]
        want = ref.count_patterns([piece])[0]
        got = m.count_patterns(piece)
        assert got.dtype == np.int64 and got.shape == (len(words),)
        np.testing.assert_array_equal(got, want)
        assert want.sum() > len(piece) // 4
        dup = [k for k, w in enumerate(words) if w == "B超"]
        assert got[dup[0]] == got[dup[1]]


def test_count_patterns_sums_streams_and_takes_empty_ones():
    words, freqs = sample(23)
    m = api.compile_literals(words, config=SMALL, device="cpu")
    data = text(words, freqs, 20_000, 4)
    a, b = data[:7_777], data[7_777:]
    np.testing.assert_array_equal(m.count_patterns([a, b, b""]),
                                  m.count_patterns(a) + m.count_patterns(b))
    np.testing.assert_array_equal(m.count_patterns(b""), np.zeros(len(words), np.int64))
    # a stream that ends in an accepting state: the last byte's match counts
    w = words[0].encode("utf-8")
    assert m.count_patterns(w)[0] == 1


@pytest.mark.parametrize("data", [
    b"", b"a", b"aaaa", b"abcabcab", b"ab\xe4\xb8\xad\xe5\x9b\xbdab",
    "中国人民中国人中国".encode(), "B超中国B超".encode()])
def test_reference_equals_a_brute_force_count(data):
    words = ["aa", "a", "abc", "ca", "bcab", "中国", "国人", "中国人", "人民", "国",
             "B超", "中国人民", "B超"]
    np.testing.assert_array_equal(Reference({"words": words}, "cpu").count_patterns([data])[0],
                                  brute(words, data))


def test_reference_on_generated_text_equals_a_brute_force_count():
    words, freqs = sample(5, size=300)
    data = text(words, freqs, 9_000, 5)
    np.testing.assert_array_equal(Reference({"words": words}, "cpu").count_patterns([data])[0],
                                  brute(words, data))


def test_reference_refuses_an_empty_word():
    with pytest.raises(ValueError):
        Reference({"words": ["中国", ""]}, "cpu")


@pytest.mark.parametrize("seed", [23, 2**31 + 5])
def test_control_reads_wrong(seed):
    words, freqs = sample(seed)
    data = text(words, freqs, 6 * SEGMENT + 123, seed)
    ref = Reference({"words": words}, "cpu")
    ctl = Reference({"words": words}, "cpu", control=True)
    want, lost = ref.count_patterns([data])[0], ctl.count_patterns([data])[0]
    assert not np.array_equal(want, lost)
    assert (lost <= want).all() and 0 < (want - lost).sum() <= 6 * 47
    # a stream inside one segment loses nothing
    np.testing.assert_array_equal(ctl.count_patterns([data[:SEGMENT]])[0],
                                  ref.count_patterns([data[:SEGMENT]])[0])


@pytest.mark.parametrize("rows", [None, 1, 5])
def test_device_fold_equals_the_host_fold(rows):
    words, _ = sample(7, size=600)
    m = api.compile_literals(words, config=SMALL, device="cpu")
    s = m.num_states
    rng = np.random.default_rng(rows or 0)
    shape = (s,) if rows is None else (rows, s)
    hist = rng.integers(0, 1000, shape) * (rng.random(shape) < 0.3)
    for dtype in (torch.int32, torch.int64):
        got = m._fold(torch.as_tensor(hist, dtype=dtype))
        assert got.dtype == dtype and got.shape == (*shape[:-1], len(words))
        np.testing.assert_array_equal(got.numpy(), m.ac.pattern_counts(hist))


def test_scan_patterns_answers_are_unchanged():
    words, freqs = sample(11, size=800)
    m = api.compile_literals(words, config=SMALL, device="cpu")
    data = text(words, freqs, 40_000, 11)
    streams = [data[:20_001], data[20_001:30_000], data[:20_001], b"", data[5:6]]
    for batch in (streams, streams[:1], [streams[0]] * 3):
        rep = m.scan_patterns(batch)
        np.testing.assert_array_equal(rep.pattern_counts, m.ac.pattern_counts(rep.report.counts))
        assert rep.pattern_counts.dtype == np.int64
        np.testing.assert_array_equal(rep.pattern_counts.sum(0), m.count_patterns(batch))
