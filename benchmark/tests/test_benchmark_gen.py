"""The traffic generator: seeded, deterministic, every request cut from the
corpus as the mix says."""

import json

import numpy as np
import pytest
import torch

from benchmark import cells, gen

CONFIG = json.loads((cells.HERE / "configs" / "gpt2-pretok-bytes.json").read_text())
CORPUS = CONFIG["corpus"]


def _traffic(name):
    return json.loads((cells.HERE / "traffic" / f"{name}.json").read_text())


def _pool(mix, seed, **over):
    return gen.make_pool(dict(_traffic(mix), **over), CONFIG, seed, "cpu")


@pytest.mark.parametrize("mix,over", [
    ("shard-count", {"bytes": 50_000, "pool": 4}),
    ("doc-presplit", {}),
])
def test_same_seed_same_requests(mix, over):
    a, b = _pool(mix, 2**31 + 77, **over), _pool(mix, 2**31 + 77, **over)
    c = _pool(mix, 2**31 + 78, **over)
    flat = lambda p: np.concatenate(p.items)  # noqa: E731
    assert a.nbytes == b.nbytes and np.array_equal(flat(a), flat(b))
    # another seed: other bytes, the same set of sizes in another order
    assert sorted(a.nbytes) == sorted(c.nbytes)
    assert not np.array_equal(flat(a)[:4096], flat(c)[:4096])


def test_a_seed_beyond_32_bits():
    p = _pool("shard-count", 2**33 + 5, bytes=1000, pool=1)
    assert p.nbytes == [1000]


def test_shard_size_exact():
    p = _pool("shard-count", 3, bytes=123_457, pool=4)
    assert [len(x) for x in p.items] == [123_457] * 4
    assert all(x.dtype == np.uint8 and x.flags.writeable for x in p.items)


def test_documents_are_the_corpus_each_once():
    docs = gen.documents(CORPUS)
    assert len(docs) == 79 and sum(map(len, docs)) == 517_381
    p = _pool("doc-presplit", 2**31 + 5)
    assert sorted(bytes(x) for x in p.items) == sorted(docs)
    assert [len(x) for x in p.items] == p.nbytes
    assert [bytes(x) for x in p.items] != list(docs)  # a seeded order


def test_shards_are_made_of_the_corpus_paragraphs():
    buf, offs, lens = gen.paragraphs(CORPUS)
    paras = {bytes(buf[o:o + n]) for o, n in zip(offs, lens)}
    assert len(paras) > 1000
    g = torch.Generator()
    g.manual_seed(11)
    t = bytes(gen.text(CORPUS, 1 << 20, g).numpy())
    assert len(t) == 1 << 20
    pieces = [p + b"\n\n" for p in t.split(b"\n\n")]
    # the whole paragraphs are the corpus's (the last is cut; a paragraph
    # that opens or ends with a newline splits anew beside its neighbour)
    whole = [p for p in pieces[:-1] if p != b"\n\n"]
    assert len(whole) > 1000
    assert np.mean([p in paras for p in whole]) > 0.9
    # drawn with replacement, in no fixed period
    assert len(set(whole)) < len(whole)
    assert whole[:50] != whole[50:100]
