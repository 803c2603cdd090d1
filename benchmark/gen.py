"""The one traffic generator: every mix is a data file under ``traffic/``,
and the text is the public corpus under ``corpora/`` that the configuration
names (``"corpus"``).

A mix names the call each request makes (``call``) and how its requests
are cut from the corpus (``text``):

- ``"documents"``: a request is one whole document; the pool is every
  document of the corpus, in an order drawn from the seed.
- ``"paragraphs"``: a request is ``bytes`` of the corpus's paragraphs
  (blank-line separated, each kept with the blank line after it), drawn
  uniformly with replacement from the seed and cut at ``bytes``; the pool
  holds ``pool`` such streams.

Every seed has the same set of sizes; the seed picks their order and the
paragraphs. Streams are assembled on the run's device in a few large calls
and handed over in host memory: pageable, or page-locked where the mix
says ``pinned`` (on a card), as a loader that pins its batches hands them
over.
"""

from __future__ import annotations

import dataclasses
import functools
import json

import numpy as np
import torch

__all__ = ["Pool", "make_pool", "documents", "paragraphs", "text"]


@dataclasses.dataclass
class Pool:
    """The requests of one run: ``items[i]`` is the stream call i hands the
    port (cycled), ``nbytes[i]`` its bytes."""

    items: list
    nbytes: list[int]

    def __len__(self) -> int:
        return len(self.items)


@functools.lru_cache(maxsize=2)
def documents(corpus: str) -> tuple[bytes, ...]:
    """The corpus's documents, UTF-8 encoded, in its own order."""
    from benchmark.cells import HERE

    doc = json.loads((HERE / "corpora" / f"{corpus}.json").read_text(encoding="utf-8"))
    return tuple(t.encode("utf-8") for _, t in doc["documents"])


@functools.lru_cache(maxsize=2)
def paragraphs(corpus: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(every paragraph with the blank line after it, concatenated, as
    uint8; each one's offset; each one's length)."""
    pieces = [p + b"\n\n" for d in documents(corpus) for p in d.split(b"\n\n") if p]
    lens = np.array([len(p) for p in pieces], np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    return np.frombuffer(b"".join(pieces), np.uint8).copy(), offs, lens


def text(corpus: str, nbytes: int, g: torch.Generator) -> torch.Tensor:
    """``nbytes`` of the corpus's paragraphs drawn with replacement, on the
    generator's device (uint8)."""
    dev = g.device
    buf, offs, lens = (torch.as_tensor(a, device=dev) for a in paragraphs(corpus))
    n = int(nbytes / lens.double().mean().item() * 1.05) + 64
    while True:
        ids = torch.randint(len(lens), (n,), generator=g, device=dev)
        ln = lens[ids]
        ends = torch.cumsum(ln, 0)
        total = int(ends[-1])
        if total >= nbytes:
            idx = torch.repeat_interleave(offs[ids] - (ends - ln), ln)
            idx += torch.arange(total, device=dev)
            return buf[idx[:nbytes]]
        n = int(n * 1.25) + 64  # the estimate fell short: draw again


def _host(t: torch.Tensor, pinned: bool) -> np.ndarray:
    """A stream as the host holds it: its own array (the base of a pinned
    one keeps the page-locked tensor alive)."""
    t = t.cpu()
    return t.pin_memory().numpy() if pinned else t.numpy().copy()


def make_pool(traffic: dict, config: dict, seed: int, device) -> Pool:
    """The run's requests, from ``seed``: the same seed gives the same
    pool on the same kind of device."""
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    corpus = config["corpus"]
    pinned = traffic.get("pinned", False) and torch.device(device).type == "cuda"
    if traffic["text"] == "documents":
        docs = documents(corpus)
        order = np.random.default_rng(seed).permutation(len(docs))
        order = order[:traffic.get("pool", len(docs))]
        items = [_host(torch.frombuffer(bytearray(docs[i]), dtype=torch.uint8), pinned)
                 for i in order]
        return Pool(items, [len(x) for x in items])
    size, m = traffic["pool"], traffic["bytes"]
    items = []
    # at most about 256 MiB of text on the card at a time
    for part in np.array_split(np.arange(size), max(1, (size * m) >> 28)):
        t = text(corpus, len(part) * m, g)
        items += [_host(t[k * m:(k + 1) * m], pinned) for k in range(len(part))]
    return Pool(items, [m] * size)
