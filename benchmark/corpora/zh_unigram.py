"""Derives ``zh-unigram-jieba-0.42.1.json``: Chinese text as jieba models
it, words drawn independently by the frequencies of jieba 0.42.1's
``dict.txt`` (the ``words`` and ``freqs`` of ``configs/jieba-dict-349k.json``),
the unigram model whose probabilities ``get_DAG``'s segmentation scores.

    python -m benchmark.corpora.zh_unigram   # writes the JSON file again

A clause is 2 to 12 words, a sentence 1 to 3 clauses joined by ``，`` and
ended by ``。``, a paragraph 2 to 8 sentences, a document 4 to 16
paragraphs separated by one blank line, each count uniform; documents are
drawn until they hold ``TOTAL_BYTES`` of UTF-8. Every draw comes from one
``numpy.random.default_rng(SEED)`` stream of integers (``Generator.integers``),
a word by its cumulative frequency. No document holds ``"\\n\\n"`` at either
end, so the generator's ``"paragraphs"`` kind draws whole paragraphs and
appends ``"\\n\\n"`` to each.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

__all__ = ["SEED", "NAME", "PATH", "TOTAL_BYTES", "documents", "main"]

SEED = 20200117  # jieba 0.42.1's release date
NAME = "zh-unigram-jieba-0.42.1"
HERE = Path(__file__).resolve().parent
PATH = HERE / f"{NAME}.json"
CONFIG = HERE.parent / "configs" / "jieba-dict-349k.json"
TOTAL_BYTES = 3 << 19  # 1.5 MiB
#: (least, most) of each count, drawn uniformly
CLAUSE_WORDS = (2, 12)
SENTENCE_CLAUSES = (1, 3)
PARAGRAPH_SENTENCES = (2, 8)
DOCUMENT_PARAGRAPHS = (4, 16)


def documents(words: list[str], freqs: list[int], total_bytes: int = TOTAL_BYTES,
              seed: int = SEED) -> list[str]:
    """The documents, in order, until they hold ``total_bytes`` of UTF-8."""
    rng = np.random.default_rng(seed)
    cum = np.cumsum(np.asarray(freqs, dtype=np.int64))

    def count(lo_hi) -> int:
        return int(rng.integers(lo_hi[0], lo_hi[1] + 1))

    def clause() -> str:
        picks = np.searchsorted(cum, rng.integers(0, cum[-1], count(CLAUSE_WORDS)),
                                side="right")
        return "".join(words[i] for i in picks)

    docs: list[str] = []
    size = 0
    while size < total_bytes:
        paras = []
        for _ in range(count(DOCUMENT_PARAGRAPHS)):
            paras.append("".join(
                "，".join(clause() for _ in range(count(SENTENCE_CLAUSES))) + "。"
                for _ in range(count(PARAGRAPH_SENTENCES))))
        docs.append("\n\n".join(paras))
        size += len(docs[-1].encode("utf-8"))
    return docs


def main() -> None:
    conf = json.loads(CONFIG.read_text(encoding="utf-8"))
    docs = documents(conf["words"], conf["freqs"])
    out = {
        "name": NAME,
        "source": (f"derived by benchmark/corpora/zh_unigram.py (seed {SEED}) from the "
                   "words and frequencies of jieba 0.42.1's jieba/dict.txt "
                   "(https://github.com/fxsjy/jieba, MIT)"),
        "what": ("Chinese text as jieba's unigram model has it: words drawn independently "
                 "by dict.txt's frequencies, clauses of 2-12 words joined by U+FF0C, "
                 "sentences of 1-3 clauses ended by U+3002, 2-8 sentences a paragraph, "
                 "4-16 paragraphs a document"),
        "license": "the words and frequencies: MIT (jieba); the draws: the seed",
        "documents": [[f"zh-unigram-{i:04d}", d] for i, d in enumerate(docs)],
    }
    PATH.write_text(json.dumps(out, ensure_ascii=False, indent=0) + "\n", encoding="utf-8")


if __name__ == "__main__":
    main()
