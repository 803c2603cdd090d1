"""Derives ``csv-reviews-pydoc-3.12.json``: RFC 4180 CSV records in the
Yelp Open Dataset's review schema, their review text taken from the
committed pydoc corpus (``cpython-3.12.12-pydoc-topics.json``).

    python -m benchmark.corpora.csv_reviews   # writes the JSON file again

The pydoc corpus's paragraphs (each document split at blank lines, as
``benchmark/gen.py`` splits it), their blank lines stripped from both ends,
are taken in order, 1 to 3 a review. A group is one record's ``text``: its
paragraphs joined by one LF, every ``"`` doubled, the field quoted. The
other fields follow the schema (https://www.yelp.com/dataset/documentation/main)
in its order, ``review_id,user_id,business_id,stars,date,text,useful,funny,cool``:
three 22-character base64url ids, ``stars`` 1 to 5, a ``YYYY-MM-DD`` date
inside the dataset's span, and three small vote counts. Every draw is a
BLAKE2b digest of ``SEED``, the record's number and the field's name, so
the file is the same under every Python and numpy.

Each document of the result is one record without its final LF: no
document holds ``"\\n\\n"``, so the generator's ``"paragraphs"`` kind draws
whole records and appends ``"\\n\\n"`` to each (the record's LF, then one
blank line).
"""

from __future__ import annotations

import base64
import csv
import datetime
import hashlib
import io
import json
from pathlib import Path

__all__ = ["SEED", "SOURCE", "NAME", "PATH", "records", "document", "row_starts",
           "main"]

SEED = 4180
SOURCE = "cpython-3.12.12-pydoc-topics"
NAME = "csv-reviews-pydoc-3.12"
HERE = Path(__file__).resolve().parent
PATH = HERE / f"{NAME}.json"
#: the dates of the Yelp Open Dataset's reviews
FIRST_DAY = datetime.date(2005, 2, 16)
LAST_DAY = datetime.date(2022, 1, 19)


def _draw(i: int, field: str, n: int) -> int:
    """A number in [0, n) for field ``field`` of record ``i``."""
    h = hashlib.blake2b(f"{SEED}/{i}/{field}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") % n


def _id(i: int, field: str) -> str:
    """22 base64url characters: 128 bits, as the dataset's ids."""
    h = hashlib.blake2b(f"{SEED}/{i}/{field}".encode(), digest_size=16).digest()
    return base64.urlsafe_b64encode(h).decode().rstrip("=")


def _votes(i: int, field: str) -> int:
    """0 half the time, 1 a quarter, ... at most 6."""
    return 6 - _draw(i, field, 64).bit_length()


def _paragraphs() -> list[str]:
    doc = json.loads((HERE / f"{SOURCE}.json").read_text(encoding="utf-8"))
    out = []
    for _, text in doc["documents"]:
        for p in text.split("\n\n"):
            p = p.strip("\n")
            if p:
                out.append(p)
    return out


def records() -> list[tuple[str, str]]:
    """(review_id, record without its final LF), in order."""
    paras = _paragraphs()
    out, at, i = [], 0, 0
    span = (LAST_DAY - FIRST_DAY).days + 1
    while at < len(paras):
        take = 1 + _draw(i, "paragraphs", 3)
        text = "\n".join(paras[at : at + take])
        at += take
        review_id = _id(i, "review_id")
        day = FIRST_DAY + datetime.timedelta(days=_draw(i, "date", span))
        fields = [review_id, _id(i, "user_id"), _id(i, "business_id"),
                  str(1 + _draw(i, "stars", 5)), day.isoformat(),
                  '"' + text.replace('"', '""') + '"',
                  str(_votes(i, "useful")), str(_votes(i, "funny")),
                  str(_votes(i, "cool"))]
        out.append((review_id, ",".join(fields)))
        i += 1
    return out


def document() -> str:
    """The JSON file's text."""
    doc = {
        "name": NAME,
        "source": "derived by benchmark/corpora/csv_reviews.py from "
                  f"{SOURCE}.json (seed {SEED})",
        "what": "RFC 4180 CSV records in the Yelp Open Dataset's review schema "
                "(review_id,user_id,business_id,stars,date,text,useful,funny,cool); "
                "text: 1 to 3 consecutive paragraphs of the Python 3.12 "
                "documentation's topic pages, quoted, quotes doubled",
        "license": "the text: Python Software Foundation License Version 2 "
                   "(https://docs.python.org/3/license.html); the other fields "
                   "are drawn from the seed",
        "documents": [list(r) for r in records()],
    }
    return json.dumps(doc, indent=0, ensure_ascii=False) + "\n"


def row_starts(data: bytes) -> list[int]:
    """The byte offset of each non-empty row that Python's ``csv`` module
    reads in ``data`` (bytes that are no UTF-8 keep their offsets)."""
    offs = []

    def lines():
        at = 0
        for line in io.StringIO(data.decode("utf-8", "surrogateescape"), newline=""):
            offs.append(at)
            at += len(line.encode("utf-8", "surrogateescape"))
            yield line

    out, used = [], 0
    for row in csv.reader(lines()):
        if row:
            out.append(offs[used])
        used = len(offs)
    return out


def main() -> None:
    PATH.write_text(document(), encoding="utf-8")


if __name__ == "__main__":
    main()
