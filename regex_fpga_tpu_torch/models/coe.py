"""Xilinx COE memory-image parser / writer for CSR-encoded automata.

The reference stores compiled NFAs as Xilinx block-RAM initialization files
(``Block_Mem/CSR_BlockMem*.coe`` in the reference repo).  The file is a flat
array of 32-bit words, radix 16 (``memory_initialization_radix=16``), with the
``memory_initialization_vector=`` payload written as whitespace-separated
groups; each 8-hex-digit group is one word.  Four consecutive words form one
128-bit BRAM cache line (reference ``Design/FPGA.v:881-884`` unpacks the bus
with the *first* word of a line in bits [127:96]); word order in the file is
therefore already the logical word order and no per-line byte swizzling is
needed.

This module is pure NumPy — it is the layer-0 interchange format of the
framework (SURVEY.md SS2.3, SS7.2 stage 0).
"""

from __future__ import annotations

import re

import numpy as np

__all__ = ["read_coe", "write_coe"]

_VECTOR_RE = re.compile(r"memory_initialization_vector\s*=", re.IGNORECASE)
_RADIX_RE = re.compile(r"memory_initialization_radix\s*=\s*(\d+)", re.IGNORECASE)
_WORD_RE = re.compile(r"[0-9a-fA-F]{8}")


def read_coe(path: str) -> np.ndarray:
    """Parse a ``.coe`` file into a flat ``uint32`` word array.

    Only radix-16 images with 8-hex-digit words are supported — that covers
    both shipped rulesets (reference ``Block_Mem/CSR_BlockMem.coe`` and
    ``CSR_BlockMem_snort_16.coe``).
    """
    with open(path, "r") as f:
        text = f.read()

    m = _RADIX_RE.search(text)
    if m and int(m.group(1)) != 16:
        raise ValueError(f"unsupported COE radix {m.group(1)} in {path}")

    m = _VECTOR_RE.search(text)
    if not m:
        raise ValueError(f"no memory_initialization_vector in {path}")
    payload = text[m.end():]

    words = _WORD_RE.findall(payload)
    if not words:
        raise ValueError(f"empty memory_initialization_vector in {path}")
    return np.array([int(w, 16) for w in words], dtype=np.uint32)


def write_coe(path: str, words: np.ndarray, words_per_line: int = 4) -> None:
    """Write a flat word array as a radix-16 ``.coe`` (inverse of read_coe)."""
    words = np.asarray(words, dtype=np.uint32)
    lines = []
    for i in range(0, len(words), words_per_line):
        lines.append("".join(f"{int(w):08x}" for w in words[i : i + words_per_line]))
    with open(path, "w") as f:
        f.write("memory_initialization_radix=16;\n")
        f.write("memory_initialization_vector=")
        f.write(" ".join(lines))
        f.write(";\n")
