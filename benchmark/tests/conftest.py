"""Shared fixtures of the benchmark's own tests (run them with
``python -m pytest benchmark/tests``; the repo's suite under ``tests/``
does not collect them). Tests marked ``cuda`` need a card and skip inside
the ``card`` fixture elsewhere."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: each cell at a size a CPU test holds: the port runs its plain versions
SMALL = {
    "gpt2-pretok-bytes.shard-count": {"bytes": 1 << 16, "pool": 2},
    # six documents, three past the control's 4,096-byte segments
    "gpt2-pretok-bytes.doc-presplit": {"pool": 6, "check_share": 1.0},
}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
