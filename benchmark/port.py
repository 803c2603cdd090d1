"""The system under test: the port's entry, built from a configuration,
and the call each request makes. This is the only file of the benchmark
that imports the port."""

from __future__ import annotations

import numpy as np

__all__ = ["build", "call", "answer_bytes"]


def build(config: dict, device):
    """The configuration's matcher on ``device``: its entry called with its
    arguments, where ``"$<key>"`` stands for the configuration's ``<key>``."""
    from regex_fpga_tpu_torch import api
    from regex_fpga_tpu_torch.utils.config import EngineConfig

    port = config["port"]
    args = [config[a[1:]] if a.startswith("$") else a for a in port["args"]]
    entry = getattr(api, port["entry"])
    return entry(*args, config=EngineConfig(**config["engine"]), device=device,
                 **port["kwargs"])


def call(matcher, name: str, item):
    """One request: the answer as the host holds it (an int, or a numpy
    array)."""
    return getattr(matcher, name)(item)


def answer_bytes(answer) -> int:
    return answer.nbytes if isinstance(answer, np.ndarray) else 8
