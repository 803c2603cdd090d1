"""The benchmark of regex_fpga_tpu_torch on NVIDIA H100 cards.

``BENCHMARK.json`` at the checkout's root names the cells; ``run.py`` runs
one; ``configs/``, ``traffic/``, ``metrics/`` and ``reference/`` hold what
a cell is made of, found by name."""
