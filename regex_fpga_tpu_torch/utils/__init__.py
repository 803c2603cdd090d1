"""Engine settings, run metrics and the conformance fixture loaders: the
port's copies of the JAX package's ``regex_fpga_tpu/utils/config.py``,
``utils/metrics.py`` and ``utils/traces.py``."""
