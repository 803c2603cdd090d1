"""Engine settings and run metrics: the port's copies of the JAX package's
``regex_fpga_tpu/utils/config.py`` and ``utils/metrics.py``."""
