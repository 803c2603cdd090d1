"""regex_fpga_tpu_torch: the PyTorch and CUDA port of regex_fpga_tpu.

A second package beside the JAX one, with the same layout and names. Plain
tensor code is PyTorch; every kernel that the JAX package wrote in Pallas
for the TPU, and every per-byte device loop it left to XLA on a ported
path, is a CUDA kernel written by hand for Hopper (``csrc/``), built with
``nvcc`` the first time a CUDA tensor reaches it (``_build.py``), and each
has a plain PyTorch version beside it that CPU tensors take. The JAX
package is the reference: the port's results equal its results bit for bit.

The numpy-only layers of the JAX package are imported as they are, not
copied: its automaton code through ``regex_fpga_tpu_torch.models``,
``regex_fpga_tpu.utils.{config,metrics}`` in ``api`` (which re-exports
``EngineConfig``), and ``regex_fpga_tpu.utils.native``'s bindings, to which
``native`` hands a build of the C++ walker made from source. This package
never imports ``jax``.
"""

__version__ = "0.1.0"
