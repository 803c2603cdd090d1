"""regex_fpga_tpu_torch: the PyTorch and CUDA port of regex_fpga_tpu.

A second package beside the JAX one, with the same layout and names. Plain
tensor code is PyTorch; every kernel that the JAX package wrote in Pallas
for the TPU, and every per-byte device loop it left to XLA on a ported
path, is a CUDA kernel written by hand for Hopper (``csrc/``), built with
``nvcc`` the first time a CUDA tensor reaches it (``_build.py``), and each
has a plain PyTorch version beside it that CPU tensors take. The JAX
package is the reference: the port's results equal its results bit for bit.

The port imports nothing of the JAX package and never imports ``jax``. It
keeps its own copies of the numpy-only code it needs: the automaton
builders in ``models/``, ``EngineConfig`` and the run metrics in
``utils/``, and the bindings of the C++ host walker in ``native``, which
builds that walker from source.

Entry points run on the first CUDA card unless the caller passes
``device="cpu"``; with no card visible and no device given they raise.
"""

__version__ = "0.1.0"
