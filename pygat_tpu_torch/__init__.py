"""pygat_tpu_torch — the PyTorch/CUDA port of pygat_tpu for NVIDIA Hopper.

A second package beside the JAX reference ``pygat_tpu``, with the same
module layout: every Pallas TPU kernel on the ported path becomes a CUDA
C++ kernel for ``sm_90a`` (sources in ``csrc/``, built with ``nvcc`` at the
first CUDA call), and everything around the kernels is plain PyTorch. The
package never imports JAX or ``pygat_tpu``.
"""

__version__ = "0.1.0"
