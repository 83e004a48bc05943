"""PyTorch + CUDA port of smallvcm_tpu (VCM's main path).

The JAX package ``smallvcm_tpu`` is the reference this package is held
against: the same seed gives the same random streams (counter-based
Threefry, core/rng.py), so the comparison is tensor by tensor. The two
kernels of the main path are CUDA C++ for Hopper (``csrc/``), built at
first use; every kernel wrapper keeps its plain PyTorch version beside
it, which is what runs for CPU tensors.
"""

__version__ = "0.1.0"
