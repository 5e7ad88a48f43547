"""macroc_tpu_torch — the macroc FE² macro solver on PyTorch and CUDA.

A port of ``macroc_tpu`` (the JAX/Pallas reference, which stays in the repo
unchanged) to PyTorch, with the two Pallas kernels of the macro Newton step
rewritten as hand-written CUDA C++ kernels for Hopper (``sm_90a``):

  - K1, the 27-point block-stencil SpMV (``ops/stencil_spmv.py``);
  - K2, the stencil-assembly combine (``ops/assembly.py``).

Module names mirror ``macroc_tpu`` so each counterpart is easy to find.  The
package imports torch and numpy, never jax; it reuses the reference's
jax-free host modules (``macroc_tpu.config``, ``macroc_tpu.grid``,
``macroc_tpu.io``).  Every constructor takes an explicit ``device``; on a CPU
tensor each kernel wrapper runs its plain PyTorch version, on a CUDA tensor
it launches the kernel.
"""

__version__ = "0.1.0"

from macroc_tpu.config import MacroConfig, MaterialParams, parse_cli
from macroc_tpu.grid import StructuredGrid3D

__all__ = ["MacroConfig", "MaterialParams", "parse_cli", "StructuredGrid3D"]
