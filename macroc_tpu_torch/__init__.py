"""macroc_tpu_torch — the macroc FE² macro solver on PyTorch and CUDA.

A port of ``macroc_tpu`` (the JAX/Pallas reference, which stays in the repo
unchanged) to PyTorch — the macro Newton step with the J2 and the micro-FE
(FE²) constitutive engines, CG or GMRES, the assembled or the matrix-free
operator, MG levels in a narrower dtype, checkpoint/resume and profiling,
on one device — with every Pallas kernel of the reference rewritten as a
hand-written CUDA C++ kernel for Hopper (``sm_90a``):

  - K1, the 27-point block-stencil SpMV, also with an operator narrower
    than its vectors (``ops/stencil_spmv.py``);
  - K1v1, its shared-memory-tile variant (``ops/stencil_spmv.py``);
  - K2, the stencil assembly from per-GP tangents, one fused kernel
    (``ops/assembly.py``).

Module names mirror ``macroc_tpu`` so each counterpart is easy to find.  The
package imports torch and numpy, never jax and nothing of ``macroc_tpu``:
it keeps its own copies of the reference's host modules (``config``,
``grid``, ``io``).  Every constructor takes an explicit ``device``; on a CPU
tensor each kernel wrapper runs its plain PyTorch version, on a CUDA tensor
it launches the kernel.
"""

__version__ = "0.1.0"

from macroc_tpu_torch.config import MacroConfig, MaterialParams, parse_cli
from macroc_tpu_torch.grid import StructuredGrid3D

__all__ = ["MacroConfig", "MaterialParams", "parse_cli", "StructuredGrid3D"]
