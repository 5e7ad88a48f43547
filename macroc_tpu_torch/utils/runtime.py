"""Runtime defaults shared by every entry point (the torch form of
``macroc_tpu.utils.cache.setup_runtime``)."""

from __future__ import annotations

import torch


def setup_runtime() -> None:
    """Full-precision float32 products everywhere.

    TF32 keeps about three decimal digits; FEM assembly and SpMV in it stall
    Newton at a residual plateau around 1e-2 of |RES|_0 (the reference saw
    the same with bf16 MXU passes).  Both matmul and cuDNN switches are set,
    since cuDNN defaults to TF32 even when matmul does not."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
