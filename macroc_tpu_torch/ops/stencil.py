"""Diagonal extraction of the 27-point block stencil (the part of
``macroc_tpu/ops/stencil.py`` the SoA preconditioners need).

Both take the AoS view A27 (nx,ny,nz,27,3,3); for an SoA operator pass
``from_soa(A_soa)``, which in torch is a view, not a copy."""

from __future__ import annotations

import torch

from macroc_tpu_torch.fem.kernels import DIAG_OFFSET


def stencil_diag(A27: torch.Tensor) -> torch.Tensor:
    """Point diagonal (nx,ny,nz,3) — the Jacobi preconditioner input."""
    return torch.diagonal(A27[..., DIAG_OFFSET, :, :], dim1=-2, dim2=-1)


def stencil_diag_blocks(A27: torch.Tensor) -> torch.Tensor:
    """3x3 diagonal blocks (nx,ny,nz,3,3) — the block-Jacobi input."""
    return A27[..., DIAG_OFFSET, :, :]
