"""The 27-point block stencil outside the SoA kernels (torch form of the
parts of ``macroc_tpu/ops/stencil.py`` the port runs): the flat-layout
matvec of the micro RVEs, and the diagonal extraction the SoA
preconditioners need.

The diagonal helpers take the AoS view A27 (nx,ny,nz,27,3,3); for an SoA
operator pass ``from_soa(A_soa)``, which in torch is a view, not a copy."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from macroc_tpu_torch.fem.kernels import DIAG_OFFSET, N_STENCIL, STENCIL_OFFSETS


def stencil_matvec_flat(Af: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x with the stencil in FLAT block layout Af (...,nx,ny,nz,243)
    (entry j = o*9 + d*3 + e; fem.kernels.assemble_stencil_flat) and
    x, y (...,nx,ny,nz,3).  Af's leading dims broadcast against x's, so one
    operator can act on a batch of vectors.

    The 27 shifted windows of the zero-padded x are gathered once, then
    y[d] = sum over (o, e) of Af[o,d,e] * x_o[e] in one product and one
    reduction."""
    nx, ny, nz = x.shape[-4:-1]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    xs = torch.stack(
        [xp[..., 1 + di:1 + di + nx, 1 + dj:1 + dj + ny, 1 + dk:1 + dk + nz, :]
         for di, dj, dk in STENCIL_OFFSETS],
        dim=-2,
    )  # (..., nx, ny, nz, 27, 3)
    blocks = Af.unflatten(-1, (N_STENCIL, 3, 3))
    return (blocks * xs.unsqueeze(-2)).sum(dim=(-3, -1))


def stencil_diag(A27: torch.Tensor) -> torch.Tensor:
    """Point diagonal (nx,ny,nz,3) — the Jacobi preconditioner input."""
    return torch.diagonal(A27[..., DIAG_OFFSET, :, :], dim1=-2, dim2=-1)


def stencil_diag_blocks(A27: torch.Tensor) -> torch.Tensor:
    """3x3 diagonal blocks (nx,ny,nz,3,3) — the block-Jacobi input."""
    return A27[..., DIAG_OFFSET, :, :]
