"""Preconditioners for the Krylov solvers (torch form of
``macroc_tpu/solve/precond.py``): Jacobi (point diagonal, the reference's
PCJACOBI), block-Jacobi over the 3x3 dof blocks, and identity, as closures
``z = M^{-1} r`` over (3,nx,ny,nz) SoA fields; and Jacobi from the flat
micro-RVE layout over (...,nx,ny,nz,3) fields."""

from __future__ import annotations

import torch

from macroc_tpu_torch.fem.kernels import DIAG_OFFSET
from macroc_tpu_torch.ops.stencil import stencil_diag, stencil_diag_blocks
from macroc_tpu_torch.ops.stencil_spmv import from_soa


def identity_precond():
    return lambda r: r


def jacobi_precond_flat(Af: torch.Tensor):
    """z = r / diag(A) from the FLAT block layout Af (...,nx,ny,nz,243):
    the diagonal entries live at j = 9*DIAG_OFFSET + 4*d."""
    d0 = 9 * DIAG_OFFSET
    inv_diag = 1.0 / Af[..., d0:d0 + 9:4]

    def apply(r):
        return r * inv_diag

    return apply


def jacobi_precond_soa(A_soa: torch.Tensor):
    """z = r / diag(A), A_soa (27,3,3,nx,ny,nz)."""
    inv = (1.0 / stencil_diag(from_soa(A_soa))).permute(3, 0, 1, 2).contiguous()

    def apply(r):
        return r * inv

    return apply


def block_jacobi_precond_soa(A_soa: torch.Tensor):
    """z = D_block^{-1} r with D_block the 3x3 nodal diagonal blocks."""
    inv = inv3x3(stencil_diag_blocks(from_soa(A_soa)))  # (nx,ny,nz,3,3)

    def apply(r):
        return torch.einsum("xyzde,exyz->dxyz", inv, r)

    return apply


def inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (cofactor form); m: (..., 3, 3)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co00 = e * i - f * h
    co01 = c * h - b * i
    co02 = b * f - c * e
    co10 = f * g - d * i
    co11 = a * i - c * g
    co12 = c * d - a * f
    co20 = d * h - e * g
    co21 = b * g - a * h
    co22 = a * e - b * d
    det = a * co00 + b * co10 + c * co20
    adj = torch.stack(
        [
            torch.stack([co00, co01, co02], dim=-1),
            torch.stack([co10, co11, co12], dim=-1),
            torch.stack([co20, co21, co22], dim=-1),
        ],
        dim=-2,
    )
    return adj / det[..., None, None]
