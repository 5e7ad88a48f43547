"""Dirichlet boundary conditions as masks + value fields (torch form of
``macroc_tpu/bc.py``).

A boolean node-dof mask plus a unit-load value field, both dense
(nx, ny, nz, 3), built once on the host.  Two BC cases:

  BC_BENDING: face x=0 all dofs fixed to 0; face x=LX dofs (x,z) fixed to 0,
              dof y driven to U.
  BC_CIRCLE:  the 4 edges of face y=0 fixed to 0; face y=LY nodes inside the
              circle (with the reference's half-cell offset) have dof y
              driven to U.

Jacobian elimination is symmetric (rows + columns zeroed, unit diagonal),
matching MatZeroRowsColumns(A, ..., 1.0, NULL, NULL).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from macroc_tpu.config import BC_BENDING, BC_CIRCLE, MacroConfig
from macroc_tpu.grid import StructuredGrid3D
from macroc_tpu_torch.fem.kernels import DIAG_OFFSET, STENCIL_OFFSETS


@dataclasses.dataclass(frozen=True)
class BCData:
    """mask: True where the dof is Dirichlet; val_unit: prescribed value per
    unit load factor U (value(U) = val_unit * U)."""

    mask: torch.Tensor      # (nx, ny, nz, 3) bool
    val_unit: torch.Tensor  # (nx, ny, nz, 3) dtype


def build_bc(
    grid: StructuredGrid3D, cfg: MacroConfig, dtype: torch.dtype,
    device: torch.device,
) -> BCData:
    nx, ny, nz = grid.nx, grid.ny, grid.nz
    mask = np.zeros((nx, ny, nz, 3), dtype=bool)
    val = np.zeros((nx, ny, nz, 3), dtype=np.float64)
    if cfg.bc_type == BC_BENDING:
        mask[0] = True               # face x = 0, all dofs = 0
        mask[nx - 1] = True          # face x = LX
        val[nx - 1, :, :, 1] = 1.0   # dof y driven to U
    elif cfg.bc_type == BC_CIRCLE:
        mask[0, 0] = True                   # x=0 edge, along z
        mask[nx - 1, 0] = True              # x=LX edge, along z
        mask[1:nx - 1, 0, 0] = True         # z=0 edge, interior x
        mask[1:nx - 1, 0, nz - 1] = True    # z=LZ edge, interior x
        i = np.arange(nx)
        k = np.arange(nz)
        x = grid.lx / 2.0 - (i * grid.dx + grid.dx / 2.0)
        z = grid.lz / 2.0 - (k * grid.dz + grid.dz / 2.0)
        inside = (x[:, None] ** 2 + z[None, :] ** 2) < cfg.rad**2
        mask[:, ny - 1, :, 1] |= inside
        val[:, ny - 1, :, 1] = np.where(inside, 1.0, val[:, ny - 1, :, 1])
    else:
        raise ValueError(f"unknown bc_type {cfg.bc_type}")
    return BCData(
        mask=torch.as_tensor(mask, device=device),
        val_unit=torch.as_tensor(val, dtype=dtype, device=device),
    )


def apply_bc_on_u(U: float, u: torch.Tensor, bc: BCData) -> torch.Tensor:
    """Insert prescribed values into u (reference apply_bc_on_u)."""
    return torch.where(bc.mask, bc.val_unit * U, u)


def apply_bc_on_res(b: torch.Tensor, bc: BCData) -> torch.Tensor:
    """Zero residual entries at Dirichlet dofs."""
    return b.masked_fill(bc.mask, 0.0)


def neighbor_mask_soa(mask_soa: torch.Tensor) -> torch.Tensor:
    """(27,3,nx,ny,nz): Dirichlet mask of the neighbour at each stencil
    offset (False outside the domain), from an SoA mask (3,nx,ny,nz)."""
    nx, ny, nz = mask_soa.shape[1:]
    mp = torch.nn.functional.pad(mask_soa, (1, 1, 1, 1, 1, 1))
    return torch.stack(
        [
            mp[:, 1 + di:1 + di + nx, 1 + dj:1 + dj + ny, 1 + dk:1 + dk + nz]
            for di, dj, dk in STENCIL_OFFSETS
        ],
        dim=0,
    )


def apply_bc_stencil_soa(A_soa: torch.Tensor, bc: BCData) -> torch.Tensor:
    """Symmetric Dirichlet elimination on the SoA stencil (27,3,3,nx,ny,nz),
    IN PLACE (the operator is 2 GB in f32 at 128^3; a copy per masking step
    would double the step's peak memory).  Returns A_soa."""
    mask = bc.mask.permute(3, 0, 1, 2)  # (3,nx,ny,nz)
    # rows: A[o, d, :, p] = 0 where mask[d, p]
    A_soa.masked_fill_(mask[None, :, None], 0.0)
    # cols: A[o, :, e, p] = 0 where the o-neighbour of p has mask[e, .]
    A_soa.masked_fill_(neighbor_mask_soa(mask)[:, None], 0.0)
    # unit diagonal at constrained dofs
    for d in range(3):
        A_soa[DIAG_OFFSET, d, d] += mask[d].to(A_soa.dtype)
    return A_soa
