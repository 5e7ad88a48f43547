"""Reaction-force quantities of interest (torch form of
``macroc_tpu/forces.py``), from the per-GP stress of the last homogenize.

BC_BENDING: sum of sigma_xy (Voigt 3) over the last x-layer of elements and
            their 8 GPs, times dy*dz (no division by NGP, as the reference).
BC_CIRCLE:  sum of sigma_yy (Voigt 1) over last-y-layer elements whose test
            point lies inside the circle, times dx*dz.
"""

from __future__ import annotations

import numpy as np
import torch

from macroc_tpu.config import BC_BENDING, BC_CIRCLE, MacroConfig
from macroc_tpu.grid import StructuredGrid3D


def circle_element_mask(grid: StructuredGrid3D, rad: float) -> np.ndarray:
    """(nex, nez) bool: elements whose test point lies inside the circle."""
    ex = np.arange(grid.nx - 1)
    ez = np.arange(grid.nz - 1)
    x = grid.lx / 2.0 - (ex * grid.dx + grid.dx / 2.0)
    z = grid.lz / 2.0 - (ez * grid.dz + grid.dz / 2.0)
    return (x[:, None] ** 2 + z[None, :] ** 2) < rad * rad


def calc_force(stress: torch.Tensor, grid: StructuredGrid3D, cfg: MacroConfig):
    """stress: (nex, ney, nez, 8, 6) per-GP Voigt stress; returns a 0-dim
    tensor."""
    if cfg.bc_type == BC_BENDING:
        return torch.sum(stress[-1, :, :, :, 3]) * (grid.dy * grid.dz)
    if cfg.bc_type == BC_CIRCLE:
        mask = torch.as_tensor(circle_element_mask(grid, cfg.rad), device=stress.device)
        syy = stress[:, -1, :, :, 1]  # (nex, nez, 8) at the last y layer
        return torch.sum(torch.where(mask[:, :, None], syy, 0.0)) * (grid.dx * grid.dz)
    raise ValueError(f"unknown bc_type {cfg.bc_type}")


def per_rank_nonlinear_counts_device(
    non_linear: torch.Tensor, grid: StructuredGrid3D
) -> torch.Tensor:
    """Per-rank non-linear GP counts for the gauss_evolution.dat row: (1,)
    on the one device the port runs on."""
    if grid.nproc != 1:
        raise NotImplementedError("the torch port runs on one device")
    return non_linear.sum().reshape(1)
