"""Reaction-force quantities of interest (torch form of
``macroc_tpu/forces.py``), from the per-GP stress of the last homogenize.

BC_BENDING: sum of sigma_xy (Voigt 3) over the last x-layer of elements and
            their 8 GPs, times dy*dz (no division by NGP, as the reference).
BC_CIRCLE:  sum of sigma_yy (Voigt 1) over last-y-layer elements whose test
            point lies inside the circle, times dx*dz.

On a rank of a domain-decomposed run the stress is the rank's block of
element slots (``origin`` its first global slot, inactive slots zero): each
function returns the rank's part of the global quantity, for the caller to
all-reduce (the reference's MPI_Reduce, forces.c:47).
"""

from __future__ import annotations

import numpy as np
import torch

from macroc_tpu_torch.config import BC_BENDING, BC_CIRCLE, MacroConfig
from macroc_tpu_torch.grid import StructuredGrid3D


def circle_element_mask(grid: StructuredGrid3D, rad: float) -> np.ndarray:
    """(nex, nez) bool: elements whose test point lies inside the circle."""
    ex = np.arange(grid.nx - 1)
    ez = np.arange(grid.nz - 1)
    x = grid.lx / 2.0 - (ex * grid.dx + grid.dx / 2.0)
    z = grid.lz / 2.0 - (ez * grid.dz + grid.dz / 2.0)
    return (x[:, None] ** 2 + z[None, :] ** 2) < rad * rad


def calc_force(stress: torch.Tensor, grid: StructuredGrid3D, cfg: MacroConfig,
               origin=(0, 0, 0)):
    """stress: (ex, ey, ez, 8, 6) per-GP Voigt stress of the element slots
    from global slot ``origin`` on (the whole real element box by
    default); returns a 0-dim tensor, zero where the block misses the
    force's element layer."""
    if cfg.bc_type not in (BC_BENDING, BC_CIRCLE):
        raise ValueError(f"unknown bc_type {cfg.bc_type}")
    x0, y0, z0 = origin
    lx, ly, lz = stress.shape[:3]
    if cfg.bc_type == BC_BENDING:
        i = grid.nx - 2 - x0  # the last x-layer of elements
        if not 0 <= i < lx:
            return stress.new_zeros(())
        return torch.sum(stress[i, :, :, :, 3]) * (grid.dy * grid.dz)
    j = grid.ny - 2 - y0  # the last y-layer of elements
    if not 0 <= j < ly:
        return stress.new_zeros(())
    full = circle_element_mask(grid, cfg.rad)
    mask = np.zeros((lx, lz), dtype=bool)
    part = full[x0:x0 + lx, z0:z0 + lz]
    mask[:part.shape[0], :part.shape[1]] = part
    syy = stress[:, j, :, :, 1]  # (ex, ez, 8) at the last y layer
    mask = torch.as_tensor(mask, device=stress.device)
    return torch.sum(torch.where(mask[:, :, None], syy, 0.0)) * (grid.dx * grid.dz)


def per_rank_nonlinear_counts_device(
    non_linear: torch.Tensor, grid: StructuredGrid3D, origin=(0, 0, 0)
) -> torch.Tensor:
    """Non-linear GP counts per DMDA rank box (``grid.local_box``, the
    reference's gauss_evolution.dat columns, util.c:69-87): (nproc,) int64.
    ``non_linear`` (ex, ey, ez, 8) holds the element slots from global slot
    ``origin`` on, so on a rank of a decomposed run each entry counts the
    box's part in the rank's block (its padded block, not the DMDA box),
    and the sum over ranks is the column."""
    counts = []
    for r in range(grid.nproc):
        b = grid.local_box(r)
        sl = tuple(
            slice(max(s - o, 0), max(min(s + n - o, size), 0))
            for s, n, o, size in zip((b.si, b.sj, b.sk), (b.nex, b.ney, b.nez), origin,
                                     non_linear.shape[:3])
        )
        counts.append(non_linear[sl].sum())
    return torch.stack(counts).to(torch.int64)
