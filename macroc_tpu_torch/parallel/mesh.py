"""The rank grid and each rank's block of the padded node box (torch form
of ``macroc_tpu/parallel/mesh.py``).

The reference decomposes the grid over MPI ranks with DMDA (uneven
per-rank extents).  The JAX package pads the node box up to multiples of
the (px, py, pz) device grid so every device holds an equal block
(``macroc_tpu/problem.py:160-206``); the port keeps that layout, so a JAX
N-device state maps onto N ranks block for block:

  - node fields      u : (nx, ny, nz, 3)       rank block (bx, by, bz, 3)
  - GP fields  eps, sig : (nx, ny, nz, 8, ...)  rank block (bx, by, bz, 8, ...)

Padded nodes are Dirichlet-0 and padded element slots inactive.  Ranks are
numbered x fastest (PETSc order, ``grid.rank_coords``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from macroc_tpu_torch.grid import StructuredGrid3D
from macroc_tpu_torch.parallel.distributed import Comm


def padded_node_shape(grid: StructuredGrid3D) -> Tuple[int, int, int]:
    """The node box padded up to multiples of the rank grid."""
    return tuple(-(-n // p) * p for n, p in zip((grid.nx, grid.ny, grid.nz), grid.procs))


class RankMesh:
    """This rank's coordinates, neighbours and block in the rank grid of
    ``grid.procs``; ``comm`` carries its traffic."""

    def __init__(self, grid: StructuredGrid3D, comm: Comm):
        if comm.world != grid.nproc:
            raise ValueError(
                f"processor grid {'x'.join(map(str, grid.procs))} needs {grid.nproc} "
                f"ranks, the process group has {comm.world}"
            )
        self.grid = grid
        self.comm = comm
        self.node_shape = padded_node_shape(grid)
        self.block = tuple(n // p for n, p in zip(self.node_shape, grid.procs))
        self.coords = grid.rank_coords(comm.rank)
        self.start = tuple(c * b for c, b in zip(self.coords, self.block))
        #: per axis: is it split over more than one rank
        self.split = tuple(p > 1 for p in grid.procs)

    def neighbors(self, axis: int) -> Tuple[Optional[int], Optional[int]]:
        """(lo, hi) ranks beside this one along ``axis``; None at the
        global boundary."""
        c = list(self.coords)
        out = []
        for step in (-1, 1):
            c[axis] = self.coords[axis] + step
            inside = 0 <= c[axis] < self.grid.procs[axis]
            out.append(self.grid.rank_from_coords(*c) if inside else None)
        return out[0], out[1]

    def slices(self, rank: Optional[int] = None) -> Tuple[slice, slice, slice]:
        """The block of ``rank`` (this rank by default) in the padded box."""
        coords = self.coords if rank is None else self.grid.rank_coords(rank)
        return tuple(slice(c * b, (c + 1) * b) for c, b in zip(coords, self.block))

    def local(self, a):
        """This rank's block of a global field (numpy or tensor, spatial
        dims leading, at the padded node shape)."""
        if tuple(a.shape[:3]) != self.node_shape:
            raise ValueError(f"global field {tuple(a.shape)} is not at the padded "
                             f"node shape {self.node_shape}")
        return a[self.slices()]

    def gather(self, t: torch.Tensor) -> np.ndarray:
        """The global field (padded node shape) from every rank's block, on
        every rank (a collective)."""
        parts = self.comm.gather(t)
        out = np.empty(self.node_shape + tuple(t.shape[3:]), dtype=parts[0].numpy().dtype)
        for r, part in enumerate(parts):
            out[self.slices(r)] = part.numpy()
        return out
