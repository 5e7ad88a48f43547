"""Batched element kernels on global node-centric tensors (torch form of
``macroc_tpu/fem/kernels.py``, the subset the macro Newton step runs).

Layouts are the reference's:

  - displacement field  u : (nx, ny, nz, 3)          node-centric
  - per-GP strain     eps : (nex, ney, nez, 8, 6)    element-centric
  - per-GP tangent     C  : (nex, ney, nez, 8, 6, 6)
  - stencil matrix  A_soa : (27, 3, 3, nx, ny, nz)   SoA block stencil

Element gather is 8 shifted slices; the residual scatter-add is 8 shifted
in-place slice adds — each node position is written once per add, so no
atomics are needed.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from macroc_tpu_torch.fem.element import NODE_OFFSETS, NPE

# Stencil offset table: offset index o <-> displacement (di,dj,dk) in
# {-1,0,1}^3, ordered o = (di+1)*9 + (dj+1)*3 + (dk+1).  The self-coupling
# (diagonal) block is offset 13.
STENCIL_OFFSETS = np.array(
    [(di, dj, dk) for di in (-1, 0, 1) for dj in (-1, 0, 1) for dk in (-1, 0, 1)],
    dtype=np.int64,
)
DIAG_OFFSET = 13
N_STENCIL = 27


def offset_index(di: int, dj: int, dk: int) -> int:
    return (di + 1) * 9 + (dj + 1) * 3 + (dk + 1)


def gather_element_dofs(u: torch.Tensor) -> torch.Tensor:
    """(nx,ny,nz,3) -> (nex,ney,nez,8,3): nodal dofs of every element."""
    nx, ny, nz = u.shape[:3]
    nex, ney, nez = nx - 1, ny - 1, nz - 1
    return torch.stack(
        [u[di:di + nex, dj:dj + ney, dk:dk + nez] for di, dj, dk in NODE_OFFSETS],
        dim=3,
    )


def compute_strains(u: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Strain at all Gauss points of all elements: (nex,ney,nez,8,6).

    eps[e, gp, v] = sum_{n,d} B[gp,v,n,d] * u_e[n,d]."""
    u8 = gather_element_dofs(u)
    ne = u8.shape[:3]
    # (E, 24) @ (24, 48): one plain matrix product over all elements
    Bm = B.permute(2, 3, 0, 1).reshape(NPE * 3, -1)
    return (u8.reshape(-1, NPE * 3) @ Bm).reshape(ne + B.shape[:2])


def scatter_add_elements(
    fe: torch.Tensor, grid_shape: Tuple[int, int, int]
) -> torch.Tensor:
    """Scatter per-element nodal values (nex,ney,nez,8,3) into the global
    node array (nx,ny,nz,3) by summation: eight shifted in-place adds."""
    nx, ny, nz = grid_shape
    nex, ney, nez = nx - 1, ny - 1, nz - 1
    f = torch.zeros((nx, ny, nz, fe.shape[-1]), dtype=fe.dtype, device=fe.device)
    for n, (di, dj, dk) in enumerate(NODE_OFFSETS):
        f[di:di + nex, dj:dj + ney, dk:dk + nez] += fe[..., n, :]
    return f


def assemble_residual(
    stress: torch.Tensor, B: torch.Tensor, wg: float,
    grid_shape: Tuple[int, int, int],
) -> torch.Tensor:
    """Internal-force residual f = sum_e B^T sigma * wg, scattered to nodes
    (before BC zeroing and negation)."""
    ne = stress.shape[:3]
    # (E, 48) @ (48, 24)
    Bm = B.reshape(-1, NPE * 3)
    fe = (stress.reshape(-1, Bm.shape[0]) @ Bm) * wg
    return scatter_add_elements(fe.reshape(ne + (NPE, 3)), grid_shape)


def assemble_stencil_soa(
    ctan: torch.Tensor,
    B: torch.Tensor,
    wg: float,
    grid_shape: Tuple[int, int, int],
    block: int = 16,
) -> torch.Tensor:
    """Assemble the 27-point block-stencil matrix in SoA layout
    A_soa (27,3,3,nx,ny,nz) from per-GP tangents ctan (nex,ney,nez,8,6,6).

    The slab form of the reference (row slabs along x; per slab one einsum
    of the pairwise element blocks, then the 64 node pairs summed into their
    stencil offsets).  It is the plain version of the K2 assembly: the
    independent oracle the kernel path is checked against.  ``block`` bounds
    the per-slab pairwise transient."""
    nx, ny, nz = grid_shape
    # zero element padding: cp[i] = ctan[i-1] per dim (zeros outside), so
    # row r's contributing elements r-1 and r are cp[r] and cp[r+1]
    cp = torch.nn.functional.pad(ctan, (0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1))
    slabs = []
    for x0 in range(0, nx, block):
        nb = min(block, nx - x0)
        cs = cp[x0:x0 + nb + 1]
        # (a-node, d, b-node, e, x, y, z) pairwise element blocks
        Ae = torch.einsum("gvnd,xyzgvw,gwme->ndmexyz", B, cs, B) * wg
        parts = [None] * N_STENCIL
        for a in range(NPE):
            oax, oay, oaz = NODE_OFFSETS[a]
            for b in range(NPE):
                ob = NODE_OFFSETS[b]
                o = offset_index(ob[0] - oax, ob[1] - oay, ob[2] - oaz)
                contrib = Ae[
                    a, :, b, :,
                    1 - oax:1 - oax + nb,
                    1 - oay:1 - oay + ny,
                    1 - oaz:1 - oaz + nz,
                ]
                parts[o] = contrib if parts[o] is None else parts[o] + contrib
        slabs.append(torch.stack(parts, dim=0))  # (27,3,3,nb,ny,nz)
    return torch.cat(slabs, dim=3)
