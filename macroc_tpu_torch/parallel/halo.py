"""Halo exchange between neighbour ranks (torch form of
``macroc_tpu/parallel/halo.py``): the counterparts of the reference's
DMGlobalToLocal (forward INSERT) and DMLocalToGlobal (reverse ADD)
scatters (src/assembly.c:40-41, 164-165), over ``Comm.shift``'s
point-to-point sends.

  halo_exchange   grow each local block by 1 node per face with the
                  neighbours' data (zeros at the global boundary); the
                  axes go x, y, z in turn, so later rounds forward the
                  halos already received and edges and corners arrive too
                  (DMDA's box-stencil scatter);
  halo_fold_add   add the halo slabs back onto the ranks that own them,
                  axes in reverse order;
  fold_high_plane the one-sided fold of node-indexed assembly from owned
                  elements;
  ghosted_blocks  halo_exchange of width h per axis, for the VTU pieces;
  axis_gather     the whole line of blocks along one rank-grid axis on
                  every rank of it (MG's line solves on a split line dim).

``assemble_stencil_local`` and ``stencil_matvec_local`` wire them around
kernels K2 and K1.  The JAX package's ``overlap=True`` matvec is not
ported (it was slower on the TPU and stays an experiment there).
"""

from __future__ import annotations

from typing import Sequence

import torch

from macroc_tpu_torch.ops.stencil_spmv import stencil_matvec
from macroc_tpu_torch.parallel.mesh import RankMesh


def exchange_axis(x: torch.Tensor, mesh: RankMesh, axis: int, dim: int,
                  width: int = 1) -> torch.Tensor:
    """Grow ``x`` by a ``width``-node slab on each side of ``dim`` with the
    faces of the neighbours along rank-grid ``axis`` (one hop: width must
    not exceed the local extent)."""
    L = x.shape[dim]
    if width > L:
        raise ValueError(f"halo width {width} exceeds local extent {L} on dim {dim}")
    lo, hi = mesh.neighbors(axis)
    # my high face -> the hi neighbour's low halo; my low face -> the lo
    # neighbour's high halo
    from_lo, from_hi = mesh.comm.shift(
        x.narrow(dim, 0, width), x.narrow(dim, L - width, width), lo, hi
    )
    return torch.cat([from_lo, x, from_hi], dim=dim)


def fold_axis_add(xe: torch.Tensor, mesh: RankMesh, axis: int, dim: int) -> torch.Tensor:
    """Reverse of exchange_axis: add the two halo slabs of ``dim`` onto the
    neighbours that own them; return the core block."""
    L = xe.shape[dim] - 2
    lo, hi = mesh.neighbors(axis)
    # my low halo belongs to the lo neighbour's last plane, my high halo to
    # the hi neighbour's first plane
    recv_lo, recv_hi = mesh.comm.shift(
        xe.narrow(dim, 0, 1), xe.narrow(dim, L + 1, 1), lo, hi
    )
    core = xe.narrow(dim, 1, L)
    if L == 1:
        return core + recv_lo + recv_hi
    return torch.cat([core.narrow(dim, 0, 1) + recv_lo, core.narrow(dim, 1, L - 2),
                      core.narrow(dim, L - 1, 1) + recv_hi], dim=dim)


def halo_exchange(x: torch.Tensor, mesh: RankMesh, dims: Sequence[int] = (0, 1, 2)) -> torch.Tensor:
    """Box-stencil forward halo exchange (INSERT) over the three axes."""
    for axis, dim in enumerate(dims):
        x = exchange_axis(x, mesh, axis, dim)
    return x


def halo_fold_add(xe: torch.Tensor, mesh: RankMesh, dims: Sequence[int] = (0, 1, 2)) -> torch.Tensor:
    """Box-stencil reverse halo fold (ADD) over the three axes, z first."""
    for axis, dim in reversed(list(enumerate(dims))):
        xe = fold_axis_add(xe, mesh, axis, dim)
    return xe


def ghosted_blocks(arrays: Sequence[torch.Tensor], mesh: RankMesh,
                   halo: Sequence[int] = (1, 1, 1)) -> list:
    """DMGlobalToLocal INSERT with a halo of ``halo[d]`` nodes on dim d:
    each array (this rank's block, spatial dims leading) grown to the
    true values of global region [start - h, start + block + h), zeros
    beyond the grid (``macroc_tpu/parallel/halo.py:113-147``): width-h
    exchange rounds along x, y, z, so edges and corners arrive too.  The
    per-process patches of the VTU pieces (``io/parallel_vtu.py``)."""
    out = []
    for x in arrays:
        for axis, w in enumerate(halo):
            x = exchange_axis(x, mesh, axis, axis, width=w)
        out.append(x)
    return out


def axis_gather(x: torch.Tensor, mesh: RankMesh, axis: int, dim: int) -> torch.Tensor:
    """The blocks ``x`` of the ranks that share this rank's two other
    rank-grid coordinates (its line group along ``axis``), concatenated
    along ``dim`` in coordinate order, on every rank of the group.

    p - 1 rounds of ``Comm.shift`` pass the pieces on both ways, each rank
    forwarding what it received last: every rank posts the same calls in
    the same order, no sub-communicator exists, and on an unsplit axis (one
    process included) it is the identity.  Pieces from beyond the grid's
    ends arrive as zeros and are dropped."""
    p, c = mesh.grid.procs[axis], mesh.coords[axis]
    if p == 1:
        return x
    lo, hi = mesh.neighbors(axis)
    pieces = {c: x}
    up = down = x  # the pieces travelling to higher / lower coordinates
    for k in range(1, p):
        up, down = mesh.comm.shift(down, up, lo, hi)
        if c - k >= 0:
            pieces[c - k] = up
        if c + k < p:
            pieces[c + k] = down
    return torch.cat([pieces[i] for i in range(p)], dim=dim)


def fold_high_plane(xe: torch.Tensor, mesh: RankMesh, axis: int, dim: int) -> torch.Tensor:
    """Fold the single extra high plane of ``dim`` onto the hi neighbour's
    first plane; return the core (a view).

    A rank that owns element slots [0, L) of an axis adds into local nodes
    [0, L]; node L is the next rank's node 0.  The last rank's extra plane
    holds only its inactive (zeroed) trailing element slots, so dropping it
    is exact, as in halo_fold_add."""
    L = xe.shape[dim] - 1
    lo, hi = mesh.neighbors(axis)
    recv, _ = mesh.comm.shift(None, xe.narrow(dim, L, 1), lo, hi)
    core = xe.narrow(dim, 0, L)
    core.narrow(dim, 0, 1).add_(recv)
    return core


def assemble_stencil_local(ctan_l: torch.Tensor, B: torch.Tensor, wg: float,
                           mesh: RankMesh, assemble_fn) -> torch.Tensor:
    """This rank's rows of the stencil A_soa (27,3,3,bx,by,bz) from its
    node-shaped tangent block ctan_l (bx,by,bz,8,6,6; inactive slots
    zero), with the one-device assembler ``assemble_fn(ctan, B, wg,
    grid_shape)`` (kernel K2 on the card).

    On a split axis the rank assembles its element slots onto its nodes
    plus one (the next rank's first plane), which ``fold_high_plane`` then
    sends on; on an unsplit axis it crops the inactive trailing slot.  The
    assembler reads a slice of ctan_l in place."""
    ln = ctan_l.shape[:3]
    sl = tuple(slice(0, n if s else n - 1) for n, s in zip(ln, mesh.split))
    grid_l = tuple(n + (1 if s else 0) for n, s in zip(ln, mesh.split))
    A = assemble_fn(ctan_l[sl], B, wg, grid_l)
    for axis in range(3):
        if mesh.split[axis]:
            A = fold_high_plane(A, mesh, axis, 3 + axis)
    return A.contiguous()


def stencil_matvec_local(A_l: torch.Tensor, x_l: torch.Tensor, mesh: RankMesh) -> torch.Tensor:
    """y = A x on this rank's block (SoA, x_l (3,bx,by,bz)): exchange x's
    halo, then K1 in its halo form (its plain version on a CPU tensor)."""
    return stencil_matvec(A_l, halo_exchange(x_l, mesh, dims=(1, 2, 3)), halo=True)
