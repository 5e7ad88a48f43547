"""Geometric multigrid preconditioner for the 27-point block-stencil system
(torch form of ``macroc_tpu/solve/mg.py``).

  - coarsening: coarse node i <-> fine node min(2i, n-1), per dimension
    (semicoarsening: a dim coarsens only while its extent exceeds
    ``min_extent``, so ny=3 pancakes coarsen x/z only);
  - coarse operators by rediscretization: coarse per-GP tangents are the
    average of the child elements' tangents, assembled with the same
    stencil assembler as the fine level;
  - smoother: damped 3x3 block-Jacobi on cube hierarchies, red-black LINE
    Gauss-Seidel along the thin dim of a semicoarsened pancake hierarchy;
  - symmetric V(nu,nu) with R = P^T and an exact dense coarsest solve, so
    the V-cycle is a fixed SPD operator, legal as a PCG preconditioner.

Transfers and the tangent coarsening are products with small dense 1-D
matrices along one axis: deterministic on the card (no scatter-add atomics)
and R = P^T exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from macroc_tpu_torch import bc as bc_mod
from macroc_tpu_torch.fem.element import b_matrix
from macroc_tpu_torch.fem.kernels import (
    DIAG_OFFSET,
    STENCIL_OFFSETS,
    assemble_stencil_soa,
    offset_index,
)
from macroc_tpu_torch.ops.stencil_spmv import stencil_matvec_soa


def _inv3x3_soa(D: torch.Tensor) -> torch.Tensor:
    """Inverse of per-node 3x3 blocks in SoA layout D (3,3,nx,ny,nz), via
    the adjugate — nine elementwise plane products, no layout change."""
    a, b, c = D[0, 0], D[0, 1], D[0, 2]
    d, e, f = D[1, 0], D[1, 1], D[1, 2]
    g, h, i = D[2, 0], D[2, 1], D[2, 2]
    A = e * i - f * h
    Dd = f * g - d * i
    G = d * h - e * g
    det = a * A + b * Dd + c * G
    r0 = torch.stack([A, c * h - b * i, b * f - c * e])
    r1 = torch.stack([Dd, a * i - c * g, c * d - a * f])
    r2 = torch.stack([G, b * g - a * h, a * e - b * d])
    return torch.stack([r0, r1, r2]) / det


def coarse_size(n: int) -> int:
    """Coarse node i <-> fine node min(2i, n-1).  Even extents keep the last
    fine node as an extra coarse node, so no coarse level loses the high
    Dirichlet face."""
    return n // 2 + 1


def coarse_positions(n_f: int) -> np.ndarray:
    """Fine index of each coarse node."""
    return np.minimum(2 * np.arange(coarse_size(n_f)), n_f - 1)


def _interp_tables(n_f: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(left parent, right parent, left weight) per fine index — linear
    interpolation between the bracketing coarse nodes."""
    n_c = coarse_size(n_f)
    fpos = coarse_positions(n_f)
    li = np.empty(n_f, np.int64)
    ri = np.empty(n_f, np.int64)
    wl = np.empty(n_f, np.float64)
    for i in range(n_f):
        if i == n_f - 1:
            li[i] = ri[i] = n_c - 1
            wl[i] = 1.0
        elif i % 2 == 0:
            li[i] = ri[i] = i // 2
            wl[i] = 1.0
        else:
            l, r = i // 2, min(i // 2 + 1, n_c - 1)
            li[i], ri[i] = l, r
            wl[i] = 1.0 if l == r else (fpos[r] - i) / (fpos[r] - fpos[l])
    return li, ri, wl


def _interp_tables_k(n_f: int, order: int) -> Tuple[np.ndarray, np.ndarray]:
    """Parent/weight tables (idx (n_f, K), w (n_f, K)): order 1 linear
    (K=2), order 3 cubic Lagrange through the 4 nearest coarse nodes (K=4;
    one-sided windows at the ends).  Cubic transfers keep the semicoarsened
    pancake V-cycle flat in grid size (thin-plate bending is
    biharmonic-like)."""
    n_c = coarse_size(n_f)
    fpos = coarse_positions(n_f)
    if order == 1 or n_c < 4:
        li, ri, wl = _interp_tables(n_f)
        return np.stack([li, ri], axis=1), np.stack([wl, 1.0 - wl], axis=1)
    if order != 3:
        raise ValueError(f"transfer order must be 1 or 3, got {order}")
    idx = np.zeros((n_f, 4), np.int64)
    w = np.zeros((n_f, 4), np.float64)
    for i in range(n_f):
        hit = np.where(fpos == i)[0]
        if hit.size:
            idx[i, 0] = hit[0]
            w[i, 0] = 1.0
            continue
        j = int(np.searchsorted(fpos, i)) - 1  # fpos[j] < i < fpos[j+1]
        s = min(max(j - 1, 0), n_c - 4)
        xs = fpos[s:s + 4].astype(np.float64)
        for a in range(4):
            L = 1.0
            for c in range(4):
                if c != a:
                    L *= (i - xs[c]) / (xs[a] - xs[c])
            idx[i, a] = s + a
            w[i, a] = L
    return idx, w


def prolong_matrix(n_f: int, order: int) -> np.ndarray:
    """Dense 1-D prolongation P (n_f, n_c) of the interpolation tables."""
    idx, w = _interp_tables_k(n_f, order)
    P = np.zeros((n_f, coarse_size(n_f)))
    for a in range(idx.shape[1]):
        np.add.at(P, (np.arange(n_f), idx[:, a]), w[:, a])
    return P


def _along(u: torch.Tensor, dim: int, M: torch.Tensor) -> torch.Tensor:
    """Contract axis ``dim`` of u with the (n_out, n_in) matrix M."""
    out = torch.tensordot(M, u, dims=([1], [dim]))
    return torch.movedim(out, 0, dim).contiguous()


def transfer_matrices(fine_shape, coarse_shape, order: int, dtype, device):
    """Per-dim 1-D prolongations P (n_f, n_c) between two level shapes, as
    tensors; None where the dim is not coarsened (semicoarsening)."""
    mats = []
    for n_f, n_c in zip(fine_shape, coarse_shape):
        if n_c == n_f:
            mats.append(None)
            continue
        if n_c != coarse_size(n_f):
            raise ValueError(f"coarse extent {n_c} does not coarsen {n_f}")
        mats.append(torch.as_tensor(prolong_matrix(n_f, order), dtype=dtype, device=device))
    return mats


def _prolong_with(u_c: torch.Tensor, mats) -> torch.Tensor:
    for d, P in enumerate(mats):
        if P is not None:
            u_c = _along(u_c, d + 1, P)
    return u_c


def _restrict_with(r_f: torch.Tensor, mats) -> torch.Tensor:
    """Exact transpose of _prolong_with (R = P^T)."""
    for d, P in enumerate(mats):
        if P is not None:
            r_f = _along(r_f, d + 1, P.T)
    return r_f


def prolong(u_c: torch.Tensor, fine_shape, order: int = 1) -> torch.Tensor:
    mats = transfer_matrices(fine_shape, u_c.shape[1:], order, u_c.dtype, u_c.device)
    return _prolong_with(u_c, mats)


def restrict(r_f: torch.Tensor, coarse_shape=None, order: int = 1) -> torch.Tensor:
    """Restrict to ``coarse_shape`` (defaults to coarsening every dim)."""
    if coarse_shape is None:
        coarse_shape = tuple(coarse_size(n) for n in r_f.shape[1:])
    mats = transfer_matrices(r_f.shape[1:], coarse_shape, order, r_f.dtype, r_f.device)
    return _restrict_with(r_f, mats)


def _coarsen_elem_dim(x: torch.Tensor, dim: int, n_f_nodes: int) -> torch.Tensor:
    """Average element pairs along one dim: coarse element j's children are
    the fine elements between coarse nodes j and j+1 (two for a regular
    interval, one for an even extent's short tail, which gets 0.5+0.5)."""
    f_el = x.shape[dim]
    nc_el = coarse_size(n_f_nodes) - 1
    ia = np.minimum(2 * np.arange(nc_el), f_el - 1)
    ib = np.minimum(ia + 1, f_el - 1)
    R = np.zeros((nc_el, f_el), np.float64)
    np.add.at(R, (np.arange(nc_el), ia), 0.5)
    np.add.at(R, (np.arange(nc_el), ib), 0.5)
    return _along(x, dim, torch.as_tensor(R, dtype=x.dtype, device=x.device))


def coarsen_ctan(ctan: torch.Tensor, coarsen=(True, True, True)) -> torch.Tensor:
    """Average fine element tangents (nex,ney,nez,8,6,6) into coarse
    elements; dims with ``coarsen[d]`` False pass through."""
    for dim in range(3):
        if coarsen[dim]:
            ctan = _coarsen_elem_dim(ctan, dim, ctan.shape[dim] + 1)
    return ctan


def _sample_coarse(mask: torch.Tensor, coarsen=(True, True, True)) -> torch.Tensor:
    """Sample a (3,nx,ny,nz) node mask at the coarse node positions."""
    for dim in (1, 2, 3):
        if coarsen[dim - 1]:
            idx = torch.as_tensor(coarse_positions(mask.shape[dim]), device=mask.device)
            mask = torch.index_select(mask, dim, idx)
    return mask


@dataclasses.dataclass(frozen=True)
class MGLevel:
    A_soa: torch.Tensor     # (27,3,3,nx,ny,nz)
    inv_diag: torch.Tensor  # (3,3,nx,ny,nz) inverse nodal blocks (SoA)
    bc_mask: torch.Tensor   # (3,nx,ny,nz) bool
    # dense inverse of the line operator along the thin dim of a
    # semicoarsened hierarchy, (n_perp_a, n_perp_b, 3*n_d, 3*n_d); None ->
    # point block-Jacobi smoothing
    line_inv: Optional[torch.Tensor] = None
    line_dim: int = -1


def _build_line_inv(A_soa: torch.Tensor, d: int) -> torch.Tensor:
    """Dense inverse of the block-tridiagonal line operator along dim d (the
    stencil couplings with zero displacement in the two other dims)."""
    n = A_soa.shape[3 + d]
    perp = [i for i in range(3) if i != d]
    na, nb = A_soa.shape[3 + perp[0]], A_soa.shape[3 + perp[1]]
    M = torch.zeros((na, nb, 3 * n, 3 * n), dtype=A_soa.dtype, device=A_soa.device)
    for delta in (-1, 0, 1):
        off = [0, 0, 0]
        off[d] = delta
        # (na, nb, n, 3row, 3col)
        blk = A_soa[offset_index(*off)].permute(perp[0] + 2, perp[1] + 2, d + 2, 0, 1)
        for j in range(n):
            k = j + delta
            if 0 <= k < n:
                M[:, :, 3 * j:3 * j + 3, 3 * k:3 * k + 3] = blk[:, :, j]
    return torch.linalg.inv(M)


def _line_apply(line_inv: torch.Tensor, d: int, r: torch.Tensor) -> torch.Tensor:
    """z = T^{-1} r for the line operator along dim d; r is (3,nx,ny,nz)."""
    perp = [i for i in range(3) if i != d]
    fwd = (perp[0] + 1, perp[1] + 1, d + 1, 0)
    rc = r.permute(fwd)  # (na, nb, n, 3)
    na, nb, n = rc.shape[:3]
    z = torch.matmul(line_inv, rc.reshape(na, nb, n * 3, 1)).reshape(na, nb, n, 3)
    return z.permute(tuple(int(i) for i in np.argsort(fwd))).contiguous()


def build_hierarchy(
    ctan: torch.Tensor,
    bc_mask_soa: torch.Tensor,
    spacing: Tuple[float, float, float],
    ref_quirk: bool,
    max_levels: int = 10,
    min_extent: int = 3,
    A0_soa: torch.Tensor | None = None,
    assemble_fn=None,
) -> List[MGLevel]:
    """Level list from fine per-GP tangents (element shape).

    Quirk family: the quirk fine operator (unit-element B, real-volume wg)
    equals (8 wg0) x the true-FEM operator of a unit-spacing grid, so the
    hierarchy rediscretizes on a virtual spacing that starts at (1,1,1) and
    doubles along coarsened dims.  ``A0_soa`` reuses an already assembled
    fine operator; ``assemble_fn`` is the per-level stencil assembler."""
    if assemble_fn is None:
        assemble_fn = assemble_stencil_soa
    levels: List[MGLevel] = []
    dtype, device = ctan.dtype, ctan.device
    cur_ctan = ctan
    cur_mask = bc_mask_soa
    wg0 = spacing[0] * spacing[1] * spacing[2] / 8.0
    cur_spacing = (1.0, 1.0, 1.0) if ref_quirk else tuple(spacing)
    fine_shape = tuple(n + 1 for n in ctan.shape[:3])
    # exactly one thin (never deeply coarsenable) dim -> exact line solves
    # along it; cubes keep the point smoother
    thin = [d for d in range(3) if fine_shape[d] <= 2 * min_extent + 1]
    line_dim = thin[0] if len(thin) == 1 else -1
    lev = 0
    while True:
        shape = tuple(n + 1 for n in cur_ctan.shape[:3])
        vol = cur_spacing[0] * cur_spacing[1] * cur_spacing[2]
        wg = wg0 * vol if ref_quirk else vol / 8.0
        if lev == 0 and A0_soa is not None:
            A_soa = A0_soa
        else:
            B = torch.as_tensor(b_matrix(cur_spacing), dtype=dtype, device=device)
            A_soa = bc_mod.apply_bc_stencil_soa(
                assemble_fn(cur_ctan, B, wg, shape),
                bc_mod.BCData(
                    mask=cur_mask.permute(1, 2, 3, 0),
                    val_unit=torch.zeros(shape + (3,), dtype=dtype, device=device),
                ),
            )
        levels.append(
            MGLevel(
                A_soa=A_soa,
                inv_diag=_inv3x3_soa(A_soa[DIAG_OFFSET]),
                bc_mask=cur_mask,
                line_inv=_build_line_inv(A_soa, line_dim) if line_dim >= 0 else None,
                line_dim=line_dim,
            )
        )
        if len(levels) >= max_levels:
            break
        do = tuple(n > min_extent for n in shape)
        if not any(do):
            break
        cur_ctan = coarsen_ctan(cur_ctan, do)
        cur_mask = _sample_coarse(cur_mask, do)
        cur_spacing = tuple(2.0 * h if c else h for h, c in zip(cur_spacing, do))
        lev += 1
    return levels


def _rb_mask(level: MGLevel, color: int) -> torch.Tensor:
    """Checkerboard mask over the two dims perpendicular to the line dim,
    broadcastable against (3, nx, ny, nz)."""
    d = level.line_dim
    sp = level.A_soa.shape[-3:]
    perp = [i for i in range(3) if i != d]
    ia = np.arange(sp[perp[0]])
    ib = np.arange(sp[perp[1]])
    grid = (ia[:, None] + ib[None, :]) % 2 == color
    shape = [1, 1, 1]
    shape[perp[0]] = sp[perp[0]]
    shape[perp[1]] = sp[perp[1]]
    return torch.as_tensor(grid.reshape([1] + shape), device=level.A_soa.device)


def _smooth(level: MGLevel, x: torch.Tensor, b: torch.Tensor, nu: int,
            omega: float, mv, reverse: bool = False, rb=None) -> torch.Tensor:
    """nu smoothing sweeps: damped point block-Jacobi on cube levels;
    red-black line Gauss-Seidel on semicoarsened levels, with ``rb`` the
    level's two colour masks (omega unused; ``reverse`` flips the colour
    order so post-smoothing is the adjoint of pre-smoothing and the V-cycle
    stays SPD)."""
    if level.line_dim >= 0:
        colors = (1, 0) if reverse else (0, 1)
        for _ in range(nu):
            for c in colors:
                r = b - mv(level.A_soa, x)
                dz = _line_apply(level.line_inv, level.line_dim, r)
                x = x + torch.where(rb[c], dz, 0.0)
        return x
    D = level.inv_diag
    for _ in range(nu):
        r = b - mv(level.A_soa, x)
        dz = D[:, 0] * r[0] + D[:, 1] * r[1] + D[:, 2] * r[2]
        x = x + omega * dz
    return x


def _dense_from_soa(A_soa: torch.Tensor) -> torch.Tensor:
    """Small stencil operator as a dense (3N, 3N) matrix, row/col index =
    node*3 + dof (the coarsest MG level only, N <= a few hundred).  Every
    (row, col) pair occurs once, so one indexed write fills it."""
    nx, ny, nz = A_soa.shape[-3:]
    n = nx * ny * nz * 3
    ids = np.arange(nx * ny * nz).reshape(nx, ny, nz)
    rows, cols, vals = [], [], []
    for o, (di, dj, dk) in enumerate(STENCIL_OFFSETS):
        sr = (slice(max(0, -di), nx - max(0, di)),
              slice(max(0, -dj), ny - max(0, dj)),
              slice(max(0, -dk), nz - max(0, dk)))
        sc = (slice(max(0, di), nx - max(0, -di)),
              slice(max(0, dj), ny - max(0, -dj)),
              slice(max(0, dk), nz - max(0, -dk)))
        r, c = ids[sr].reshape(-1), ids[sc].reshape(-1)
        blk = A_soa[o][:, :, sr[0], sr[1], sr[2]].reshape(3, 3, -1)
        for d in range(3):
            for e in range(3):
                rows.append(r * 3 + d)
                cols.append(c * 3 + e)
                vals.append(blk[d, e])
    D = torch.zeros((n, n), dtype=A_soa.dtype, device=A_soa.device)
    idx = torch.as_tensor(np.stack([np.concatenate(rows), np.concatenate(cols)]),
                          device=A_soa.device)
    D[idx[0], idx[1]] = torch.cat(vals)
    return D


def make_mg_preconditioner(
    levels: List[MGLevel], nu: int = 2, omega: float = 0.6,
    coarse_sweeps: int = 20, mv_for: Optional[Callable] = None,
    coarse_direct: bool = True, transfer_order: Optional[int] = None,
):
    """Fixed symmetric V(nu,nu)-cycle closure z = M^{-1} r for PCG.

    ``mv_for(level) -> matvec(A_soa, x)`` picks the per-level SpMV (default:
    the plain version).  ``coarse_direct`` solves the coarsest level exactly
    with a dense inverse (needed by weakly constrained BCs such as the
    circle patch), else ``coarse_sweeps`` smoother sweeps.  omega 0.6: 0.8
    makes the block-Jacobi V-cycle near-indefinite on hex elasticity.

    The transfer matrices and colour masks are built here, once per
    hierarchy, so a V-cycle issues device work only."""
    n_levels = len(levels)
    mvs = [stencil_matvec_soa if mv_for is None else mv_for(lv) for lv in levels]
    coarse_inv = (
        torch.linalg.inv(_dense_from_soa(levels[-1].A_soa)) if coarse_direct else None
    )
    if transfer_order is None:
        # cubic on semicoarsened pancakes, linear on cubes
        transfer_order = 3 if levels[0].line_dim >= 0 else 1
    mats = [
        transfer_matrices(
            fine.A_soa.shape[-3:], coarse.A_soa.shape[-3:], transfer_order,
            fine.A_soa.dtype, fine.A_soa.device,
        )
        for fine, coarse in zip(levels[:-1], levels[1:])
    ]
    rbs = [
        (_rb_mask(lv, 0), _rb_mask(lv, 1)) if lv.line_dim >= 0 else None
        for lv in levels
    ]

    def vcycle(l: int, r: torch.Tensor) -> torch.Tensor:
        level = levels[l]
        if l == n_levels - 1:
            if coarse_inv is not None:
                z = coarse_inv @ r.permute(1, 2, 3, 0).reshape(-1)
                return z.reshape(r.shape[1:] + (3,)).permute(3, 0, 1, 2).contiguous()
            return _smooth(level, torch.zeros_like(r), r, coarse_sweeps, omega,
                           mvs[l], rb=rbs[l])
        x = _smooth(level, torch.zeros_like(r), r, nu, omega, mvs[l], rb=rbs[l])
        res = r - mvs[l](level.A_soa, x)
        rc = _restrict_with(res, mats[l])
        # coarse Dirichlet rows carry no error
        rc = rc.masked_fill(levels[l + 1].bc_mask, 0.0)
        ec = vcycle(l + 1, rc)
        corr = _prolong_with(ec, mats[l])
        x = x + corr.masked_fill(level.bc_mask, 0.0)
        return _smooth(level, x, r, nu, omega, mvs[l], reverse=True, rb=rbs[l])

    return lambda r: vcycle(0, r)
