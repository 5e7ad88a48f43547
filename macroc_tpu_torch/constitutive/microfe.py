"""Batched micro-FE homogenization — the FE² constitutive engine (torch form
of ``macroc_tpu/constitutive/microfe.py``).

At every macro Gauss point the constitutive response comes from a
finite-element solve on a micro RVE (n x n x n hex elements, two materials
arranged by ``micro_type`` geometry), homogenized under linear-displacement
boundary conditions:

    u_micro = eps_macro . x   on the RVE boundary
    sigma_macro = (1/V) \\int sigma_micro dV
    C_macro     = d sigma_macro / d eps_macro   (6 linear sensitivity solves)

The GP population is streamed through in chunks; inside a chunk every
micro Newton iteration, radial return, assembly and CG iteration runs for
all of the chunk's RVEs at once, as a leading batch dimension (the JAX
package's ``vmap``).  Batched loops keep ``vmap``-of-``while_loop``
semantics: the loop runs while any member runs, and a member that has
stopped keeps its carry frozen.  Every loop-exit test is one host sync,
counted in ``MicroFEEngine.syncs``.

Internal state per macro GP (committed only by update_vars), stored FLAT
as in the JAX package, so state carries across between the packages:
  eps_p n^3*8*6, alpha n^3*8 — micro plastic internal vars
  u     (n+1)^3*3            — micro displacement (warm start)
Structured views of that storage are free reshapes here.

Not ported: ``_key``/``__hash__``/``__eq__``, which exist for the JAX
package's jit-cache identity, and its TPU tile-padding and remat
workarounds (flat carries across loop boundaries, the flat-only stored
operator, the flattened screen fields; ``microfe.py:110-118, 391-403,
436-440, 696-702``).  The port keeps the flat 243-minor operator layout
because the flat matvec and elimination are written for it, not for
padding reasons.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from macroc_tpu_torch.config import (
    MIC_CILI_FIB_XZ,
    MIC_CILI_FIB_Z,
    MIC_HOMOGENEOUS,
    MIC_LAYER_Y,
    MIC_QUAD_FIB_XYZ,
    MIC_QUAD_FIB_XZ,
    MIC_QUAD_FIB_XZ_BROKEN_X,
    MIC_SPHERE,
    MaterialParams,
)
from macroc_tpu_torch.bc import BCData, apply_bc_stencil_flat
from macroc_tpu_torch.constitutive.base import HomogenizeResult
from macroc_tpu_torch.constitutive.elastic import elastic_matrix
from macroc_tpu_torch.constitutive.j2 import j2_radial_return
from macroc_tpu_torch.fem.element import NODE_OFFSETS, b_matrix
from macroc_tpu_torch.fem.kernels import (
    assemble_residual,
    assemble_stencil_flat,
    compute_strains,
)
from macroc_tpu_torch.ops.stencil import stencil_matvec_flat
from macroc_tpu_torch.solve.cg import cg_solve_batched
from macroc_tpu_torch.solve.precond import jacobi_precond_flat


def material2_mask(n: int, micro_type: int, params) -> np.ndarray:
    """(n,n,n) bool: True where the micro element belongs to material 2.
    Geometry tested at element centers of the unit-size RVE (params[0:3] =
    box dims, params[3] = width/radius fraction; reference defaults
    {1,1,1,0.5}, src/init.c:212)."""
    lx, ly, lz, w = (list(params) + [0.5] * 4)[:4]
    c = (np.arange(n) + 0.5) / n
    X, Y, Z = np.meshgrid(c * lx, c * ly, c * lz, indexing="ij")
    cx, cy, cz = lx / 2, ly / 2, lz / 2
    if micro_type == MIC_HOMOGENEOUS:
        return np.zeros((n, n, n), bool)
    if micro_type == MIC_SPHERE:
        r = w * min(lx, ly, lz) / 2
        return (X - cx) ** 2 + (Y - cy) ** 2 + (Z - cz) ** 2 < r * r
    if micro_type == MIC_LAYER_Y:
        return Y < w * ly
    if micro_type == MIC_CILI_FIB_Z:
        r = w * min(lx, ly) / 2
        return (X - cx) ** 2 + (Y - cy) ** 2 < r * r
    if micro_type == MIC_CILI_FIB_XZ:
        r = w * min(lx, ly) / 4
        fib_z = (X - cx) ** 2 + (Y - cy) ** 2 < r * r
        fib_x = (Z - cz) ** 2 + (Y - cy) ** 2 < r * r
        return fib_z | fib_x
    if micro_type in (MIC_QUAD_FIB_XYZ, MIC_QUAD_FIB_XZ,
                      MIC_QUAD_FIB_XZ_BROKEN_X):
        hw = w / 4
        fib_z = (np.abs(X - cx) < hw * lx) & (np.abs(Y - cy) < hw * ly)
        fib_x = (np.abs(Z - cz) < hw * lz) & (np.abs(Y - cy) < hw * ly)
        fib_y = (np.abs(X - cx) < hw * lx) & (np.abs(Z - cz) < hw * lz)
        if micro_type == MIC_QUAD_FIB_XYZ:
            return fib_z | fib_x | fib_y
        if micro_type == MIC_QUAD_FIB_XZ:
            return fib_z | fib_x
        # broken-x: x-fiber interrupted in the middle third
        broken = fib_x & ~(np.abs(X - cx) < lx / 6)
        return fib_z | broken
    raise ValueError(f"unknown micro_type {micro_type}")


@dataclasses.dataclass(frozen=True)
class MicroState:
    """Micro internal variables, stored flat per macro GP."""

    eps_p: torch.Tensor  # (..., n*n*n*8*6)
    alpha: torch.Tensor  # (..., n*n*n*8)
    u: torch.Tensor      # (..., (n+1)^3*3)


def _flat(a: torch.Tensor) -> torch.Tensor:
    """(..., m, m, m, 3) -> (..., m^3*3)."""
    return a.reshape(a.shape[:-4] + (-1,))


def _gp_sum(a: torch.Tensor) -> torch.Tensor:
    """Sum over the (n, n, n, 8) micro GPs of a (g, n, n, n, 8, ...) batch."""
    return a.sum(dim=(1, 2, 3, 4))


class MicroFEEngine:
    #: the homogenized tangent's columns are CG solves to a tolerance, so
    #: it is symmetric only to that tolerance
    symmetric_tangent = False

    def __init__(
        self,
        n: int,
        micro_type: int,
        mat1: MaterialParams,
        mat2: MaterialParams,
        params: Tuple[float, ...] = (1.0, 1.0, 1.0, 0.5),
        dtype: torch.dtype = torch.float32,
        device="cpu",
        newton_its: int = 5,
        newton_rtol: float = 1.0e-6,
        cg_rtol: float = 1.0e-8,
        cg_maxits: int = 300,
        tangent_cg_rtol: float = 1.0e-6,
        gp_chunk: int = 0,
        elastic_fastpath: bool = True,
        precond: str = "auto",
        active_chunk: int = 0,
        screen_chunk: int = 0,
    ):
        self.n = n
        self.micro_type = micro_type
        self.mat1, self.mat2 = mat1, mat2
        self.params = tuple(params)
        self.dtype = dtype
        self.device = torch.device(device)
        # micro Newton: iterate until |b| <= newton_rtol * |b_0| (masked
        # residual), capped at newton_its solves; RVEs still above
        # tolerance at the cap are flagged in HomogenizeResult.unconverged
        self.newton_its = newton_its
        self.newton_rtol = newton_rtol
        self.cg_rtol = cg_rtol
        self.cg_maxits = cg_maxits
        # the tangent-column solves may run looser than the equilibrium
        # solves: tangent error only perturbs the macro Newton direction
        self.tangent_cg_rtol = tangent_cg_rtol
        # RVEs solved together per chunk (0 = auto: 128 at production RVE
        # sizes, 256 for small RVEs) — the JAX package's partition, kept so
        # that batch compositions match
        self.gp_chunk = gp_chunk if gp_chunk else (128 if n >= 8 else 256)
        # GPs whose strain increment stays elastic w.r.t. their committed
        # internal vars skip the Newton + 6 tangent solves (superposition
        # from the committed equilibrium u); only GPs failing that screen
        # run the full solve, compacted into waves of ``active_chunk``
        self.elastic_fastpath = elastic_fastpath
        self.screen_chunk = screen_chunk  # 0 = auto: gp_chunk
        self.active_chunk = active_chunk  # 0 = auto: gp_chunk
        # micro CG preconditioner: "jacobi" (point diagonal of the current
        # operator) or "dense_elastic" (ONE dense inverse of the pristine
        # elastic RVE operator, shared by every GP and every solve; its
        # application is a (g, N) @ (N, N) matrix product); "auto" = dense
        # while N = 3(n+1)^3 <= 4500 (up to the production micro_n=10)
        if precond == "auto":
            precond = "dense_elastic" if 3 * (n + 1) ** 3 <= 4500 else "jacobi"
        if precond not in ("jacobi", "dense_elastic"):
            raise ValueError(f"unknown micro precond '{precond}'")
        self.precond = precond
        # host syncs of the batched loops' exit tests, cumulative
        self.syncs = [0]

        dev = dict(dtype=dtype, device=self.device)
        lx, ly, lz = self.params[0], self.params[1], self.params[2]
        self.spacing = (lx / n, ly / n, lz / n)
        self.volume = lx * ly * lz
        self.wg = self.spacing[0] * self.spacing[1] * self.spacing[2] / 8.0
        self.mshape = (n + 1, n + 1, n + 1)  # micro node grid
        self.B = torch.as_tensor(b_matrix(self.spacing), **dev)

        m2 = material2_mask(n, micro_type, self.params)[..., None]  # +gp axis

        def field(a, b):
            return torch.as_tensor(np.where(m2, b, a), **dev)

        self.lam = field(mat1.lam, mat2.lam)  # (n,n,n,1)
        self.mu = field(mat1.mu, mat2.mu)
        self.Sy = field(mat1.Sy, mat2.Sy)
        self.Ka = field(mat1.Ka, mat2.Ka)

        # boundary node mask of the RVE (linear-displacement BC)
        bnd = np.zeros(self.mshape + (3,), bool)
        bnd[0], bnd[-1] = True, True
        bnd[:, 0], bnd[:, -1] = True, True
        bnd[:, :, 0], bnd[:, :, -1] = True, True
        self.bnd_mask = torch.as_tensor(bnd, device=self.device)
        self._bnd_flat = self.bnd_mask.reshape(-1)
        self._bc = BCData(mask=self.bnd_mask,
                          val_unit=torch.zeros(self.mshape + (3,), **dev))
        # node coordinates for the affine BC values
        g = [np.arange(n + 1) * h for h in self.spacing]
        coords_np = np.stack(np.meshgrid(*g, indexing="ij"), axis=-1)
        self.coords = torch.as_tensor(coords_np, **dev)  # (m,m,m,3)
        # flat affine fields of the 6 unit strains (6, m^3*3), a constant
        # for the tangent and basis solves
        unit_aff = []
        for j in range(6):
            e = np.zeros(6)
            e[j] = 1.0
            E = np.array([[e[0], e[3] / 2, e[4] / 2],
                          [e[3] / 2, e[1], e[5] / 2],
                          [e[4] / 2, e[5] / 2, e[2]]])
            unit_aff.append(np.einsum("ij,xyzj->xyzi", E, coords_np).ravel())
        self.unit_affine = torch.as_tensor(np.stack(unit_aff), **dev)
        # corner-node flat indices for recovering the committed macro strain
        # from a stored micro displacement (see _eps_from_u): the three
        # single-axis corners (L,0,0)/(0,L,0)/(0,0,L) read off E's columns
        mm = n + 1
        corners = [((mm - 1) * mm + 0) * mm + 0,
                   (0 * mm + (mm - 1)) * mm + 0,
                   (0 * mm + 0) * mm + (mm - 1)]
        self._corner_idx = torch.as_tensor(
            [c * 3 + d for c in corners for d in range(3)], device=self.device
        )
        self._corner_len = torch.as_tensor([lx, ly, lz], **dev)
        self._dense_inv = None
        self._dense_inv_t = None
        self._basis = None

    # ------------------------------------------------------------------ #
    def _elastic_dense_inv(self) -> np.ndarray:
        """Shared dense inverse of the pristine ELASTIC RVE operator
        (Dirichlet-eliminated), the CG preconditioner of every micro solve
        (precond="dense_elastic").  Built once per engine on the host in
        float64, independent of the tensor assembly path: per-element
        B^T C B with the two-phase elastic matrix, symmetric row/col
        elimination, LAPACK inverse, symmetrized.  N = 3(n+1)^3."""
        if self._dense_inv is not None:
            return self._dense_inv
        n, m = self.n, self.n + 1
        C1 = elastic_matrix(self.mat1)
        C2 = elastic_matrix(self.mat2)
        m2 = material2_mask(n, self.micro_type, self.params)
        B = b_matrix(self.spacing)  # (8,6,8,3) float64
        Ke = {
            phase: np.einsum("gvnd,vw,gwme->ndme", B, C, B).reshape(24, 24)
            * self.wg
            for phase, C in (("m1", C1), ("m2", C2))
        }
        N = m * m * m * 3
        A = np.zeros((N, N))
        nid = lambda i, j, k: (i * m + j) * m + k
        for ei in range(n):
            for ej in range(n):
                for ek in range(n):
                    K = Ke["m2"] if m2[ei, ej, ek] else Ke["m1"]
                    ix = np.array([
                        nid(ei + o[0], ej + o[1], ek + o[2]) * 3 + d
                        for o in NODE_OFFSETS
                        for d in range(3)
                    ])
                    A[np.ix_(ix, ix)] += K
        bnd = self._bnd_flat.cpu().numpy()
        A[bnd, :] = 0.0
        A[:, bnd] = 0.0
        A[bnd, bnd] = 1.0
        Minv = np.linalg.inv(A)
        Minv = (Minv + Minv.T) / 2.0
        self._dense_inv = Minv.astype(
            np.float32 if self.dtype == torch.float32 else np.float64
        )
        return self._dense_inv

    def _make_precond(self, Af):
        """CG preconditioner apply on flat (g, N) batches for the operator
        Af (flat layout, batched like the vectors or shared)."""
        if self.precond == "dense_elastic":
            if self._dense_inv_t is None:
                self._dense_inv_t = torch.as_tensor(
                    self._elastic_dense_inv(), device=self.device
                )
            Minv = self._dense_inv_t
            # Minv is symmetric: r @ Minv is Minv @ r for every member
            return lambda r: r @ Minv
        applyS = jacobi_precond_flat(Af)
        return lambda r: _flat(applyS(self._structured(r)))

    def _structured(self, v: torch.Tensor) -> torch.Tensor:
        """Flat (g, m^3*3) -> (g, m, m, m, 3)."""
        return v.reshape(v.shape[:1] + self.mshape + (3,))

    def _matvec(self, Af):
        return lambda v: _flat(stencil_matvec_flat(Af, self._structured(v)))

    # ------------------------------------------------------------------ #
    def init_state(self, batch_shape: Tuple[int, ...]) -> MicroState:
        n, m = self.n, self.n + 1
        dev = dict(dtype=self.dtype, device=self.device)
        return MicroState(
            eps_p=torch.zeros(batch_shape + (n * n * n * 8 * 6,), **dev),
            alpha=torch.zeros(batch_shape + (n * n * n * 8,), **dev),
            u=torch.zeros(batch_shape + (m * m * m * 3,), **dev),
        )

    def _unflat_state(self, eps_p, alpha):
        """Flat (g, ...) storage -> structured views (free reshapes)."""
        n = self.n
        return (eps_p.reshape(eps_p.shape[:1] + (n, n, n, 8, 6)),
                alpha.reshape(alpha.shape[:1] + (n, n, n, 8)))

    # ------------------------------------------------------------------ #
    def _affine_u(self, eps6):
        """Linear-displacement fields u_i = eps_ij x_j (g, m, m, m, 3) from
        Voigt engineering strains eps6 (g, 6) (off-diagonal tensor strain =
        gamma/2)."""
        e = eps6.unbind(-1)
        E = torch.stack([
            torch.stack([e[0], e[3] / 2, e[4] / 2], dim=-1),
            torch.stack([e[3] / 2, e[1], e[5] / 2], dim=-1),
            torch.stack([e[4] / 2, e[5] / 2, e[2]], dim=-1),
        ], dim=-2)
        return torch.einsum("gij,xyzj->gxyzi", E, self.coords)

    def _assemble_flat(self, ctan):
        """Dirichlet-eliminated micro operator in flat block layout
        (..., m, m, m, 243) from per-GP tangents (..., n, n, n, 8, 6, 6).
        Only the eliminated form is stored: the raw-operator action the
        tangent right-hand sides need runs matrix-free (_raw_action)."""
        Af = assemble_stencil_flat(ctan, self.B, self.wg, self.mshape)
        return apply_bc_stencil_flat(Af, self._bc)

    def _raw_action(self, ctan_gp, w_flat):
        """y = A_raw w, matrix-free: strain of w -> ctan contraction ->
        residual assembly.  w_flat (N,) or (g, N); ctan_gp batched or
        shared; returns (g, N)."""
        w = w_flat.reshape(w_flat.shape[:-1] + self.mshape + (3,))
        eps_w = compute_strains(w, self.B)
        sig = torch.einsum("...vw,...w->...v", ctan_gp, eps_w)
        return _flat(assemble_residual(sig, self.B, self.wg, self.mshape))

    def _masked_neg(self, f_flat):
        """-f with the Dirichlet (boundary) entries zeroed."""
        return -f_flat.masked_fill(self._bnd_flat, 0.0)

    def _micro_solve(self, eps6, eps_p_flat, alpha_flat, u0_flat):
        """Solve a batch of g RVEs to equilibrium at macro strains eps6
        (g, 6) from committed internal vars (NOT mutated), then form each
        consistent macro tangent by 6 linear sensitivity solves against the
        converged operator.  State in and out is flat.  Returns (sigma_hom
        (g,6), ctan (g,6,6), eps_p, alpha, u, non_linear, f_trial max, cost
        (micro CG iterations), unconverged)."""
        g = eps6.shape[0]
        eps_p, alpha = self._unflat_state(eps_p_flat, alpha_flat)
        bnd = self._bnd_flat
        mat = (self.lam, self.mu, self.Sy, self.Ka)

        def lin(u_flat):
            eps_gp = compute_strains(self._structured(u_flat), self.B)
            return j2_radial_return(eps_gp, eps_p, alpha, *mat)

        def residual(stress):
            f = assemble_residual(stress, self.B, self.wg, self.mshape)
            return self._masked_neg(_flat(f))

        u = torch.where(bnd, _flat(self._affine_u(eps6)), u0_flat)
        it = torch.zeros(g, dtype=torch.int32, device=self.device)
        norm0 = torch.zeros(g, dtype=self.dtype, device=self.device)
        done = torch.zeros(g, dtype=torch.bool, device=self.device)
        cg_its = torch.zeros(g, dtype=torch.int32, device=self.device)
        while True:
            active = ~done & (it < self.newton_its)
            self.syncs[0] += 1
            if not bool(active.any()):
                break
            stress, ctan, *_ = lin(u)
            b = residual(stress)
            del stress
            norm = torch.sqrt(torch.sum(b * b, dim=1))
            norm0_it = torch.where(it == 0, norm, norm0)
            done_it = norm <= self.newton_rtol * norm0_it
            Af = self._assemble_flat(ctan)
            del ctan
            res = cg_solve_batched(
                self._matvec(Af), b, self._make_precond(Af),
                rtol=self.cg_rtol, maxits=self.cg_maxits, syncs=self.syncs,
            )
            del Af, b
            step = active & ~done_it
            u = torch.where(step[:, None], u + res.x, u)
            cg_its = cg_its + torch.where(step, res.its, 0)
            norm0 = torch.where(active, norm0_it, norm0)
            done = torch.where(active, done_it, done)
            it = it + active.to(torch.int32)

        stress, ctan_gp, eps_p_new, alpha_new, f_trial, plastic = lin(u)
        # hit the cap with the loop's last residual check still failing?
        b_fin = residual(stress)
        unconverged = torch.sqrt(torch.sum(b_fin * b_fin, dim=1)) > (
            self.newton_rtol * norm0
        )
        del b_fin
        sigma_hom = _gp_sum(stress * self.wg) / self.volume
        del stress

        # --- consistent tangent: 6 linear sensitivity solves -----------
        # Column j: du solves the linearized RVE with Dirichlet data
        # du = (unit strain e_j) . x on the boundary; by the virtual-work
        # identity d sigma_hom[v] = Q[v] . du / V with
        # Q[v] = assemble_residual(ctan[..., v, :]).
        Af_el = self._assemble_flat(ctan_gp)
        mv, Mj = self._matvec(Af_el), self._make_precond(Af_el)
        Q = torch.stack([
            _flat(assemble_residual(ctan_gp[..., v, :], self.B, self.wg,
                                    self.mshape))
            for v in range(6)
        ], dim=1)  # (g, 6, N)
        cols, its6 = [], torch.zeros_like(cg_its)
        # in sequence over the 6 unit strains, as the JAX package
        for j in range(6):
            wb = torch.where(bnd, self.unit_affine[j], 0.0)
            rhs = self._masked_neg(self._raw_action(ctan_gp, wb))
            res = cg_solve_batched(
                mv, rhs, Mj, rtol=self.tangent_cg_rtol, maxits=self.cg_maxits,
                syncs=self.syncs,
            )
            cols.append(torch.bmm(Q, (wb + res.x)[:, :, None])[..., 0] / self.volume)
            its6 = its6 + res.its
        ctan_hom = torch.stack(cols, dim=-1)  # ctan[i,j] = d sigma_i / d eps_j

        return (
            sigma_hom,
            ctan_hom,
            eps_p_new.reshape(g, -1),
            alpha_new.reshape(g, -1),
            u,
            plastic.reshape(g, -1).any(dim=1),
            f_trial.reshape(g, -1).amax(dim=1),
            (cg_its + its6).to(torch.int32),
            unconverged,
        )

    # ------------------------------------------------------------------ #
    def _elastic_basis(self):
        """Unit-strain elastic RVE solutions, all flat: (U (6, m^3*3)
        displacement fields, E (6, n^3*8*6) their micro strains, C_hom
        (6,6)).  By superposition the pristine-state response to any macro
        strain is u = eps_j U_j.  Six CG solves on one RVE, once per engine
        (the JAX package hoists them out of the step)."""
        if self._basis is not None:
            return self._basis
        n = self.n
        z = dict(dtype=self.dtype, device=self.device)
        zero6 = torch.zeros((n, n, n, 8, 6), **z)
        zero1 = torch.zeros((n, n, n, 8), **z)
        _, ctan_gp, *_ = j2_radial_return(
            zero6, zero6, zero1, self.lam, self.mu, self.Sy, self.Ka
        )
        Af_el = self._assemble_flat(ctan_gp)
        # with precond="dense_elastic" this operator IS the preconditioner:
        # CG converges in O(1) iterations
        wb = torch.where(self._bnd_flat, self.unit_affine, 0.0)  # (6, N)
        rhs = self._masked_neg(self._raw_action(ctan_gp, wb))
        res = cg_solve_batched(
            self._matvec(Af_el), rhs, self._make_precond(Af_el),
            rtol=self.cg_rtol, maxits=self.cg_maxits, syncs=self.syncs,
        )
        U = wb + res.x
        eps_gp = compute_strains(self._structured(U), self.B)
        sig = torch.einsum("...vw,...w->...v", ctan_gp, eps_gp)
        cols = _gp_sum(sig * self.wg) / self.volume  # (6 j, 6 i)
        self._basis = (U, eps_gp.reshape(6, -1), cols.T.contiguous())
        return self._basis

    def _eps_from_u(self, u_flat):
        """Committed macro strains (Voigt engineering, (g, 6)) recovered
        from stored micro displacements' boundaries: every equilibrium u
        carries the affine field E.x on the RVE boundary, so E's columns
        are read off the three single-axis corner nodes."""
        v = u_flat[:, self._corner_idx].reshape(-1, 3, 3)
        Ec = v / self._corner_len[:, None]  # Ec[r, d] = E[d, r]
        return torch.stack([
            Ec[:, 0, 0], Ec[:, 1, 1], Ec[:, 2, 2],
            Ec[:, 1, 0] + Ec[:, 0, 1],   # 2 E_xy
            Ec[:, 2, 0] + Ec[:, 0, 2],   # 2 E_xz
            Ec[:, 2, 1] + Ec[:, 1, 2],   # 2 E_yz
        ], dim=-1)

    def _screen_chunk(self, basis, eps_c, eps_p_c, alpha_c, u_c, pristine):
        """Elastic-incremental SCREEN for one GP chunk: candidate
        u = committed u + superposed elastic increment (eps - eps_prev).U.
        A radial return of the candidate strain field against the COMMITTED
        internal vars decides per GP: if no micro GP goes plastic the
        candidate is the exact equilibrium, its stress field is exact and
        the consistent tangent is the pristine elastic C_hom.

        ``pristine`` (every internal var of the chunk is zero, decided by
        the caller for all chunks at once) takes the pure-superposition
        branch u = eps.U, as the JAX package's ``lax.cond`` does.  Returns
        the screen's outputs plus the per-GP ``active`` flag; active GPs
        carry placeholder values, overwritten by `_solve_compacted`."""
        U, E, C_hom = basis
        g, n = eps_c.shape[0], self.n
        mat = (self.lam, self.mu, self.Sy, self.Ka)
        if pristine:
            eps_gp = (eps_c @ E).reshape(g, n, n, n, 8, 6)
            zero = eps_gp.new_zeros(())
            stress, _, _, _, f_trial, plastic = j2_radial_return(
                eps_gp, zero, zero, *mat, tangent=False
            )
            u_new = eps_c @ U
        else:
            eps_p_v, alpha_v = self._unflat_state(eps_p_c, alpha_c)
            deps = eps_c - self._eps_from_u(u_c)
            eps_comm = compute_strains(self._structured(u_c), self.B)
            eps_gp = eps_comm + (deps @ E).reshape(eps_comm.shape)
            stress, _, _, _, f_trial, plastic = j2_radial_return(
                eps_gp, eps_p_v, alpha_v, *mat, tangent=False
            )
            u_new = u_c + deps @ U
        z = dict(device=self.device)
        return (
            _gp_sum(stress * self.wg) / self.volume,
            C_hom.expand(g, 6, 6),
            u_new,
            torch.zeros(g, dtype=torch.bool, **z),
            f_trial.reshape(g, -1).amax(dim=1),
            torch.zeros(g, dtype=torch.int32, **z),
            torch.zeros(g, dtype=torch.bool, **z),
            plastic.reshape(g, -1).any(dim=1),
        )

    def _solve_compacted(self, out, active, eps_f, eps_p_f, alpha_f, u_f):
        """GLOBAL active-set compaction: the population's indices sorted
        active-first (stable); the full batched RVE solve runs on waves of
        ``active_chunk or gp_chunk`` gathered GPs until the active ones are
        covered, scattering results over the screen's.  The last wave's
        start is clamped to fit, as ``dynamic_slice_in_dim`` clamps it, so
        it re-solves a few already covered GPs to the same answer.
        ``out[2]`` and ``out[3]`` alias the committed eps_p and alpha; they
        are copied before the first scatter."""
        flat = eps_f.shape[0]
        s = min(self.active_chunk or self.gp_chunk, flat)
        order = torch.argsort((~active).to(torch.uint8), stable=True)
        self.syncs[0] += 1
        n_active = int(active.sum())
        out = list(out)
        if n_active:
            out[2], out[3] = out[2].clone(), out[3].clone()
        i = 0
        while i * s < n_active:
            start = min(i * s, flat - s)
            idx = order[start:start + s]
            sub = self._micro_solve(eps_f[idx], eps_p_f[idx], alpha_f[idx],
                                    u_f[idx])
            for a, b in zip(out, sub):
                a[idx] = b
            i += 1
        return out

    # ------------------------------------------------------------------ #
    def homogenize(self, eps: torch.Tensor, state: MicroState) -> HomogenizeResult:
        """Every macro GP's RVE solve (plus its 6 tangent solves), streamed
        through in chunks with the JAX package's partition.  Each solve
        starts from the SAME committed internal vars: homogenize never
        mutates state."""
        batch = tuple(eps.shape[:-1])
        flat = int(np.prod(batch)) if batch else 1
        eps_f = eps.reshape(flat, 6)
        eps_p_f = state.eps_p.reshape(flat, -1)
        alpha_f = state.alpha.reshape(flat, -1)
        u_f = state.u.reshape(flat, -1)

        chunk = (self.screen_chunk or self.gp_chunk) if self.elastic_fastpath \
            else self.gp_chunk
        if flat <= chunk:
            bounds = [(0, flat)]
        else:
            # the chunk drops to the largest divisor of the population
            # within 2x so no tail exists; a ragged tail (pathological sizes
            # only) runs as one extra chunk
            d = max((k for k in range(chunk, chunk // 2, -1) if flat % k == 0),
                    default=chunk)
            n_main = flat // d
            bounds = [(i * d, (i + 1) * d) for i in range(n_main)]
            if flat > n_main * d:
                bounds.append((n_main * d, flat))

        if self.elastic_fastpath:
            basis = self._elastic_basis()
            # each chunk's branch, decided for all chunks with one host read
            # (max and min both 0, without a temporary the state's size)
            pristine_gp = torch.ones(flat, dtype=torch.bool, device=self.device)
            for a in (eps_p_f, alpha_f):
                pristine_gp &= (a.amax(dim=1) == 0) & (a.amin(dim=1) == 0)
            self.syncs[0] += 1
            pristine = torch.stack(
                [pristine_gp[a:b].all() for a, b in bounds]
            ).tolist()

            def run(k, a, b):
                return self._screen_chunk(basis, eps_f[a:b], eps_p_f[a:b],
                                          alpha_f[a:b], u_f[a:b], pristine[k])
        else:
            def run(k, a, b):
                return self._micro_solve(eps_f[a:b], eps_p_f[a:b],
                                         alpha_f[a:b], u_f[a:b])

        out = None
        for k, (a, b) in enumerate(bounds):
            part = run(k, a, b)
            if out is None:
                out = [torch.empty((flat,) + t.shape[1:], dtype=t.dtype,
                                   device=t.device) for t in part]
            for o, t in zip(out, part):
                o[a:b] = t
            del part

        if self.elastic_fastpath:
            # committed eps_p/alpha are aliased (the screen cannot change
            # them), then the active set is solved in full-width waves
            sigma_s, ctan_s, u_s, nl_s, ft_s, cost_s, unc_s, active = out
            out = self._solve_compacted(
                (sigma_s, ctan_s, eps_p_f, alpha_f, u_s, nl_s, ft_s, cost_s,
                 unc_s),
                active, eps_f, eps_p_f, alpha_f, u_f,
            )
        sigma, ctan, eps_p_n, alpha_n, u_n, nl, f_tr, cost, unconv = out

        def unflat(a):
            return a.reshape(batch + a.shape[1:])

        return HomogenizeResult(
            stress=unflat(sigma),
            ctan=unflat(ctan),
            trial_state=MicroState(
                eps_p=unflat(eps_p_n), alpha=unflat(alpha_n), u=unflat(u_n)
            ),
            non_linear=unflat(nl),
            f_trial=unflat(f_tr),
            cost=unflat(cost.to(self.dtype)),
            unconverged=unflat(unconv),
        )
