"""MacroProblem — the Newton/time-step core on one device (torch form of
``macroc_tpu/problem.py``).

Per time step: ramp the Dirichlet load, then the Newton loop (strains ->
constitutive homogenize -> residual -> convergence test -> stencil assembly
-> Dirichlet elimination -> CG or GMRES -> update), then commit the
constitutive state.  The reference's ``lax.while_loop``/``lax.cond`` become a Python
loop with one host read of |RES| per Newton iteration.

Semantics kept exactly (macroc_tpu/problem.py:13-22):
  - convergence is tested BEFORE the first solve; a converged step performs
    1 homogenize + 1 residual and 0 solves;
  - norm_0 is captured at iteration 0 of each time step;
  - newton_max_its bounds the number of solves;
  - the committed state is the trial state of the LAST homogenize, even
    when the loop exits by iteration count after a final solve updated u;
  - residual b = -(internal force with Dirichlet rows zeroed), u += du;
  - micro RVE solves that hit the micro Newton cap are counted over the
    real elements (``micro_unconverged``).

GP arrays (state, stress, flags) are stored at node shape + (8,): the
trailing slot per dim is an inactive element that always sees zero strain,
the layout of the JAX package, so its state carries across unchanged.

Under a process group of N ranks (``parallel/distributed.py``) the grid is
decomposed as DMDA would (``make_grid(cfg, N)``), the node box is padded to
multiples of the rank grid (pads Dirichlet-0, padded elements inactive) and
each rank holds its block of u, the state and the GP fields
(``parallel/mesh.py``): strains from the halo-exchanged u, a per-rank
homogenize (J2, or micro-FE on the rank's own MicroState), the residual
folded back onto its owners, K2 per rank with its extra plane folded on, K1
on the exchanged x, the matrix-free operator in the residual's pattern, and
all-reduced dots, norms and diagnostics (``macroc_tpu/problem.py:160-309,
399-413``).  MG keeps level 0 on the ranks' blocks and runs the coarse
levels of the padded box whole on every rank (``solve/mg.py``).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from macroc_tpu_torch.config import MacroConfig
from macroc_tpu_torch.grid import StructuredGrid3D, make_grid
from macroc_tpu_torch import bc as bc_mod
from macroc_tpu_torch.constitutive import J2State, make_engine
from macroc_tpu_torch.constitutive.microfe import MicroState
from macroc_tpu_torch.fem.element import b_for
from macroc_tpu_torch.fem.kernels import (
    assemble_diagonal,
    assemble_residual,
    compute_strains,
    matfree_matvec,
)
from macroc_tpu_torch.forces import calc_force, per_rank_nonlinear_counts_device
from macroc_tpu_torch.ops.assembly import (
    assemble_stencil_slab,
    assemble_stencil_soa_kernel,
    b_dsh,
)
from macroc_tpu_torch.ops.stencil_spmv import (
    StencilOperator,
    stencil_matvec,
    stencil_matvec_soa,
    x_from_soa,
    x_to_soa,
)
from macroc_tpu_torch.parallel.distributed import Comm
from macroc_tpu_torch.parallel.halo import (
    assemble_stencil_local,
    halo_exchange,
    halo_fold_add,
    stencil_matvec_local,
)
from macroc_tpu_torch.parallel.mesh import RankMesh
from macroc_tpu_torch.solve.cg import cg_solve
from macroc_tpu_torch.solve.gmres import gmres_solve
from macroc_tpu_torch.solve.mg import build_hierarchy, make_mg_preconditioner
from macroc_tpu_torch.solve.precond import (
    block_jacobi_precond_soa,
    identity_precond,
    jacobi_precond_soa,
)
from macroc_tpu_torch.utils.profiling import no_phase

DTYPES = {"float32": torch.float32, "float64": torch.float64}
#: storage dtypes -mg_dtype accepts for the V-cycle level operators
MG_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, **DTYPES}


@dataclasses.dataclass
class StepDiagnostics:
    """Per-time-step diagnostics; Newton/KSP records are host arrays sized
    by newton_max_its, the per-GP fields device tensors on the real
    element box (on a rank: its block of element slots, the inactive ones
    zero, False and -inf).  Scalars are the global values on every rank."""

    res_norms: np.ndarray     # (max_its+1,) |RES| per Newton iteration (nan-padded)
    ksp_its: np.ndarray       # (max_its,) KSP iteration counts per solve
    ksp_rnorms: np.ndarray    # (max_its,) KSP final residual norms
    ksp_reasons: np.ndarray   # (max_its,) KSPConvergedReason per solve
    n_homogenize: int
    n_solves: int
    converged: bool
    force: float              # reaction-force QoI
    f_trial_max: float
    non_linear: torch.Tensor  # (nex,ney,nez,8) bool
    cost: torch.Tensor        # (nex,ney,nez,8)
    stress: torch.Tensor      # (nex,ney,nez,8,6) committed per-GP stress
    # per-solve monitored residual norms (-ksp_monitor), else None
    ksp_traces: Optional[list] = None
    # micro RVE solves of the step that hit the micro Newton cap (micro-FE)
    micro_unconverged: int = 0


def resolve_solver_plan_torch(cfg: MacroConfig, node_shape, device) -> dict:
    """The solver choices: dict(pc_type, operator, assembly).

    pc_type "auto" keeps the reference rule: MG when a deep hierarchy
    exists along at least two dims (extent >= 17; a thin third dim is
    semicoarsened), Jacobi otherwise, and always Jacobi under the matfree
    operator, which has no assembled stencil to build a hierarchy from.
    On CUDA every stencil operator and every MG level runs kernel K1
    ("stencil_cuda") and every assembly kernel K2 ("cuda"); on the CPU the
    plain versions run ("stencil", "slab").  The matfree operator
    ("matfree") is plain PyTorch on either device, as in the JAX package."""
    matfree = cfg.operator == "matfree"
    pc_type = cfg.pc_type
    if pc_type == "auto":
        deep_dims = sum(n >= 17 for n in node_shape)
        pc_type = "mg" if deep_dims >= 2 and not matfree else "jacobi"
    cuda = torch.device(device).type == "cuda"
    return dict(
        pc_type=pc_type,
        operator="matfree" if matfree else "stencil_cuda" if cuda else "stencil",
        assembly="cuda" if cuda else "slab",
    )


_OPERATORS = {"stencil_cuda": stencil_matvec, "stencil": stencil_matvec_soa}
_ASSEMBLERS = {"cuda": assemble_stencil_soa_kernel, "slab": assemble_stencil_slab}


class MacroProblem:
    """Grid, config, BCs and constitutive engine of this process: the
    whole problem on one process, the rank's block under a process group
    (``self.mesh``)."""

    def __init__(self, cfg: MacroConfig, device, grid: Optional[StructuredGrid3D] = None):
        if cfg.dtype not in DTYPES:
            raise ValueError(f"dtype must be float32 or float64, got {cfg.dtype!r}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.comm = Comm(self.device)
        self.grid = grid or make_grid(cfg, self.comm.world)
        self.dtype = DTYPES[cfg.dtype]
        g = self.grid
        B = torch.as_tensor(b_for(g.spacing, cfg.ref_b_quirk))
        # B's shape derivatives for K2, read (and B's pattern checked) once
        self.dsh = b_dsh(B)
        self.B = B.to(self.dtype).to(self.device)
        self.engine = make_engine(cfg, self.dtype, self.device)
        self.real_shape = (g.nx, g.ny, g.nz)
        self.real_elem_shape = (g.nx - 1, g.ny - 1, g.nz - 1)
        if g.nproc == 1:
            self.mesh = None
            self.node_shape = self.real_shape
            self.origin = (0, 0, 0)
            self.local_shape = self.node_shape
            self.bc = bc_mod.build_bc(g, cfg, self.dtype, self.device)
            self.mask_soa = self.bc.mask.permute(3, 0, 1, 2)
        else:
            self.mesh = RankMesh(g, self.comm)
            self.node_shape = self.mesh.node_shape  # padded to the rank grid
            self.origin = self.mesh.start
            self.local_shape = self.mesh.block
            padded = bc_mod.build_bc_padded(g, cfg, self.node_shape, self.dtype)
            self.bc = bc_mod.bc_block(padded, self.mesh.slices(), self.device)
            # the global padded mask (SoA), which the coarse MG levels sample
            self.mask_soa = padded.mask.permute(3, 0, 1, 2).contiguous().to(self.device)
            active = np.zeros(self.node_shape, dtype=bool)
            active[tuple(slice(0, n) for n in self.real_elem_shape)] = True
            # the rank's element slots that hold real elements
            self.elem_mask = torch.as_tensor(self.mesh.local(active)).contiguous().to(
                self.device)
        self.elem_shape = self.node_shape  # GP storage: one inactive slot per dim
        # a PhaseTimer (utils/profiling.py) to book the step's phases to
        self.timer = None

    def _phase(self, name: str):
        return self.timer.phase(name) if self.timer is not None else no_phase(name)

    def unpad_u(self, u: torch.Tensor) -> torch.Tensor:
        nx, ny, nz = self.real_shape
        return u[:nx, :ny, :nz]

    def init_fields(self):
        """(u, constitutive state) of this process's block — zero
        displacement, fresh internal vars."""
        u = torch.zeros(self.local_shape + (3,), dtype=self.dtype, device=self.device)
        return u, self.engine.init_state(self.local_shape + (8,))

    def _pad_gp(self, arr: torch.Tensor) -> torch.Tensor:
        """Element-kernel output (n-1 dims) -> GP storage layout (node dims)."""
        return F.pad(arr, [0, 0] * (arr.ndim - 3) + [0, 1, 0, 1, 0, 1])

    @staticmethod
    def _crop_gp(arr: torch.Tensor) -> torch.Tensor:
        """GP storage layout -> element-kernel input (n-1 dims)."""
        return arr[:-1, :-1, :-1]

    def _real(self, arr: torch.Tensor, fill=0) -> torch.Tensor:
        """The real elements of a GP field: the cropped view on one process;
        on a rank, its block with the inactive slots set to ``fill``."""
        if self.mesh is None:
            return self._crop_gp(arr)
        m = self.elem_mask.reshape(self.elem_mask.shape + (1,) * (arr.ndim - 3))
        return arr.masked_fill(~m, fill)

    def nonlinear_counts(self, non_linear: torch.Tensor) -> np.ndarray:
        """The gauss_evolution.dat row: non-linear GP counts per DMDA rank
        box, summed over the ranks (a collective under a process group)."""
        counts = per_rank_nonlinear_counts_device(non_linear, self.grid, self.origin)
        return self.comm.sum(counts).cpu().numpy()

    def residual(self, u: torch.Tensor, state: Any):
        """(b, norm, hom): negated, BC-zeroed residual, its L2 norm (a 0-dim
        tensor) and the homogenize result."""
        if self.mesh is not None:
            return self._residual_local(u, state)
        # the inactive trailing element slots get zero strain from the pad,
        # so their state stays pristine
        eps = self._pad_gp(compute_strains(u, self.B))
        with self._phase("homogenize"):
            hom = self.engine.homogenize(eps, state)
        f = assemble_residual(
            self._crop_gp(hom.stress), self.B, self.grid.wg, self.node_shape
        )
        b = -bc_mod.apply_bc_on_res(f, self.bc)
        return b, torch.sqrt(torch.sum(b * b)), hom

    def _residual_local(self, u: torch.Tensor, state: Any):
        """residual() on this rank's block (macroc_tpu/problem.py:256-296):
        strains of the element slots from the halo-exchanged u, a
        homogenize with no communication, the element forces scattered onto
        the block grown by one node per face and folded back onto their
        owners; |RES| from the all-reduced sum of squares."""
        # inactive (grid-padding, trailing) element slots see zero strain,
        # so their state stays pristine
        eps = self._real(self.slot_strains(u))
        with self._phase("homogenize"):
            hom = self.engine.homogenize(eps, state)
        f = self._fold_elements(assemble_residual(
            self._real(hom.stress), self.B, self.grid.wg, self._ext_shape()))
        b = -bc_mod.apply_bc_on_res(f, self.bc)
        return b, torch.sqrt(self.comm.sum(torch.sum(b * b))), hom

    def slot_strains(self, u: torch.Tensor) -> torch.Tensor:
        """Strains (bx,by,bz,8,6) of a rank's element slots from its block
        of u: element slot i has nodes i, i+1, which are elements i+1 of
        the halo-exchanged u (a collective)."""
        bx, by, bz = self.mesh.block
        ue = halo_exchange(u, self.mesh, dims=(0, 1, 2))
        return compute_strains(ue, self.B)[1:1 + bx, 1:1 + by, 1:1 + bz]

    def _ext_shape(self):
        """A rank's node block grown by one node per dim: the nodes its
        element slots touch."""
        return tuple(n + 1 for n in self.mesh.block)

    def _fold_elements(self, f: torch.Tensor) -> torch.Tensor:
        """Node values scattered from a rank's element slots onto local
        nodes 0 .. b (``_ext_shape``) -> its block: padded to -1 .. b, the
        halo planes go back to their owners (a collective)."""
        return halo_fold_add(F.pad(f, (0, 0, 1, 0, 1, 0, 1, 0)), self.mesh, dims=(0, 1, 2))

    def _matfree_local(self, ctan: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """The unassembled operator on a rank's block of x (node layout):
        strains of the slots from the exchanged x, the per-GP tangents
        (inactive slots zero), the element forces folded onto their
        owners."""
        sig = torch.einsum("xyzgvw,xyzgw->xyzgv", ctan, self.slot_strains(x))
        return self._fold_elements(assemble_residual(sig, self.B, self.grid.wg,
                                                     self._ext_shape()))

    def _krylov(self, mv, b: torch.Tensor, M):
        """The configured Krylov method (-ksp_type) on mv, b and M; its
        dots all-reduced over the ranks under a process group."""
        cfg = self.cfg
        common = dict(rtol=cfg.ksp_rtol, abstol=cfg.ksp_abstol, dtol=cfg.ksp_dtol,
                      maxits=cfg.ksp_maxits,
                      allreduce=None if self.mesh is None else self.comm.sum)
        with self._phase("ksp_solve"):
            if cfg.ksp_type == "cg":
                return cg_solve(mv, b, M, record_trace=cfg.ksp_monitor, **common)
            if cfg.ksp_type == "gmres":
                return gmres_solve(
                    mv, b, M, restart=cfg.gmres_restart,
                    record_trace=cfg.ksp_maxits + 1 if cfg.ksp_monitor else 0,
                    **common,
                )
        raise ValueError(f"unknown ksp_type '{cfg.ksp_type}' (cg|gmres)")

    def _matfree_solve(self, ctan: torch.Tensor, b: torch.Tensor, pc_type: str):
        """The matrix-free operator in node layout.  Jacobi and block-Jacobi
        both take the point diagonal with constrained rows set to 1; any
        other pc_type, mg included, runs unpreconditioned, as the JAX
        package does (ROADMAP.md queue 3, R7).  On a rank the operator and
        the diagonal are ``_residual_local``'s pattern: element terms on the
        block's slots, folded back onto their owners."""
        g = self.grid
        with self._phase("precond_setup"):
            if self.mesh is None:
                raw = matfree_matvec(ctan, self.B, g.wg, self.node_shape)
            else:
                raw = partial(self._matfree_local, ctan)
            mv = bc_mod.bc_operator(raw, self.bc)
            if pc_type in ("jacobi", "bjacobi"):
                if self.mesh is None:
                    diag = assemble_diagonal(ctan, self.B, g.wg, self.node_shape)
                else:
                    diag = self._fold_elements(
                        assemble_diagonal(ctan, self.B, g.wg, self._ext_shape()))
                diag = diag.masked_fill(self.bc.mask, 1.0)
                M = lambda r: r / diag
            else:
                M = identity_precond()
        return self._krylov(mv, b, M)

    def linear_solve(self, ctan: torch.Tensor, b: torch.Tensor):
        """Assemble the BC-eliminated operator from per-GP tangents ctan
        (element shape; on a rank its node-shaped block, inactive slots
        zero), or wrap the matrix-free one, and run the Krylov method on it.
        Returns a KSPResult with x in node layout (nx,ny,nz,3), on a rank
        its block."""
        cfg = self.cfg
        plan = resolve_solver_plan_torch(cfg, self.node_shape, self.device)
        if plan["operator"] == "matfree":
            return self._matfree_solve(ctan, b, plan["pc_type"])
        assemble = _ASSEMBLERS[plan["assembly"]]
        with self._phase("assembly"):
            if self.mesh is None:
                A_soa = assemble(ctan, self.B, self.grid.wg, self.node_shape, dsh=self.dsh)
            else:
                A_soa = assemble_stencil_local(ctan, self.B, self.grid.wg, self.mesh,
                                               partial(assemble, dsh=self.dsh))
            A_soa = bc_mod.apply_bc_stencil_soa(A_soa, self.bc)
        if self.mesh is None:
            # cg_solve runs its fused iteration on a StencilOperator
            matvec = StencilOperator(A_soa, _OPERATORS[plan["operator"]],
                                     symmetric=self.engine.symmetric_tangent)
        else:
            matvec = partial(stencil_matvec_local, A_soa, mesh=self.mesh)
        with self._phase("precond_setup"):
            pc_type = plan["pc_type"]
            if pc_type == "jacobi":
                M = jacobi_precond_soa(A_soa)
            elif pc_type == "bjacobi":
                M = block_jacobi_precond_soa(A_soa)
            elif pc_type == "mg":
                # on a rank: level 0 its block, the coarse levels whole on
                # every rank (build_hierarchy's mesh form)
                levels = build_hierarchy(
                    ctan, self.mask_soa, self.grid.spacing, cfg.ref_b_quirk,
                    A0_soa=A_soa, assemble_fn=assemble, mesh=self.mesh,
                )
                mgdt = self._mg_dtype()
                if mgdt != self.dtype:
                    # narrower level operators: the smoother's matvecs read
                    # fewer bytes; line_inv, transfers and vectors keep the
                    # solve dtype (macroc_tpu/problem.py:472-486)
                    levels = [
                        dataclasses.replace(
                            lv, A_soa=lv.A_soa.to(mgdt), inv_diag=lv.inv_diag.to(mgdt)
                        )
                        for lv in levels
                    ]
                M = make_mg_preconditioner(
                    levels,
                    nu=cfg.mg_nu,
                    omega=cfg.mg_omega,
                    coarse_sweeps=cfg.mg_coarse_sweeps,
                    mv_for=lambda level: _OPERATORS[plan["operator"]],
                    coarse_direct=cfg.mg_coarse_direct,
                    transfer_order=cfg.mg_transfer_order or None,
                    dtype=self.dtype,
                    mesh=self.mesh,
                )
            elif pc_type == "none":
                M = identity_precond()
            else:
                raise ValueError(
                    f"unknown pc_type '{cfg.pc_type}' (auto|none|jacobi|bjacobi|mg)"
                )
        res = self._krylov(matvec, x_to_soa(b), M)
        return res._replace(x=x_from_soa(res.x))

    def _mg_dtype(self) -> torch.dtype:
        """The V-cycle level operators' dtype: -mg_dtype, or the solve dtype
        when it is empty (the JAX package's bf16 default applies on a TPU
        only, so no device here turns it on by itself)."""
        name = self.cfg.mg_dtype
        if not name:
            return self.dtype
        if name not in MG_DTYPES:
            raise ValueError(f"unknown mg_dtype {name!r} ({'|'.join(MG_DTYPES)})")
        return MG_DTYPES[name]

    def time_step(self, u: torch.Tensor, state: Any, U: float):
        """One full time step: returns (u, new_state, diagnostics).  U is the
        ramped load factor for this step."""
        cfg = self.cfg
        max_its = cfg.newton_max_its
        u = bc_mod.apply_bc_on_u(U, u, self.bc)
        res_norms = np.full(max_its + 1, np.nan)
        ksp_its = np.zeros(max_its, np.int64)
        ksp_rnorms = np.full(max_its, np.nan)
        ksp_reasons = np.zeros(max_its, np.int64)
        traces = [None] * max_its if cfg.ksp_monitor else None
        # if the loop never runs, update_vars commits the state unchanged
        trial, last = state, None
        it = nhom = unconv = 0
        norm0 = 0.0
        done = False
        while not done and it < max_its:
            # release the previous trial state before the next homogenize
            # (a micro-FE state copy is ~14 GB at the production size); the
            # committed state is the last homogenize's trial either way
            trial = last = None
            with self._phase("residual"):
                b, norm, hom = self.residual(u, state)
                norm = float(norm)
            if hom.unconverged is not None:
                unconv += int(self.comm.sum(self._real(hom.unconverged, False).sum()))
            if nhom == 0:
                norm0 = norm
            res_norms[nhom] = norm
            nhom += 1
            done = norm < cfg.newton_min_tol or norm < norm0 * cfg.newton_rel_tol
            if not done:
                # exactly the active elements: the cropped view, or on a
                # rank the node-shaped block with zero inactive tangents
                res = self.linear_solve(self._real(hom.ctan), b)
                u = u + res.x
                ksp_its[it], ksp_rnorms[it], ksp_reasons[it] = (
                    res.its, res.rnorm, res.reason,
                )
                if traces is not None:
                    traces[it] = res.trace
                it += 1
            trial = hom.trial_state
            last = (hom.stress, hom.non_linear, hom.f_trial, hom.cost)
            del hom, b

        if last is None:  # newton_max_its == 0: nothing was homogenized
            gp = dict(size=self.local_shape + (8,), device=self.device)
            last = (
                torch.zeros(gp["size"] + (6,), dtype=self.dtype, device=self.device),
                torch.zeros(**gp, dtype=torch.bool),
                torch.full(fill_value=-np.inf, dtype=self.dtype, **gp),
                torch.zeros(**gp, dtype=self.dtype),
            )
        # the real element box (on a rank: its block, inactive slots
        # neutral for the sums and the max)
        stress, non_linear, f_trial, cost = (
            self._real(a, fill) for a, fill in zip(last, (0, False, -np.inf, 0)))
        f_trial_max = float(self.comm.max(torch.max(f_trial)))
        diag = StepDiagnostics(
            res_norms=res_norms,
            ksp_its=ksp_its,
            ksp_rnorms=ksp_rnorms,
            ksp_reasons=ksp_reasons,
            n_homogenize=nhom,
            n_solves=it,
            converged=done,
            force=float(self.comm.sum(calc_force(stress, self.grid, cfg, self.origin))),
            f_trial_max=f_trial_max,
            non_linear=non_linear,
            cost=cost,
            stress=stress,
            ksp_traces=traces,
            micro_unconverged=unconv,
        )
        return u, trial, diag


def fields_from_numpy(u: np.ndarray, eps_p: np.ndarray, alpha: np.ndarray,
                      device, micro_u: Optional[np.ndarray] = None,
                      mesh: Optional[RankMesh] = None):
    """The JAX package's (u, state) as numpy — u (nx,ny,nz,3) and the
    state's leaves at node_shape+(8,...) — as the port's tensors: a J2State
    from eps_p (..,6) and alpha, or, with ``micro_u``, a MicroState from
    the flat micro eps_p, alpha and u.  With ``mesh`` (a rank of an
    N-process run, ``MacroProblem.mesh``) the arrays are the JAX N-device
    run's global ones and the rank takes its block."""
    dev = torch.device(device)
    cut = (lambda a: a) if mesh is None else mesh.local
    t = lambda a: torch.tensor(np.ascontiguousarray(cut(np.asarray(a))), device=dev)
    if micro_u is None:
        return t(u), J2State(eps_p=t(eps_p), alpha=t(alpha))
    return t(u), MicroState(eps_p=t(eps_p), alpha=t(alpha), u=t(micro_u))


def fields_to_numpy(u: torch.Tensor, state, mesh: Optional[RankMesh] = None):
    """(u, eps_p, alpha) numpy arrays in the JAX package's layout, plus the
    micro displacement for a MicroState: (u, eps_p, alpha, micro_u).  With
    ``mesh`` the ranks' blocks are gathered into the global arrays, on
    every rank (a collective)."""
    h = (lambda a: a.detach().cpu().numpy()) if mesh is None else mesh.gather
    out = (h(u), h(state.eps_p), h(state.alpha))
    return out + (h(state.u),) if isinstance(state, MicroState) else out


def run_summary(cfg: MacroConfig, device) -> dict:
    """Run cfg.ts steps and summarise them in the form of the blessed
    goldens (tests/goldens/*.json, written by tests/make_goldens.py)."""
    p = MacroProblem(cfg, device)
    u, state = p.init_fields()
    steps = []
    for ts in range(cfg.ts):
        U = cfg.displacement(ts)
        u, state, d = p.time_step(u, state, U)
        nhom, nsol = d.n_homogenize, d.n_solves
        steps.append(
            dict(
                ts=ts,
                U=float(U),
                res_norms=[float(v) for v in d.res_norms[:nhom]],
                ksp_its=[int(v) for v in d.ksp_its[:nsol]],
                force=d.force,
                f_trial_max=d.f_trial_max,
                nl_gps=int(p.nonlinear_counts(d.non_linear).sum()),
                converged=d.converged,
            )
        )
    u_np = p.unpad_u(u.cpu().numpy() if p.mesh is None else p.mesh.gather(u))
    return dict(
        steps=steps,
        u_norm=float(np.linalg.norm(u_np)),
        u_min=float(u_np.min()),
        u_max=float(u_np.max()),
    )
