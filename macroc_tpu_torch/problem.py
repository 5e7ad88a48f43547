"""MacroProblem — the Newton/time-step core on one device (torch form of
``macroc_tpu/problem.py``).

Per time step: ramp the Dirichlet load, then the Newton loop (strains ->
constitutive homogenize -> residual -> convergence test -> stencil assembly
-> Dirichlet elimination -> PCG -> update), then commit the constitutive
state.  The reference's ``lax.while_loop``/``lax.cond`` become a Python
loop with one host read of |RES| per Newton iteration.

Semantics kept exactly (macroc_tpu/problem.py:13-22):
  - convergence is tested BEFORE the first solve; a converged step performs
    1 homogenize + 1 residual and 0 solves;
  - norm_0 is captured at iteration 0 of each time step;
  - newton_max_its bounds the number of solves;
  - the committed state is the trial state of the LAST homogenize, even
    when the loop exits by iteration count after a final solve updated u;
  - residual b = -(internal force with Dirichlet rows zeroed), u += du.

GP arrays (state, stress, flags) are stored at node shape + (8,): the
trailing slot per dim is an inactive element that always sees zero strain,
the layout of the JAX package, so its state carries across unchanged.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from macroc_tpu.config import MacroConfig
from macroc_tpu.grid import StructuredGrid3D, make_grid
from macroc_tpu_torch import bc as bc_mod
from macroc_tpu_torch.constitutive import J2State, make_engine
from macroc_tpu_torch.fem.element import b_for
from macroc_tpu_torch.fem.kernels import (
    assemble_residual,
    assemble_stencil_soa,
    compute_strains,
)
from macroc_tpu_torch.forces import calc_force
from macroc_tpu_torch.ops.assembly import assemble_stencil_soa_kernel
from macroc_tpu_torch.ops.stencil_spmv import (
    stencil_matvec,
    stencil_matvec_soa,
    x_from_soa,
    x_to_soa,
)
from macroc_tpu_torch.solve.cg import cg_solve
from macroc_tpu_torch.solve.mg import build_hierarchy, make_mg_preconditioner
from macroc_tpu_torch.solve.precond import (
    block_jacobi_precond_soa,
    identity_precond,
    jacobi_precond_soa,
)
from macroc_tpu_torch.utils.profiling import no_phase

DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclasses.dataclass
class StepDiagnostics:
    """Per-time-step diagnostics; Newton/KSP records are host arrays sized
    by newton_max_its, the per-GP fields device tensors on the real
    element box."""

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


def resolve_solver_plan_torch(cfg: MacroConfig, node_shape, device) -> dict:
    """The solver choices: dict(pc_type, operator, assembly).

    pc_type "auto" keeps the reference rule: MG when a deep hierarchy
    exists along at least two dims (extent >= 17; a thin third dim is
    semicoarsened), Jacobi otherwise.  On CUDA every operator and every MG
    level runs kernel K1 ("stencil_cuda") and every assembly kernel K2
    ("cuda"); on the CPU the plain versions run ("stencil", "slab")."""
    if cfg.operator == "matfree":
        raise NotImplementedError(
            "-operator matfree is not ported to macroc_tpu_torch yet "
            "(ROADMAP.md, matfree operator)"
        )
    pc_type = cfg.pc_type
    if pc_type == "auto":
        deep_dims = sum(n >= 17 for n in node_shape)
        pc_type = "mg" if deep_dims >= 2 else "jacobi"
    cuda = torch.device(device).type == "cuda"
    return dict(
        pc_type=pc_type,
        operator="stencil_cuda" if cuda else "stencil",
        assembly="cuda" if cuda else "slab",
    )


_OPERATORS = {"stencil_cuda": stencil_matvec, "stencil": stencil_matvec_soa}
_ASSEMBLERS = {"cuda": assemble_stencil_soa_kernel, "slab": assemble_stencil_soa}


class MacroProblem:
    """Grid, config, BCs and constitutive engine on one device."""

    def __init__(self, cfg: MacroConfig, device, grid: Optional[StructuredGrid3D] = None):
        if cfg.dtype not in DTYPES:
            raise ValueError(f"dtype must be float32 or float64, got {cfg.dtype!r}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.grid = grid or make_grid(cfg, 1)
        if self.grid.nproc != 1:
            raise NotImplementedError(
                "macroc_tpu_torch runs on one device (multi-GPU is later "
                "work, ROADMAP.md)"
            )
        self.dtype = DTYPES[cfg.dtype]
        g = self.grid
        self.B = torch.as_tensor(
            b_for(g.spacing, cfg.ref_b_quirk), dtype=self.dtype, device=self.device
        )
        self.engine = make_engine(cfg, self.dtype, self.device)
        self.real_shape = (g.nx, g.ny, g.nz)
        self.node_shape = self.real_shape
        self.real_elem_shape = (g.nx - 1, g.ny - 1, g.nz - 1)
        self.elem_shape = self.node_shape  # GP storage: one inactive slot per dim
        self.bc = bc_mod.build_bc(g, cfg, self.dtype, self.device)
        # a PhaseTimer (utils/profiling.py) to book the step's phases to
        self.timer = None

    def _phase(self, name: str):
        return self.timer.phase(name) if self.timer is not None else no_phase(name)

    def unpad_u(self, u: torch.Tensor) -> torch.Tensor:
        nx, ny, nz = self.real_shape
        return u[:nx, :ny, :nz]

    def init_fields(self):
        """(u, constitutive state) — zero displacement, fresh internal vars."""
        u = torch.zeros(self.node_shape + (3,), dtype=self.dtype, device=self.device)
        return u, self.engine.init_state(self.elem_shape + (8,))

    def _pad_gp(self, arr: torch.Tensor) -> torch.Tensor:
        """Element-kernel output (n-1 dims) -> GP storage layout (node dims)."""
        return F.pad(arr, [0, 0] * (arr.ndim - 3) + [0, 1, 0, 1, 0, 1])

    @staticmethod
    def _crop_gp(arr: torch.Tensor) -> torch.Tensor:
        """GP storage layout -> element-kernel input (n-1 dims)."""
        return arr[:-1, :-1, :-1]

    def residual(self, u: torch.Tensor, state: Any):
        """(b, norm, hom): negated, BC-zeroed residual, its L2 norm (a 0-dim
        tensor) and the homogenize result."""
        # the inactive trailing element slots get zero strain from the pad,
        # so their state stays pristine
        eps = self._pad_gp(compute_strains(u, self.B))
        hom = self.engine.homogenize(eps, state)
        f = assemble_residual(
            self._crop_gp(hom.stress), self.B, self.grid.wg, self.node_shape
        )
        b = -bc_mod.apply_bc_on_res(f, self.bc)
        return b, torch.sqrt(torch.sum(b * b)), hom

    def linear_solve(self, ctan: torch.Tensor, b: torch.Tensor):
        """Assemble the BC-eliminated operator from per-GP tangents ctan
        (element shape) and run PCG on it.  Returns a KSPResult with x in
        node layout (nx,ny,nz,3)."""
        cfg = self.cfg
        plan = resolve_solver_plan_torch(cfg, self.node_shape, self.device)
        matvec = _OPERATORS[plan["operator"]]
        assemble = _ASSEMBLERS[plan["assembly"]]
        with self._phase("assembly"):
            A_soa = bc_mod.apply_bc_stencil_soa(
                assemble(ctan, self.B, self.grid.wg, self.node_shape), self.bc
            )
        with self._phase("precond_setup"):
            pc_type = plan["pc_type"]
            if pc_type == "jacobi":
                M = jacobi_precond_soa(A_soa)
            elif pc_type == "bjacobi":
                M = block_jacobi_precond_soa(A_soa)
            elif pc_type == "mg":
                if cfg.mg_dtype and DTYPES.get(cfg.mg_dtype) != self.dtype:
                    raise NotImplementedError(
                        "-mg_dtype other than the solve dtype is not ported "
                        "(ROADMAP.md: the bf16 MG decision waits for an H100 "
                        "measurement)"
                    )
                levels = build_hierarchy(
                    ctan, self.bc.mask.permute(3, 0, 1, 2), self.grid.spacing,
                    cfg.ref_b_quirk, A0_soa=A_soa, assemble_fn=assemble,
                )
                M = make_mg_preconditioner(
                    levels,
                    nu=cfg.mg_nu,
                    omega=cfg.mg_omega,
                    coarse_sweeps=cfg.mg_coarse_sweeps,
                    mv_for=lambda level: matvec,
                    coarse_direct=cfg.mg_coarse_direct,
                    transfer_order=cfg.mg_transfer_order or None,
                )
            elif pc_type == "none":
                M = identity_precond()
            else:
                raise ValueError(
                    f"unknown pc_type '{cfg.pc_type}' (auto|none|jacobi|bjacobi|mg)"
                )
        if cfg.ksp_type != "cg":
            raise NotImplementedError(
                f"-ksp_type {cfg.ksp_type} is not ported to macroc_tpu_torch "
                "yet (ROADMAP.md: GMRES comes next)"
            )
        with self._phase("ksp_solve"):
            res = cg_solve(
                partial(matvec, A_soa), x_to_soa(b), M,
                rtol=cfg.ksp_rtol, abstol=cfg.ksp_abstol, dtol=cfg.ksp_dtol,
                maxits=cfg.ksp_maxits, record_trace=cfg.ksp_monitor,
            )
        return res._replace(x=x_from_soa(res.x))

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
        it = nhom = 0
        norm0 = 0.0
        done = False
        while not done and it < max_its:
            with self._phase("residual"):
                b, norm, hom = self.residual(u, state)
                norm = float(norm)
            if nhom == 0:
                norm0 = norm
            res_norms[nhom] = norm
            nhom += 1
            done = norm < cfg.newton_min_tol or norm < norm0 * cfg.newton_rel_tol
            if not done:
                # the cropped view holds exactly the active elements
                res = self.linear_solve(self._crop_gp(hom.ctan), b)
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

        nex, ney, nez = self.real_elem_shape
        if last is None:  # newton_max_its == 0: nothing was homogenized
            gp = dict(size=(nex, ney, nez, 8), device=self.device)
            last = (
                torch.zeros(gp["size"] + (6,), dtype=self.dtype, device=self.device),
                torch.zeros(**gp, dtype=torch.bool),
                torch.full(fill_value=-np.inf, dtype=self.dtype, **gp),
                torch.zeros(**gp, dtype=self.dtype),
            )
        stress, non_linear, f_trial, cost = (a[:nex, :ney, :nez] for a in last)
        f_trial_max = float(torch.max(f_trial))
        diag = StepDiagnostics(
            res_norms=res_norms,
            ksp_its=ksp_its,
            ksp_rnorms=ksp_rnorms,
            ksp_reasons=ksp_reasons,
            n_homogenize=nhom,
            n_solves=it,
            converged=done,
            force=float(calc_force(stress, self.grid, cfg)),
            f_trial_max=f_trial_max,
            non_linear=non_linear,
            cost=cost,
            stress=stress,
            ksp_traces=traces,
        )
        return u, trial, diag


def fields_from_numpy(u: np.ndarray, eps_p: np.ndarray, alpha: np.ndarray, device):
    """The JAX package's (u, J2State) as numpy — u (nx,ny,nz,3), eps_p
    node_shape+(8,6), alpha node_shape+(8,) — as the port's tensors."""
    dev = torch.device(device)
    return (
        torch.tensor(np.asarray(u), device=dev),
        J2State(
            eps_p=torch.tensor(np.asarray(eps_p), device=dev),
            alpha=torch.tensor(np.asarray(alpha), device=dev),
        ),
    )


def fields_to_numpy(u: torch.Tensor, state: J2State):
    """(u, eps_p, alpha) numpy arrays in the JAX package's layout."""
    return (
        u.detach().cpu().numpy(),
        state.eps_p.detach().cpu().numpy(),
        state.alpha.detach().cpu().numpy(),
    )


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
                nl_gps=int(d.non_linear.sum()),
                converged=d.converged,
            )
        )
    u_np = p.unpad_u(u).cpu().numpy()
    return dict(
        steps=steps,
        u_norm=float(np.linalg.norm(u_np)),
        u_min=float(u_np.min()),
        u_max=float(u_np.max()),
    )
