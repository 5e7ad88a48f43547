"""Simulation driver — the time loop with reference-compatible logging/IO
(torch form of ``macroc_tpu/driver.py``, one device).

Orchestrates MacroProblem.time_step over ``ts`` steps, producing the
reference's stdout narrative (banner, per-Newton |RES|, per-solve KSP
lines), info.dat and gauss_evolution.dat rows and optional PVTU output,
all through the reused ``macroc_tpu.io`` writers.  ``-log_phases`` prints a
table of device-synchronised phase times at the end.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from macroc_tpu.config import BC_BENDING, BC_CIRCLE, MacroConfig
from macroc_tpu.io import GaussEvolutionWriter, InfoWriter, write_pvtu
from macroc_tpu_torch.fem.kernels import compute_strains
from macroc_tpu_torch.forces import per_rank_nonlinear_counts_device
from macroc_tpu_torch.problem import MacroProblem
from macroc_tpu_torch.solve.cg import KSP_REASON_NAMES
from macroc_tpu_torch.utils.profiling import PhaseTimer


class Simulation:
    def __init__(self, cfg: MacroConfig, device,
                 log: Optional[Callable[[str], None]] = None):
        self.cfg = cfg
        self.problem = MacroProblem(cfg, device)
        self.grid = self.problem.grid
        self._log = log or (lambda s: print(s, end="", flush=True))

    def vtu_fields(self, u, diag):
        """Element-level VTU fields on the host (the reference's *wg sum and
        /NGP average), reduced on the device in float64."""
        p = self.problem
        u_real = p.unpad_u(u)
        strain = compute_strains(u_real, p.B)
        wg = self.grid.wg
        f64 = torch.float64
        host = lambda t: t.cpu().numpy()
        return (
            host(u_real),
            host(diag.stress.to(f64).sum(dim=3) * wg),
            host(strain.to(f64).sum(dim=3) * wg),
            host(diag.cost.to(f64).sum(dim=3) / 8.0),
            host(diag.non_linear.to(torch.int32).sum(dim=3)),
        )

    def log_banner(self):
        cfg, g = self.cfg, self.grid
        L = self._log
        # byte-identical to the reference banner (src/main.c:38,
        # init.c:122-131)
        L("\nMacroC : A HPC for FE2 Multi-scale Simulations\n\n")
        bc_name = {BC_BENDING: "BC_BENDING", BC_CIRCLE: "BC_CIRCLE"}.get(
            cfg.bc_type, "?"
        )
        L(f"Boundary Condition : {bc_name}\n")
        L(f"Number of CPUs     : {g.nproc}\n")
        L(f"Number of Elements : {g.nelem_global}\n")
        L(f"Number of Nodes    : {g.nnodes}\n")
        L(f"Number of DOFs     : {g.ndof}\n\n")
        px, py, pz = g.procs
        L(f"NP_X : {px}\tNP_Y : {py}\tNP_Z : {pz}\n")
        L(f"NX   : {g.nx}\tNY   : {g.ny}\tNZ   : {g.nz}\n\n")
        L(
            f"KSP Info: type = {cfg.ksp_type}\trtol = {cfg.ksp_rtol:e}\t"
            f"abstol = {cfg.ksp_abstol:e}\tdtol = {cfg.ksp_dtol:e}\t"
            f"maxits = {cfg.ksp_maxits}\n\n"
        )
        for r in range(g.nproc):
            b = g.local_box(r)
            L(f"rank:{r}\tne:{b.nelem}\tnex:{b.nex}\tney:{b.ney}\tnez:{b.nez}\n")
        mn, mx, imb = g.load_imbalance()
        L(f"Min : {mn} Max : {mx} Unbalance (Max - Min) / Max = {imb:3.1f} %\n")
        L("Material Values : \n")
        for mat in (cfg.micro_mat_1, cfg.micro_mat_2):
            L(
                f"E = {mat.E:e} nu = {mat.nu:e} Sy = {mat.Sy:e} "
                f"Ka = {mat.Ka:e} plastic = {int(mat.plastic)}\n"
            )

    def _log_newton(self, diag):
        cfg, L = self.cfg, self._log
        for it in range(diag.n_homogenize):
            L(f"\nNewton Iteration = {it}\n")
            L("Homogenizing MicroPP\n")
            L("Assemblying RHS\n")
            L(f"|RES| = {diag.res_norms[it]:e}\n")
            if it >= diag.n_solves:
                continue
            if diag.ksp_traces is not None:
                # PETSc -ksp_monitor line format
                for k, rn in enumerate(diag.ksp_traces[it]):
                    L(f"{k:3d} KSP Residual norm {rn:14.12e}\n")
            L(
                f"KSP : |Ax - b|/|Ax| = {diag.ksp_rnorms[it]:e}\t"
                f"Its = {diag.ksp_its[it]}\n"
            )
            if cfg.ksp_converged_reason:
                # PETSc -ksp_converged_reason line format
                rc = int(diag.ksp_reasons[it])
                verdict = "converged" if rc > 0 else "did not converge"
                L(
                    f"Linear solve {verdict} due to "
                    f"{KSP_REASON_NAMES.get(rc, str(rc))} "
                    f"iterations {diag.ksp_its[it]}\n"
                )

    def run(self) -> dict:
        """Run the time loop; returns dict(u, state, history, elapsed)."""
        cfg = self.cfg
        L = self._log
        p = self.problem
        self.log_banner()
        L(
            "------------------------------------------------------------\n"
            "STARTING CALCULATION...\n"
            "------------------------------------------------------------\n"
        )
        u, state = p.init_fields()
        timer = PhaseTimer(p.device)
        p.timer = timer if cfg.log_phases else None
        sync = p.device.type == "cuda"
        info = InfoWriter(os.path.join(cfg.output_dir, "info.dat"))
        gauss = GaussEvolutionWriter(os.path.join(cfg.output_dir, "gauss_evolution.dat"))
        vtu_encoding = cfg.vtu_encoding
        if vtu_encoding == "auto":
            vtu_encoding = "appended" if self.grid.nnodes > 100_000 else "ascii"
        history = []
        t1 = time.time()
        try:
            for time_s in range(cfg.ts):
                L(f"\n\nTime Step = {time_s}\n")
                U = cfg.displacement(time_s)
                t0 = time.perf_counter()
                with timer.phase("time_step"):
                    u, state, diag = p.time_step(u, state, U)
                    if sync:
                        torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                self._log_newton(diag)
                per_rank = per_rank_nonlinear_counts_device(
                    diag.non_linear, self.grid
                ).cpu().numpy()
                nl_gps = int(per_rank.sum())
                L(f"Non-Linear Gauss points : {nl_gps}\n")
                L(f"F_trial_max             : {diag.f_trial_max:e}\n")
                gauss.write_row(time_s, per_rank)
                info.write_row(
                    time_s, time_s * cfg.dt, U, diag.force, diag.f_trial_max, nl_gps
                )
                history.append(
                    dict(
                        ts=time_s,
                        U=U,
                        force=diag.force,
                        f_trial_max=diag.f_trial_max,
                        nl_gps=nl_gps,
                        converged=diag.converged,
                        res_norms=diag.res_norms[:diag.n_homogenize].tolist(),
                        ksp_its=diag.ksp_its[:diag.n_solves].tolist(),
                        ksp_reasons=diag.ksp_reasons[:diag.n_solves].tolist(),
                        seconds=seconds,
                    )
                )
                if cfg.vtu_freq > 0 and time_s % cfg.vtu_freq == 0:
                    with timer.phase("vtu_output"):
                        u_real, el_stress, el_strain, el_cost, el_nl = (
                            self.vtu_fields(u, diag)
                        )
                        write_pvtu(
                            f"solution_{time_s}", self.grid,
                            u_real, el_stress, el_strain, el_nl, el_cost,
                            self.grid.wg,
                            outdir=cfg.output_dir,
                            encoding=vtu_encoding,
                            reduced=True,
                        )
        finally:
            info.close()
            gauss.close()
        t2 = time.time()
        L(
            "\n\n"
            "------------------------------------------------------------\n"
            "FINISHING CALCULATION...\n"
            "------------------------------------------------------------\n"
        )
        L(f"Elapsed time : {t2 - t1:f}\n")
        if cfg.log_phases and timer.totals:
            L(timer.report() + "\n")
        return dict(u=u, state=state, history=history, elapsed=t2 - t1,
                    phases=dict(timer.totals))
