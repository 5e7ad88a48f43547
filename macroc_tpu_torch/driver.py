"""Simulation driver — the time loop with reference-compatible logging/IO
(torch form of ``macroc_tpu/driver.py``).

Orchestrates MacroProblem.time_step over ``ts`` steps, producing the
reference's stdout narrative (banner, per-Newton |RES|, per-solve KSP
lines), info.dat and gauss_evolution.dat rows and optional PVTU output,
all through the ``macroc_tpu_torch.io`` writers.  ``-log_phases`` prints a
table of device-synchronised phase times at the end.  ``-checkpoint_freq``
saves (u, state) every that many steps and ``-resume`` continues from the
newest checkpoint in ``-checkpoint_dir`` (``utils/checkpoint.py``, the JAX
package's format); ``-profile_dir`` traces the time loop with
``torch.profiler``.

Under a process group every rank runs the time loop on its block; rank 0
alone prints the narrative and writes info.dat and gauss_evolution.dat
(PetscPrintf semantics, ``macroc_tpu/driver.py:57``).  Each rank writes its
own checkpoint file and the VTU pieces its ghosted patch covers; rank 0
writes the .pvtu master.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from macroc_tpu_torch.config import BC_BENDING, BC_CIRCLE, MacroConfig
from macroc_tpu_torch.io import GaussEvolutionWriter, InfoWriter, write_pvtu
from macroc_tpu_torch.io.parallel_vtu import assign_pieces, extract_patch, halo_widths
from macroc_tpu_torch.io.vtu import OffsetView
from macroc_tpu_torch.parallel import distributed
from macroc_tpu_torch.fem.kernels import compute_strains
from macroc_tpu_torch.parallel.halo import ghosted_blocks
from macroc_tpu_torch.problem import MacroProblem
from macroc_tpu_torch.solve.cg import KSP_REASON_NAMES
from macroc_tpu_torch.utils import checkpoint as ckpt
from macroc_tpu_torch.utils.profiling import PhaseTimer, trace


class Simulation:
    def __init__(self, cfg: MacroConfig, device,
                 log: Optional[Callable[[str], None]] = None):
        self.cfg = cfg
        self.problem = MacroProblem(cfg, device)
        self.grid = self.problem.grid
        # rank-0 logging and files
        self.primary = distributed.is_primary()
        if log is None:
            log = (lambda s: print(s, end="", flush=True)) if self.primary else (lambda s: None)
        self._log = log
        mesh = self.problem.mesh
        if mesh is not None and cfg.vtu_freq > 0:
            # each rank writes the pieces its ghosted patch covers
            # (macroc_tpu/driver.py:80-97)
            self._vtu_halo = halo_widths(self.grid, mesh.node_shape)
            owner = assign_pieces(self.grid, mesh.node_shape, self._vtu_halo, mesh)
            self._vtu_pieces = sorted(r for r, p in owner.items() if p == mesh.comm.rank)

    def _write_vtu(self, prefix, u, diag, encoding):
        """The PVTU master (rank 0) and pieces of one step.  On one process
        from the whole fields; on a rank from its ghosted patches, with no
        global array anywhere (reference output.c:78-79,
        ``macroc_tpu/driver.py:182-216``)."""
        p = self.problem
        fields = self.vtu_fields(u, diag)
        kw = dict(outdir=self.cfg.output_dir, encoding=encoding, reduced=True)
        if p.mesh is None:
            u_v, stress_v, strain_v, cost_v, nl_v = (t.cpu().numpy() for t in fields)
        else:
            origin, patches = extract_patch(ghosted_blocks(fields, p.mesh, self._vtu_halo),
                                            p.mesh, self._vtu_halo)
            u_v, stress_v, strain_v, cost_v, nl_v = (OffsetView(a, origin) for a in patches)
            kw.update(ranks=self._vtu_pieces, write_master=self.primary)
        write_pvtu(prefix, self.grid, u_v, stress_v, strain_v, nl_v, cost_v, self.grid.wg,
                   **kw)

    def vtu_fields(self, u, diag):
        """Element-level VTU fields (u, stress, strain, cost, non-linear
        count) on the device: the reference's *wg sum and /NGP average, in
        float64.  On one process the real box; on a rank its block, the
        strains from the exchanged u."""
        p = self.problem
        if p.mesh is None:
            u = p.unpad_u(u)
            strain = compute_strains(u, p.B)
        else:
            strain = p.slot_strains(u)
        f64, wg = torch.float64, self.grid.wg
        return (
            u,
            diag.stress.to(f64).sum(dim=3) * wg,
            strain.to(f64).sum(dim=3) * wg,
            diag.cost.to(f64).sum(dim=3) / 8.0,
            diag.non_linear.to(torch.int32).sum(dim=3),
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
                # PETSc -ksp_monitor line format (a GMRES trace is
                # nan-padded to ksp_maxits + 1 entries)
                its = int(diag.ksp_its[it])
                for k, rn in enumerate(diag.ksp_traces[it][:its + 1]):
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
        """Run the time loop; returns dict(u, state, history, elapsed,
        phases, diag), diag the last step's StepDiagnostics (None if no
        step ran)."""
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
        start_step = 0
        if cfg.resume:
            loaded = ckpt.load_latest(cfg.checkpoint_dir, (u, state), p.mesh)
            if loaded is not None:
                start_step, (u, state) = loaded
                L(f"Resumed from checkpoint at step {start_step}\n")
        timer = PhaseTimer(p.device)
        p.timer = timer if cfg.log_phases else None
        sync = p.device.type == "cuda"
        # a resumed run appends, so the files stay a complete history
        info = gauss = None
        if self.primary:
            info = InfoWriter(os.path.join(cfg.output_dir, "info.dat"),
                              append=start_step > 0)
            gauss = GaussEvolutionWriter(
                os.path.join(cfg.output_dir, "gauss_evolution.dat"), append=start_step > 0
            )
        vtu_encoding = cfg.vtu_encoding
        if vtu_encoding == "auto":
            vtu_encoding = "appended" if self.grid.nnodes > 100_000 else "ascii"
        history = []
        diag = None
        t1 = time.time()
        try:
            with trace(cfg.profile_dir or None, p.device):
                for time_s in range(start_step, cfg.ts):
                    L(f"\n\nTime Step = {time_s}\n")
                    U = cfg.displacement(time_s)
                    t0 = time.perf_counter()
                    with timer.phase("time_step"):
                        u, state, diag = p.time_step(u, state, U)
                        if sync:
                            torch.cuda.synchronize()
                    seconds = time.perf_counter() - t0
                    self._log_newton(diag)
                    per_rank = p.nonlinear_counts(diag.non_linear)
                    nl_gps = int(per_rank.sum())
                    L(f"Non-Linear Gauss points : {nl_gps}\n")
                    L(f"F_trial_max             : {diag.f_trial_max:e}\n")
                    if diag.micro_unconverged:
                        L(
                            f"WARNING: {diag.micro_unconverged} micro RVE solves hit "
                            "the Newton cap above tolerance\n"
                        )
                    if self.primary:
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
                            self._write_vtu(f"solution_{time_s}", u, diag, vtu_encoding)
                    if cfg.checkpoint_freq > 0 and (time_s + 1) % cfg.checkpoint_freq == 0:
                        with timer.phase("checkpoint"):
                            ckpt.save(cfg.checkpoint_dir, time_s + 1, (u, state), p.mesh)
        finally:
            if self.primary:
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
                    phases=dict(timer.totals), diag=diag)
