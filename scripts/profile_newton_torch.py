#!/usr/bin/env python3
"""Phase budget of the converged n^3 J2 + MG f32 Newton step of
macroc_tpu_torch on one CUDA GPU (the counterpart of the JAX package's
scripts/profile_newton.py):

    python3 scripts/profile_newton_torch.py [n]

Times each phase of ``MacroProblem.time_step`` alone, from the same
inputs on every call, and prints a table (median of 3 samples per phase):

  step(total)          the whole time step (host clock, synchronised)
  homogenize+residual  strains -> J2 radial return -> force assembly -> BC
  assembly             per-GP tangents -> BC-eliminated SoA stencil (K2)
  hierarchy            the MG levels given the fine operator (coarsened
                       tangents, K2 per coarse level, 3x3 diagonal
                       inverses)
  spmv                 one fine-level matvec (K1)
  vcycle               one V(1,1) application over every level
  linear_solve(total)  assembly + hierarchy + PCG to rtol 1e-5 (host
                       clock, synchronised)

The device-only phases are timed by CUDA events over many calls.  ``main``
returns the phase times in ms; ``bench_torch.py --phases`` records them.
"""

from __future__ import annotations

import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from macroc_tpu_torch.utils.profiling import Timings  # noqa: E402

PHASES = ("step(total)", "homogenize+residual", "assembly", "hierarchy", "spmv", "vcycle",
          "linear_solve(total)")


def main(n=128, device="cuda", timings=None):
    from macroc_tpu_torch import MacroConfig
    from macroc_tpu_torch import bc as bc_mod
    from macroc_tpu_torch.config import BC_BENDING
    from macroc_tpu_torch.ops.assembly import assemble_stencil_soa_kernel
    from macroc_tpu_torch.ops.stencil_spmv import stencil_matvec, x_to_soa
    from macroc_tpu_torch.problem import MacroProblem
    from macroc_tpu_torch.solve.mg import build_hierarchy, make_mg_preconditioner
    from macroc_tpu_torch.utils.runtime import setup_runtime

    setup_runtime()
    device = torch.device(device)
    t = Timings(device) if timings is None else timings
    print(f"Phase budget, {n}^3 j2/MG/f32:", flush=True)
    cfg = MacroConfig(
        nx=n, ny=n, nz=n, lx=4.0, ly=4.0, lz=4.0,
        bc_type=BC_BENDING, dtype="float32", constitutive="j2",
        newton_max_its=1, ksp_maxits=10000, ksp_rtol=1e-5, pc_type="mg",
    )
    p = MacroProblem(cfg, device)
    u, state = p.init_fields()
    U = -0.01
    res = {}

    def rec(name, seconds):
        res[name] = seconds * 1e3
        print(f"  {name:24s} {seconds * 1e3:9.1f} ms", flush=True)

    def loop(name, fn, calls):
        rec(name, t.loop(fn, calls, label=f"profile_{name}_{n}"))

    def dispatch(name, fn):
        rec(name, t.dispatch(fn, label=f"profile_{name}_{n}"))

    # the fused step first (smallest resident set: u and the state only)
    dispatch("step(total)", lambda: p.time_step(u, state, U))
    u = bc_mod.apply_bc_on_u(U, u, p.bc)
    loop("homogenize+residual", lambda: p.residual(u, state), 5)

    # the inputs of the later phases: the residual and the real elements'
    # tangents, the strided view of the GP storage that the step hands K2
    b, _, hom = p.residual(u, state)
    ctan = hom.ctan[:-1, :-1, :-1]
    del hom

    def assemble():
        A = assemble_stencil_soa_kernel(ctan, p.B, p.grid.wg, p.node_shape, dsh=p.dsh)
        return bc_mod.apply_bc_stencil_soa(A, p.bc)

    loop("assembly", assemble, 10)
    A_soa = assemble()

    def hierarchy():
        return build_hierarchy(ctan, p.mask_soa, p.grid.spacing, cfg.ref_b_quirk,
                               A0_soa=A_soa, assemble_fn=assemble_stencil_soa_kernel)

    loop("hierarchy", hierarchy, 3)
    b_soa = x_to_soa(b)
    loop("spmv", lambda: stencil_matvec(A_soa, b_soa), 50)
    M = make_mg_preconditioner(
        hierarchy(), nu=cfg.mg_nu, omega=cfg.mg_omega, coarse_sweeps=cfg.mg_coarse_sweeps,
        mv_for=lambda level: stencil_matvec, coarse_direct=cfg.mg_coarse_direct,
        transfer_order=cfg.mg_transfer_order or None, dtype=p.dtype,
    )
    loop("vcycle", lambda: M(b_soa), 20)
    del M, A_soa  # the level operators, before the full solve builds its own
    dispatch("linear_solve(total)", lambda: p.linear_solve(ctan, b))
    res["sum(hom+linsolve)"] = res["homogenize+residual"] + res["linear_solve(total)"]
    print(f"  {'sum(hom+linsolve)':24s} {res['sum(hom+linsolve)']:9.1f} ms", flush=True)
    return res


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 128)
