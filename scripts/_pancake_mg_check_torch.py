#!/usr/bin/env python3
"""Semicoarsened MG against Jacobi on pancake grids: PCG iteration counts
of macroc_tpu_torch (the counterpart of the JAX package's
scripts/_pancake_mg_check.py):

    python3 scripts/_pancake_mg_check_torch.py [--out FILE]

For each node grid (33,3,33), (50,3,50) and (40,3,40) at lx=lz=50, ly=1,
f64: the elastic operator of the default material at every GP (the
reference's unit-spacing B), with the default configuration's circle BCs
eliminated, and a right-hand side from a numpy generator seeded 3, zero on
the Dirichlet dofs.  PCG to rtol 1e-5 with the Jacobi preconditioner and
with the MG V(nu,nu) cycle, nu in (1, 2), omega in (0.6, 0.8, 1.0), 10
coarse sweeps.  A pancake's hierarchy is semicoarsened (y stays whole)
with line smoothing along y and cubic transfers.  Reports each solve's
iterations and stop reason, the level shapes, and MG's distance from the
Jacobi solution relative to its norm.

On the card K2 assembles every level and K1 runs every matvec
(MACROC_PLATFORM=cpu: the CPU, with the plain versions).  A grid whose
check raises is printed and the others go on; the script then exits 1.
The full JSON goes to ``--out`` (default
``build/pancake_mg_check_torch.json``); the last line printed is a
headline.
"""

from __future__ import annotations

import argparse
import os
import sys
from functools import partial

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SHAPES = [(33, 3, 33), (50, 3, 50), (40, 3, 40)]
RTOL = 1e-5


def check(shape, nus=(1, 2), omegas=(0.6, 0.8, 1.0), dtype=torch.float64, device=None):
    """Jacobi and MG PCG on the pancake operator of node grid ``shape``;
    returns dict(shape, levels, jacobi, mg): the solves as dict(its,
    reason, x) with x the SoA solution (3,nx,ny,nz) as numpy, each MG
    entry with its nu, omega and rel_diff from the Jacobi solution."""
    from macroc_tpu_torch import MacroConfig, MaterialParams
    from macroc_tpu_torch import bc as bc_mod
    from macroc_tpu_torch.cli import device_from_env
    from macroc_tpu_torch.constitutive.elastic import elastic_matrix
    from macroc_tpu_torch.fem.element import b_for
    from macroc_tpu_torch.grid import make_grid
    from macroc_tpu_torch.ops.stencil_spmv import x_to_soa
    from macroc_tpu_torch.problem import _ASSEMBLERS, _OPERATORS, resolve_solver_plan_torch
    from macroc_tpu_torch.solve.cg import cg_solve
    from macroc_tpu_torch.solve.mg import build_hierarchy, make_mg_preconditioner
    from macroc_tpu_torch.solve.precond import jacobi_precond_soa

    device = device_from_env() if device is None else torch.device(device)
    nx, ny, nz = shape
    cfg = MacroConfig(nx=nx, ny=ny, nz=nz, lx=50.0, ly=1.0, lz=50.0,
                      dtype=str(dtype).split(".")[-1], ref_b_quirk=True)
    grid = make_grid(cfg, 1)
    # K2 and K1 on the card, the plain versions on the CPU
    plan = resolve_solver_plan_torch(cfg, shape, device)
    assemble, mv = _ASSEMBLERS[plan["assembly"]], _OPERATORS[plan["operator"]]
    B = torch.as_tensor(b_for(grid.spacing, True), dtype=dtype, device=device)
    C = torch.as_tensor(elastic_matrix(MaterialParams()), dtype=dtype, device=device)
    # materialised: K2 reads each element's tangents in place
    ctan = C.expand((nx - 1, ny - 1, nz - 1, 8, 6, 6)).contiguous()
    bc = bc_mod.build_bc(grid, cfg, dtype, device)
    A_soa = bc_mod.apply_bc_stencil_soa(assemble(ctan, B, grid.wg, shape), bc)
    mask = bc.mask.cpu().numpy()
    rng = np.random.default_rng(3)
    b = x_to_soa(torch.as_tensor(np.where(mask, 0.0, rng.normal(size=shape + (3,))),
                                 dtype=dtype, device=device))
    matvec = partial(mv, A_soa)

    def solve(M):
        r = cg_solve(matvec, b, M, rtol=RTOL)
        return r, dict(its=r.its, reason=r.reason, x=r.x.cpu().numpy())

    r_j, jacobi = solve(jacobi_precond_soa(A_soa))
    levels = build_hierarchy(ctan, bc.mask.permute(3, 0, 1, 2), grid.spacing, True,
                             A0_soa=A_soa, assemble_fn=assemble)
    out = dict(shape=list(shape), levels=[list(lv.A_soa.shape[-3:]) for lv in levels],
               line_dim=levels[0].line_dim, jacobi=jacobi, mg=[])
    for nu in nus:
        for omega in omegas:
            M = make_mg_preconditioner(levels, nu=nu, omega=omega, coarse_sweeps=10,
                                       mv_for=lambda level: mv)
            r_m, rec = solve(M)
            rec.update(nu=nu, omega=omega,
                       rel_diff=float(torch.linalg.norm(r_m.x - r_j.x) / torch.linalg.norm(r_j.x)))
            out["mg"].append(rec)
    return out


def without_x(result: dict) -> dict:
    """``check``'s result without the solutions (for the JSON)."""
    drop = lambda d: {k: v for k, v in d.items() if k != "x"}
    return dict(result, jacobi=drop(result["jacobi"]), mg=[drop(m) for m in result["mg"]])


def main(argv=None) -> int:
    from macroc_tpu_torch.cli import device_from_env
    from macroc_tpu_torch.utils.profiling import finish, guarded
    from macroc_tpu_torch.utils.runtime import setup_runtime

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "build", "pancake_mg_check_torch.json"))
    args = ap.parse_args(argv)
    setup_runtime()
    device = device_from_env()
    results, failures = [], []
    for shape in SHAPES:
        r = guarded("x".join(map(str, shape)), lambda: without_x(check(shape, device=device)),
                    failures)
        if r is None:
            continue
        results.append(r)
        print(f"{'x'.join(map(str, shape))}: jacobi {r['jacobi']['its']} its | levels "
              f"{[tuple(s) for s in r['levels']]}", flush=True)
        for m in r["mg"]:
            print(f"  nu={m['nu']} omega={m['omega']}: mg {m['its']} its "
                  f"(reason {m['reason']}) rel-diff {m['rel_diff']:.1e}", flush=True)
    its = {"x".join(map(str, r["shape"])): dict(jacobi=r["jacobi"]["its"],
                                                mg=[m["its"] for m in r["mg"]]) for r in results}
    return finish(args.out, dict(rtol=RTOL, results=results), dict(its=its), failures, device)


if __name__ == "__main__":
    sys.exit(main())
