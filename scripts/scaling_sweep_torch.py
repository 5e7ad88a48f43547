#!/usr/bin/env python3
"""Strong-scaling sweep of macroc_tpu_torch (the counterpart of the JAX
package's scripts/scaling_sweep.py, itself the reference's scripts/scala/):

    python3 scripts/scaling_sweep_torch.py [--grid 48] [--steps 2] [--devices 1,2,4,8] [--out FILE]

Each count n runs ``MacroProblem.time_step`` on the same grid^3 bending J2
problem (lx=ly=lz=4, f32, newton_max_its 1, ksp_maxits 50, U=-0.01, the
rank grid of ``decide_processor_grid``) as n ranks of one process group
(``macroc_tpu_torch/parallel/launch.py``; one plain process for n=1): one
warm-up step, then 3 samples of ``steps`` steps, each step from the same
(u, state), on the host clock around synchronised calls.  A count's step
time is the slowest rank's median.  Prints the JAX script's
devices/step_time/speedup/efficiency lines with the KSP its, the global
|u| and the process-group backend.

On a machine with one card every rank shares it: the backend rule picks
gloo and every collective is staged through the host, so the figures
measure ranks time-sharing one card, not scaling (as the JAX script's
virtual CPU devices measure sharding semantics, not ICI times).  With a
card per rank the ranks run NCCL.  MACROC_PLATFORM=cpu runs the ranks on
the CPU (gloo).  A count that fails is printed and the sweep goes on; the
script then exits 1.  The full JSON goes to ``--out`` (default
``build/scaling_sweep_torch.json``); the last line printed is a headline.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# one rank: its step time (median of 3 samples) reduced to the slowest
# rank's, its K1/K2 launches, the KSP its and the global |u|
RANK_PROGRAM = r"""
import json, sys
import torch
from macroc_tpu_torch.cli import device_from_env
from macroc_tpu_torch.config import BC_BENDING, MacroConfig
from macroc_tpu_torch.grid import decide_processor_grid
from macroc_tpu_torch.ops.assembly import assemble_stencil_soa_kernel as k2
from macroc_tpu_torch.ops.stencil_spmv import stencil_matvec as k1
from macroc_tpu_torch.parallel import distributed
from macroc_tpu_torch.problem import MacroProblem
from macroc_tpu_torch.utils.profiling import Timings
from macroc_tpu_torch.utils.runtime import setup_runtime

setup_runtime()
distributed.maybe_initialize()
device = device_from_env()
n, grid, steps, dtype = json.loads(sys.argv[1])
px, py, pz = decide_processor_grid(n, grid, grid, grid)
cfg = MacroConfig(nx=grid, ny=grid, nz=grid, lx=4.0, ly=4.0, lz=4.0, bc_type=BC_BENDING,
                  dtype=dtype, procs_x=px, procs_y=py, procs_z=pz,
                  newton_max_its=1, ksp_maxits=50)
p = MacroProblem(cfg, device)
u, state = p.init_fields()
k1.launches = k2.launches = 0
last = {}

def step():
    last["u"], _, last["d"] = p.time_step(u, state, -0.01)

t = Timings(device)
med = t.dispatch(step, calls=steps, warm=lambda: (step(), p.comm.barrier()), label="step")
worst = lambda v: float(p.comm.max(torch.tensor([v], dtype=torch.float64, device=device)))
u2 = last["u"].to(torch.float64)
print("RANK " + json.dumps(dict(
    rank=p.comm.rank, backend=p.comm.backend, procs=list(p.grid.procs),
    step_s=worst(med), spread_frac=worst(t.spreads["step"]["spread_frac"]),
    ksp_its=int(last["d"].ksp_its[0]), u_norm=float(torch.sqrt(p.comm.sum(torch.sum(u2 * u2)))),
    K1=k1.launches, K2=k2.launches)), flush=True)
distributed.shutdown()
"""


def run_one(n, grid, steps, dtype="float32", timeout=900):
    """``steps`` time steps of the grid^3 problem as n ranks: dict(step_s
    (the slowest rank's median), spread_frac, ksp_its, u_norm, backend,
    procs, launches={K1, K2} summed over the ranks)."""
    from macroc_tpu_torch.parallel.launch import spawn_local

    records = spawn_local(RANK_PROGRAM, json.dumps([n, grid, steps, dtype]), n,
                          timeout=timeout)
    r0 = records[0]
    return dict(step_s=r0["step_s"], spread_frac=r0["spread_frac"], ksp_its=r0["ksp_its"],
                u_norm=r0["u_norm"], backend=r0["backend"], procs=r0["procs"],
                launches={k: sum(r[k] for r in records) for k in ("K1", "K2")})


def main(argv=None) -> int:
    import torch

    from macroc_tpu_torch.cli import device_from_env
    from macroc_tpu_torch.utils.profiling import finish, guarded

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grid", type=int, default=48)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--devices", type=str, default="1,2,4,8")
    ap.add_argument("--out", default=os.path.join(REPO, "build", "scaling_sweep_torch.json"))
    args = ap.parse_args(argv)
    device = device_from_env()
    results, failures = {}, []
    for n in [int(v) for v in args.devices.split(",")]:
        r = guarded(f"devices={n}", lambda: run_one(n, args.grid, args.steps), failures)
        if r is None:
            continue
        results[n] = r
        base_n = next(iter(results))
        speedup = results[base_n]["step_s"] / r["step_s"] * base_n
        r.update(speedup=speedup, efficiency=speedup / n)
        print(f"devices={n:<3d} step_time={r['step_s'] * 1e3:8.1f} ms  speedup={speedup:5.2f}  "
              f"efficiency={speedup / n * 100:5.1f} %  ksp_its={r['ksp_its']}  "
              f"backend={r['backend']}  |u|={r['u_norm']:.6e}", flush=True)
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    record = dict(grid=args.grid, steps=args.steps, cards=cards,
                  results={str(k): v for k, v in results.items()},
                  note="ranks beyond the card count share a card (gloo, host-staged "
                       "collectives): time sharing, not scaling")
    headline = dict(step_s={str(k): v["step_s"] for k, v in results.items()}, cards=cards)
    return finish(args.out, record, headline, failures, device)


if __name__ == "__main__":
    sys.exit(main())
