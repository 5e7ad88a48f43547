#!/usr/bin/env python3
"""Micro-FE homogenize throughput of macroc_tpu_torch across the micro CG
preconditioner and gp_chunk (the counterpart of the JAX package's
scripts/tune_microfe.py):

    python3 scripts/tune_microfe_torch.py [--fastpath] [--driven-every K] [--out FILE]

The engine is the production RVE's (micro_n=10, layers along y, the soft
phase E=1e6, nu=0.3, Sy=1e4, Ka=1e7) in f32, every GP solved in full (no
elastic fast path), on 1,024 strains drawn from a numpy generator
seeded 3 (normal x 1e-4).  The sweep is precond in {jacobi,
dense_elastic} x gp_chunk in {128, 256, 512}; ``--fastpath`` adds the same
engine on the elastic fast path over screen_chunk in {128, 256, 512, 1024}.
On that draw the fast path's screen settles every GP; ``--driven-every
10`` drives every 10th strain 600x past the soft phase's yield (how
bench_torch.py's ``bench_microfe_partial`` builds its population, on this
script's numpy draw), so the fast path solves those GPs in full, as in an
FE² step where plasticity is local.

Each rate is GP/s of one homogenize: the median of 3 host-clock samples
around a synchronised call, each from the same initial state (the full
solve syncs with the host once per micro CG iteration, so CUDA events
would time only part of it).  Gate: the stresses of every configuration
agree with the first one's within 1e-4 relative to their largest entry
(the micro CG tolerance, at f32).  Each configuration's count of micro
solves that hit the Newton cap is printed (ROADMAP R6).  A configuration
that fails is printed and the sweep goes on; the script exits 1 if any
failed or missed the gate.

It runs on the card (MACROC_PLATFORM=cpu: the CPU, with the plain
versions).  The full JSON goes to ``--out`` (default
``build/tune_microfe_torch.json``); the last line printed is a headline.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from macroc_tpu_torch.utils.profiling import Timings  # noqa: E402

MAT2 = dict(E=1.0e6, nu=0.3, Sy=1.0e4, Ka=1.0e7)
N_GPS, MICRO_N = 1024, 10  # the JAX script's population and RVE
PRECONDS = ("jacobi", "dense_elastic")
CHUNKS = (128, 256, 512)
SCREEN_CHUNKS = (128, 256, 512, 1024)
# stresses of every configuration against the first one's, relative to
# its largest entry: the micro CG tolerance at f32
STRESS_RTOL = 1e-4
# the factor past the elastic draw that takes a driven GP far past the soft
# phase's yield
DRIVE = 600.0


def strains(n_gps: int, driven_every: int = 0) -> np.ndarray:
    """The swept macro strains (n_gps, 6): normal x 1e-4, seed 3; with
    ``driven_every`` k, every k-th strain times DRIVE (at k=10 as
    bench_torch.py's ``bench_microfe_partial`` drives its draw)."""
    eps = np.random.default_rng(3).standard_normal((n_gps, 6)) * 1e-4
    if driven_every:
        eps[::driven_every] *= DRIVE
    return eps


def rate(precond="auto", chunk=0, n_gps=N_GPS, micro_n=MICRO_N, dtype=torch.float32, eps=None,
         fastpath=False, screen_chunk=0, device=None, timings=None):
    """GP/s of one ``MicroFEEngine.homogenize`` of ``eps`` (default
    ``strains(n_gps)``) from a fresh state, with the micro CG
    preconditioner ``precond`` and ``gp_chunk`` ``chunk`` (0: the engine's
    auto value), on the elastic fast path with ``screen_chunk`` when
    ``fastpath``.  Returns dict(gp_per_s, stress, capped): the stresses of
    the last timed call and its count of micro solves at the Newton cap."""
    from macroc_tpu_torch import MaterialParams
    from macroc_tpu_torch.cli import device_from_env
    from macroc_tpu_torch.config import MIC_LAYER_Y
    from macroc_tpu_torch.constitutive.microfe import MicroFEEngine

    device = device_from_env() if device is None else torch.device(device)
    eng = MicroFEEngine(n=micro_n, micro_type=MIC_LAYER_Y, mat1=MaterialParams(),
                        mat2=MaterialParams(**MAT2), dtype=dtype, device=device,
                        elastic_fastpath=fastpath, precond=precond, gp_chunk=chunk,
                        screen_chunk=screen_chunk)
    e = torch.as_tensor(strains(n_gps) if eps is None else eps, dtype=dtype, device=device)
    state = eng.init_state((e.shape[0],))
    last = {}

    def go():
        last["r"] = eng.homogenize(e, state)

    t = Timings(device) if timings is None else timings
    dt = t.dispatch(go, label=f"microfe_{label(precond, chunk, fastpath, screen_chunk)}")
    r = last["r"]
    return dict(gp_per_s=e.shape[0] / dt, stress=r.stress, capped=int(r.unconverged.sum()))


def label(precond="auto", chunk=0, fastpath=False, screen_chunk=0) -> str:
    if fastpath:
        return f"fastpath screen_chunk={screen_chunk}"
    return f"{precond} chunk={chunk}"


def configurations(fastpath: bool):
    """The JAX script's sweep, plus the fast path's screen_chunk sweep."""
    out = [dict(precond=p, chunk=c) for p in PRECONDS for c in CHUNKS]
    if fastpath:
        out += [dict(fastpath=True, screen_chunk=s) for s in SCREEN_CHUNKS]
    return out


def sweep(configs, n_gps=N_GPS, micro_n=MICRO_N, dtype=torch.float32, device=None,
          timings=None, driven_every=0):
    """``rate`` of each configuration on the same strains
    (``strains(n_gps, driven_every)``); returns (rows, failures): per label
    GP/s, capped micro solves and the stresses' largest deviation from the
    first configuration's, and the labels that raised or missed
    STRESS_RTOL."""
    from macroc_tpu_torch.utils.profiling import guarded

    eps = strains(n_gps, driven_every)
    rows, failures, ref = {}, [], None
    for c in configs:
        name = label(**c)
        r = guarded(name, lambda: rate(**c, micro_n=micro_n, dtype=dtype, eps=eps,
                                       device=device, timings=timings), failures)
        if r is None:
            continue
        if ref is None:
            ref = r["stress"]
        dev = float((r["stress"] - ref).abs().max() / ref.abs().max())
        rows[name] = dict(gp_per_s=r["gp_per_s"], capped=r["capped"], stress_rel_dev=dev)
        print(f"{name}: {r['gp_per_s']:.1f} GP/s; micro solves at the Newton cap "
              f"{r['capped']}; stress max rel dev from {next(iter(rows))} {dev:.3e} "
              f"(bound {STRESS_RTOL:g})", flush=True)
        if not dev <= STRESS_RTOL:
            failures.append(name)
    return rows, failures


def main(argv=None) -> int:
    from macroc_tpu_torch.cli import device_from_env
    from macroc_tpu_torch.utils.profiling import finish
    from macroc_tpu_torch.utils.runtime import setup_runtime

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fastpath", action="store_true",
                    help="add the elastic fast path over screen_chunk")
    ap.add_argument("--driven-every", type=int, default=0,
                    help="drive every k-th strain 600x past yield (0: none)")
    ap.add_argument("--out", default=os.path.join(REPO, "build", "tune_microfe_torch.json"))
    args = ap.parse_args(argv)
    setup_runtime()
    device = device_from_env()
    t = Timings(device)
    rows, failures = sweep(configurations(args.fastpath), N_GPS, MICRO_N, device=device,
                           timings=t, driven_every=args.driven_every)
    best = max(rows, key=lambda k: rows[k]["gp_per_s"]) if rows else None
    record = dict(n_gps=N_GPS, micro_n=MICRO_N, dtype="float32",
                  driven_every=args.driven_every, rows=rows, timing_spreads=t.spreads)
    headline = dict(best=best, gp_per_s=rows[best]["gp_per_s"] if best else None)
    return finish(args.out, record, headline, failures, device)


if __name__ == "__main__":
    sys.exit(main())
