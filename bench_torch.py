#!/usr/bin/env python3
"""Benchmark of macroc_tpu_torch on one CUDA GPU (the counterpart of the
JAX package's bench.py):

    python3 bench_torch.py [--phases] [--out FILE]

Headline: the 27-point 3x3-block stencil SpMV in nnz/s at 128^3 f32 (243
stored coefficients per node), against the card's memory roofline
(3.35 TB/s over the 996 bytes one node's product must move).  Beside it,
on the same card:

  bench_spmv            the SpMV variants on the assembled 128^3 elastic
                        stencil: the plain version, K1, K1v1 and K1's halo
                        form on a one-process rank mesh, gated against the
                        plain version; a torch.sparse CSR SpMV as the
                        library yardstick;
  bench_newton_step     the converged 128^3 J2 Newton step (one homogenize,
                        assembly, PCG to rtol 1e-5) with MG and with Jacobi;
  bench_microfe         micro-FE homogenize rates at the production RVE
                        (micro_n=10): 256 GPs in full, and the production
                        population of 38,416 GPs (50x3x50) in full and on
                        the elastic fast path;
  bench_microfe_partial 2048 GPs with every 10th driven past yield;
  bench_assembly_shmap  K2 at the 8-way 128^3 rank block, and the rank
                        assembly wrapper on a one-process mesh against K2;
  bench_fe2_step        one FE² Newton step: the fast path at the
                        production 50x3x50, the full solve at 10x3x10;
  --phases              the 128^3 J2 + MG step's phase budget
                        (scripts/profile_newton_torch.py).

Every timing is a median of 3 samples, each recorded with its spread
(``timing_spreads``): kernels and other device-only work by CUDA events
over many calls, host-driven loops by the host clock around calls that
end in a synchronize.  Each bench function's peak device memory and its
K1, K1v1 and K2 launches are recorded.  The whole JSON goes to ``--out``
(default ``build/bench_torch.json``); the last line printed is the
headline with the file's path.  ``--device cpu`` is for the tests: the
bench runs on the card and falls back to nothing.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
from functools import partial

import torch

from macroc_tpu_torch.utils.profiling import Timings, device_description, load_script

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_GB_S = 3350.0  # the H100 SXM's published device-memory rate
# one node's SpMV: 243 stored coefficients and 3 x + 3 y values, 4 bytes each
F32_BYTES_PER_NODE = (27 * 9 + 6) * 4
# a hand SpMV variant's largest entry deviation from the plain version,
# relative to the plain y's largest entry
SPMV_RTOL = 1e-5
# K1's halo form (exchange + kernel) against K1 alone, on the card
HALO_RATIO_MAX = 2.0
MAT2 = dict(E=1.0e6, nu=0.3, Sy=1.0e4, Ka=1.0e7)  # bench.py's second phase
PRODUCTION_GPS = 38416  # 50x3x50 nodes: 49 * 2 * 49 elements * 8 GPs


def _timings(device, timings):
    return Timings(device) if timings is None else timings


def _randn(shape, seed, dtype, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)


def csr_from_soa(A):
    """The SoA stencil A (27,3,3,nx,ny,nz) as one CSR matrix over node-major
    dofs (row p*3+d, column q*3+e), out-of-grid neighbours dropped, int32
    indices: the input of the library SpMV that K1 is held against."""
    from macroc_tpu_torch.fem.kernels import STENCIL_OFFSETS

    nx, ny, nz = A.shape[-3:]
    n, dev = nx * ny * nz, A.device
    offs = torch.as_tensor(STENCIL_OFFSETS, device=dev)
    idx = [torch.arange(m, device=dev) for m in (nx, ny, nz)]
    valid = torch.ones((nx, ny, nz, 27), dtype=torch.bool, device=dev)
    for ax in range(3):
        shift = idx[ax].view([-1 if i == ax else 1 for i in range(3)] + [1]) + offs[:, ax]
        valid &= (shift >= 0) & (shift < (nx, ny, nz)[ax])
    # row (p, d) holds (o, e) in column order: o runs x slowest like q
    keep = valid[:, :, :, None, :, None].expand(nx, ny, nz, 3, 27, 3).reshape(-1)
    values = A.permute(3, 4, 5, 1, 0, 2).reshape(-1)[keep]
    lin = (offs[:, 0] * ny * nz + offs[:, 1] * nz + offs[:, 2]).to(torch.int32)
    q = torch.arange(n, device=dev, dtype=torch.int32).view(n, 1, 1, 1) + lin.view(1, 1, 27, 1)
    cols = (q * 3 + torch.arange(3, device=dev, dtype=torch.int32).view(1, 1, 1, 3))
    cols = cols.expand(n, 3, 27, 3).reshape(-1)[keep]
    counts = (valid.reshape(n, 27).sum(1, dtype=torch.int32) * 3).repeat_interleave(3)
    crow = torch.zeros(3 * n + 1, dtype=torch.int32, device=dev)
    crow[1:] = torch.cumsum(counts, 0, dtype=torch.int32)
    return torch.sparse_csr_tensor(crow, cols, values, size=(3 * n, 3 * n),
                                   check_invariants=False)


def one_rank_mesh(n, device):
    """A one-process ``RankMesh`` over an n^3 node grid: rank grid (1,1,1),
    a ``Comm`` of world size 1 (no process group)."""
    from macroc_tpu_torch.grid import StructuredGrid3D
    from macroc_tpu_torch.parallel.distributed import Comm
    from macroc_tpu_torch.parallel.mesh import RankMesh

    return RankMesh(StructuredGrid3D(n, n, n, n - 1.0, n - 1.0, n - 1.0), Comm(device))


def elastic_tangents(elem_shape, dtype, device):
    """The default material's elastic C at every GP of ``elem_shape``
    elements, materialised: K2 reads each element's 288 values in place
    and refuses a stride-0 broadcast."""
    from macroc_tpu_torch import MaterialParams
    from macroc_tpu_torch.constitutive.elastic import elastic_matrix

    C = torch.as_tensor(elastic_matrix(MaterialParams()), dtype=dtype, device=device)
    return C.expand(tuple(elem_shape) + (8, 6, 6)).contiguous()


def bench_spmv(n=128, dtype=torch.float32, device="cuda", timings=None):
    """SpMV variants on the assembled n^3 elastic stencil (K2 on the default
    material's C at every GP), x random from a seeded generator: a constant
    x is a rigid-body translation, in the operator's near-null space, so
    y ~ 0 and a change of f32 summation order reads as O(1) relative
    error.  Each hand variant is held to the plain version within
    SPMV_RTOL; on the card K1's halo form must stay within HALO_RATIO_MAX
    of K1.  The CSR SpMV is timed as the library yardstick and never takes
    part in ``variant``."""
    from macroc_tpu_torch.fem.element import b_matrix
    from macroc_tpu_torch.ops.assembly import assemble_stencil_soa_kernel
    from macroc_tpu_torch.ops.stencil_spmv import (
        V1_TILE,
        stencil_matvec,
        stencil_matvec_soa,
        stencil_matvec_v1,
    )
    from macroc_tpu_torch.parallel.halo import stencil_matvec_local

    t = _timings(device, timings)
    shape = (n, n, n)
    B = torch.as_tensor(b_matrix((1.0, 1.0, 1.0)), dtype=dtype, device=device)
    ctan = elastic_tangents((n - 1,) * 3, dtype, device)
    A = assemble_stencil_soa_kernel(ctan, B, 0.125, shape)
    del ctan
    x = _randn((3,) + shape, 7, dtype, device)
    mesh = one_rank_mesh(n, device)
    halo = "k1_halo_1x1x1"
    variants = {
        "plain_soa": stencil_matvec_soa,
        "k1": stencil_matvec,
        "k1v1_" + "x".join(map(str, V1_TILE)): stencil_matvec_v1,
        halo: partial(stencil_matvec_local, mesh=mesh),
    }
    y_ref = stencil_matvec_soa(A, x)
    scale = float(y_ref.abs().max())
    for name, mv in variants.items():
        err = float((mv(A, x) - y_ref).abs().max()) / scale
        if not err < SPMV_RTOL:
            raise AssertionError(f"{name} mismatch: rel err {err:.2e} (gate {SPMV_RTOL:g})")
    results = {name: t.loop(partial(mv, A, x), 50, label=f"spmv_{name}_{n}")
               for name, mv in variants.items()}
    A_csr = csr_from_soa(A)
    xv = x.permute(1, 2, 3, 0).reshape(-1)
    y_csr = torch.mv(A_csr, xv).view(shape + (3,)).permute(3, 0, 1, 2)
    err = float((y_csr - y_ref).abs().max()) / scale
    if not err < SPMV_RTOL:
        raise AssertionError(f"the CSR SpMV disagrees with the plain version: {err:.2e}")
    library_s = t.loop(partial(torch.mv, A_csr, xv), 50, label=f"spmv_csr_library_{n}")
    halo_ratio = results[halo] / results["k1"]
    if torch.device(device).type == "cuda" and halo_ratio > HALO_RATIO_MAX:
        raise AssertionError(f"K1's halo form regressed: {halo_ratio:.2f}x K1 "
                             f"(gate {HALO_RATIO_MAX}x)")
    best_name = min((k for k in results if k != halo), key=results.get)
    dt = results[best_name]
    nnodes = n ** 3
    return dict(
        variant=best_name,
        spmv_s=dt,
        all_variants={k: v * 1e3 for k, v in results.items()},
        nnz_per_s=nnodes * 243 / dt,
        eff_gb_s=nnodes * (27 * 9 + 6) * A.element_size() / dt / 1e9,
        n=n,
        library_ms={"csr_torch_sparse": library_s * 1e3},
        library_nnz=int(A_csr.values().numel()),
        halo_ratio=halo_ratio,
    )


def bench_newton_step(n=128, dtype="float32", pc_type="auto", device="cuda", timings=None):
    """Wall-clock of one Newton time step (one homogenize, residual, the
    stencil assembly, BC elimination, and CG run to convergence at the
    reference tolerances rtol 1e-5 / maxits 10000, src/init.c:147-157) on
    an n^3-node grid, each call from the same (u, state).  ``ksp_its`` <
    maxits shows the solve converged."""
    from macroc_tpu_torch import MacroConfig
    from macroc_tpu_torch.config import BC_BENDING
    from macroc_tpu_torch.problem import MacroProblem

    cfg = MacroConfig(
        nx=n, ny=n, nz=n, lx=4.0, ly=4.0, lz=4.0,
        bc_type=BC_BENDING, dtype=dtype, constitutive="j2",
        newton_max_its=1, ksp_maxits=10000, ksp_rtol=1e-5,
        pc_type=pc_type,
    )
    problem = MacroProblem(cfg, device)
    u, state = problem.init_fields()
    its = []

    def go():
        its.append(int(problem.time_step(u, state, -0.01)[2].ksp_its[0]))

    dt = _timings(device, timings).dispatch(go, label=f"newton_{pc_type}_{n}")
    if len(set(its)) != 1:
        raise AssertionError(f"newton/{pc_type}: KSP its differ between calls: {its}")
    return dict(newton_step_s=dt, ksp_its=its[0], n=n)


def _engine(micro_n, dtype, device, fastpath):
    from macroc_tpu_torch import MaterialParams
    from macroc_tpu_torch.config import MIC_LAYER_Y
    from macroc_tpu_torch.constitutive.microfe import MicroFEEngine

    return MicroFEEngine(n=micro_n, micro_type=MIC_LAYER_Y, mat1=MaterialParams(),
                         mat2=MaterialParams(**MAT2), dtype=dtype, device=device,
                         elastic_fastpath=fastpath)


def bench_microfe(n_gps=256, micro_n=10, dtype=torch.float32, fastpath=False, n_lo=2,
                  n_hi=6, device="cuda", timings=None):
    """Micro-FE homogenize rate (GP/s) at the production RVE (micro_n=10,
    scripts/launch_jobs.sh:13-20 of the reference) for a two-phase RVE
    batch: each GP a full nonlinear RVE solve plus 6 tangent solves
    (``fastpath=False``), or the pristine-state elastic superposition
    (``fastpath=True``).  Up to 8192 full-solve GPs a sample is ``n_hi -
    n_lo`` homogenizes; above, one homogenize, after a warm-up on the first
    2048 GPs of the same engine (a full homogenize of the production
    population takes half a minute)."""
    t = _timings(device, timings)
    eng = _engine(micro_n, dtype, device, fastpath)
    eps = _randn((n_gps, 6), 3, dtype, device) * 1e-4
    state = eng.init_state((n_gps,))

    def go():
        eng.homogenize(eps, state)

    label = f"microfe_{n_gps}_fp{int(fastpath)}"
    if n_gps * (0 if fastpath else 1) > 8192:
        w = min(n_gps, 2048)
        dt = t.dispatch(go, label=label,
                        warm=lambda: eng.homogenize(eps[:w], eng.init_state((w,))))
    else:
        dt = t.dispatch(go, label=label, calls=n_hi - n_lo)
    return dict(gp_per_s=n_gps / dt, n_gps=n_gps, micro_n=micro_n, fastpath=fastpath)


def bench_microfe_partial(n_gps=2048, frac=0.1, micro_n=10, dtype=torch.float32,
                          device="cuda", timings=None):
    """Homogenize rate with localized plasticity: every round(1/frac)-th GP
    driven 600x past the random draw (far past the soft phase's yield), the
    rest elastic, on the fast path, so only the driven GPs run the full
    solve.  ``n_active`` counts the GPs the homogenize flags non-linear."""
    t = _timings(device, timings)
    eng = _engine(micro_n, dtype, device, True)
    eps = _randn((n_gps, 6), 3, dtype, device) * 1e-4
    stride = max(1, int(round(1.0 / frac)))
    eps[::stride] *= 600.0
    state = eng.init_state((n_gps,))
    dt = t.dispatch(lambda: eng.homogenize(eps, state), label=f"microfe_partial_{n_gps}")
    n_active = int(eng.homogenize(eps, state).non_linear.sum())
    return dict(gp_per_s=n_gps / dt, n_gps=n_gps, n_active=n_active, frac=frac,
                micro_n=micro_n)


def bench_assembly_shmap(dtype=torch.float32, device="cuda", timings=None,
                         shard=(64, 32, 127), n=128):
    """K2 on the elastic tangents, two ways:

    (a) at the 8-way 128^3 rank block: the (2,4,1) split gives each rank a
        (64,32,128) node block, whose element slots assemble onto one more
        node plane on each split axis — ``shard`` elements onto (65,33,128)
        nodes;
    (b) the rank assembly wrapper (``parallel/halo.py``
        ``assemble_stencil_local``, on a one-process (1,1,1) mesh, from a
        node-shaped tangent block) against K2 alone on the n^3 grid's
        contiguous tangents."""
    from macroc_tpu_torch.fem.element import b_matrix
    from macroc_tpu_torch.ops.assembly import assemble_stencil_soa_kernel, b_dsh
    from macroc_tpu_torch.parallel.halo import assemble_stencil_local

    t = _timings(device, timings)
    B = torch.as_tensor(b_matrix((1.0, 1.0, 1.0)), dtype=dtype, device=device)
    asm = partial(assemble_stencil_soa_kernel, dsh=b_dsh(B))
    out = {}
    ct = elastic_tangents(shard, dtype, device)
    grid = tuple(e + 1 for e in shard)
    out["assembly_shard_8way_ms"] = 1e3 * t.loop(
        lambda: asm(ct, B, 0.125, grid), 10, label="assembly_shard_8way")
    del ct
    ct = elastic_tangents((n - 1,) * 3, dtype, device)
    out["assembly_raw_ms"] = 1e3 * t.loop(
        lambda: asm(ct, B, 0.125, (n,) * 3), 10, label=f"assembly_raw_{n}")
    ct_node = torch.zeros((n,) * 3 + (8, 6, 6), dtype=dtype, device=device)
    ct_node[:-1, :-1, :-1] = ct
    del ct
    mesh = one_rank_mesh(n, device)
    out["assembly_shmap_1x1x1_ms"] = 1e3 * t.loop(
        lambda: assemble_stencil_local(ct_node, B, 0.125, mesh, asm), 10,
        label="assembly_shmap_1x1x1")
    return out


def bench_fe2_step(nx=50, ny=3, nz=50, micro_n=10, dtype="float32", fastpath=True,
                   device="cuda", timings=None):
    """Wall-clock of one FE² Newton step on the production configuration's
    shape (50x3x50 pancake grid, micro_n=10, a second micro phase;
    scripts/launch_jobs.sh:13-58 of the reference): every macro GP runs the
    micro-FE engine, each call from the same (u, state)."""
    from macroc_tpu_torch import MacroConfig, MaterialParams
    from macroc_tpu_torch.config import BC_BENDING, MIC_LAYER_Y
    from macroc_tpu_torch.problem import MacroProblem

    cfg = MacroConfig(
        nx=nx, ny=ny, nz=nz, lx=10.0, ly=1.0, lz=10.0,
        bc_type=BC_BENDING, dtype=dtype, constitutive="microfe",
        micro_n=micro_n, micro_type=MIC_LAYER_Y, micro_mat_2=MaterialParams(**MAT2),
        micro_elastic_fastpath=fastpath,
        newton_max_its=1, ksp_maxits=10000, ksp_rtol=1e-5,
    )
    problem = MacroProblem(cfg, device)
    u, state = problem.init_fields()
    U = cfg.displacement(1)
    its = []

    def go():
        its.append(int(problem.time_step(u, state, U)[2].ksp_its[0]))

    dt = _timings(device, timings).dispatch(
        go, label=f"fe2_{nx}x{ny}x{nz}_fp{int(fastpath)}")
    if len(set(its)) != 1:
        raise AssertionError(f"fe2 {nx}x{ny}x{nz}: KSP its differ between calls: {its}")
    n_gps = (nx - 1) * (ny - 1) * (nz - 1) * 8
    return dict(fe2_step_s=dt, ksp_its=its[0], n_gps=n_gps, grid=(nx, ny, nz),
                micro_n=micro_n, fastpath=fastpath)


def measured(device, record, name, fn):
    """``fn()`` with the K1, K1v1 and K2 launch counters set to 0 before it
    and the peak device memory reset; both are read after it into
    ``record``, and the memory its tensors held is freed."""
    from macroc_tpu_torch.ops.assembly import assemble_stencil_soa_kernel as k2
    from macroc_tpu_torch.ops.stencil_spmv import stencil_matvec as k1, stencil_matvec_v1 as k1v1

    cuda = device.type == "cuda"
    k1.launches = k1v1.launches = k2.launches = 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    out = fn()
    gc.collect()
    if cuda:
        record["peak_gib"][name] = torch.cuda.max_memory_allocated(device) / 2**30
        torch.cuda.empty_cache()
    record["launches"][name] = dict(K1=k1.launches, K1v1=k1v1.launches, K2=k2.launches)
    print(f"[bench] {name}: {json.dumps(out)}", flush=True)
    return out


def main(argv=None, quick=False):
    """Run every bench function on ``--device`` (the card by default) and
    return the result; with ``quick`` (the smoke run) each timing is one
    sample and the micro-FE production rows run at 2048 GPs."""
    from macroc_tpu_torch.utils.runtime import setup_runtime

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (tests only)")
    ap.add_argument("--phases", action="store_true",
                    help="add the 128^3 phase budget (scripts/profile_newton_torch.py)")
    ap.add_argument("--out", default=os.path.join(REPO, "build", "bench_torch.json"))
    args = ap.parse_args(argv)
    setup_runtime()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_torch: no CUDA device (--device cpu is for the tests)")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    t = Timings(device, reps=1 if quick else 3)
    prod_gps = 2048 if quick else PRODUCTION_GPS
    record = dict(peak_gib={}, launches={})
    run = partial(measured, device, record)
    common = dict(device=device, timings=t)

    spmv = run("spmv", lambda: bench_spmv(n=128, **common))
    newton_mg = run("newton_mg", lambda: bench_newton_step(n=128, pc_type="mg", **common))
    newton_jac = run("newton_jacobi",
                     lambda: bench_newton_step(n=128, pc_type="jacobi", **common))
    for nm, r in (("mg", newton_mg), ("jacobi", newton_jac)):
        if not r["ksp_its"] < 10000:
            raise AssertionError(f"newton/{nm} CG did NOT converge")
    microfe = run("microfe", lambda: bench_microfe(**common))
    micro_prod = run("microfe_production",
                     lambda: bench_microfe(n_gps=prod_gps, fastpath=False, **common))
    micro_fast = run("microfe_fastpath_production",
                     lambda: bench_microfe(n_gps=prod_gps, fastpath=True, n_lo=1, n_hi=3,
                                           **common))
    micro_part = run("microfe_partial",
                     lambda: bench_microfe_partial(n_gps=2048, frac=0.1, **common))
    asm = run("assembly_shmap", lambda: bench_assembly_shmap(**common))
    fe2_fast = run("fe2_fastpath",
                   lambda: bench_fe2_step(nx=50, ny=3, nz=50, fastpath=True, **common))
    fe2_full = run("fe2_full",
                   lambda: bench_fe2_step(nx=10, ny=3, nz=10, fastpath=False, **common))
    for nm, r in (("fe2_fastpath", fe2_fast), ("fe2_full", fe2_full)):
        if not r["ksp_its"] < 10000:
            raise AssertionError(f"{nm} CG did NOT converge")
    phases = None
    if args.phases:
        profile = load_script("profile_newton_torch")
        phases = run("phases_128cubed", lambda: profile.main(n=128, device=device, timings=t))

    roofline = HBM_GB_S * 1e9 / F32_BYTES_PER_NODE * 243
    extras = {
        "variant": spmv["variant"],
        "all_variants_ms": spmv["all_variants"],
        "spmv_ms": spmv["spmv_s"] * 1e3,
        "spmv_eff_gb_s": spmv["eff_gb_s"],
        "spmv_library_ms": spmv["library_ms"],
        "spmv_library_nnz": spmv["library_nnz"],
        "spmv_halo_ratio": spmv["halo_ratio"],
        "grid": spmv["n"],
        "newton_step_s_128cubed": newton_mg["newton_step_s"],
        "newton_ksp_its": newton_mg["ksp_its"],
        "newton_jacobi_s_128cubed": newton_jac["newton_step_s"],
        "newton_jacobi_ksp_its": newton_jac["ksp_its"],
        "ksp_rtol": 1e-5,
        "ksp_maxits": 10000,
        "microfe_gp_per_s": microfe["gp_per_s"],
        "microfe_n_gps": microfe["n_gps"],
        "microfe_micro_n": microfe["micro_n"],
        "microfe_gp_per_s_production": micro_prod["gp_per_s"],
        "microfe_production_n_gps": micro_prod["n_gps"],
        "microfe_fastpath_gp_per_s_production": micro_fast["gp_per_s"],
        "microfe_fastpath_production_n_gps": micro_fast["n_gps"],
        "microfe_partial_gp_per_s": micro_part["gp_per_s"],
        "microfe_partial_n_active": micro_part["n_active"],
        "microfe_partial_n_gps": micro_part["n_gps"],
        "assembly_shard_8way_ms": asm["assembly_shard_8way_ms"],
        "assembly_shmap_1x1x1_ms": asm["assembly_shmap_1x1x1_ms"],
        "assembly_raw_128_ms": asm["assembly_raw_ms"],
        "timing_spreads": t.spreads,
        "fe2_production_step_s_fastpath": fe2_fast["fe2_step_s"],
        "fe2_fastpath_grid": list(fe2_fast["grid"]),
        "fe2_fastpath_n_gps": fe2_fast["n_gps"],
        "fe2_fastpath_ksp_its": fe2_fast["ksp_its"],
        "fe2_full_step_s": fe2_full["fe2_step_s"],
        "fe2_full_grid": list(fe2_full["grid"]),
        "fe2_full_n_gps": fe2_full["n_gps"],
        "fe2_full_ksp_its": fe2_full["ksp_its"],
        "roofline_nnz_per_s": roofline,
        "device": device_description(device),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "reps": t.reps,
        "peak_gib": record["peak_gib"],
        "launches": record["launches"],
    }
    if phases is not None:
        extras["phases_128cubed"] = phases
    result = {
        "metric": "bsr27_spmv_nnz_per_s",
        "value": spmv["nnz_per_s"],
        "unit": "nnz/s",
        "vs_baseline": spmv["nnz_per_s"] / roofline,
        "extras": extras,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: result[k] for k in ("metric", "value", "unit", "vs_baseline")}
                     | {"device": extras["device"], "out": os.path.abspath(args.out)}),
          flush=True)
    return result


if __name__ == "__main__":
    main()
