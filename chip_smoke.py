#!/usr/bin/env python3
"""Smoke run of macroc_tpu_torch on one CUDA GPU:  python3 chip_smoke.py

Phases (each prints its lines; any failure raises and the script exits
non-zero without the result line):

  1. build   — compile the CUDA kernels from macroc_tpu_torch/csrc, one
               nvcc per source, all started together;
  2. K1      — stencil SpMV kernel vs its plain version on numpy-seeded
               random A and x, f32 and f64, with and without the halo
               form, at (64,64,64), (33,17,45) and every node shape at
               which the driven paths launch it (each MG level of the
               128^3 and 50x3x50 grids, the 10x3x10 grid); then timed at
               the 128^3 fine-level shape of the main path;
  3. K1v1    — the shared-memory-tile SpMV kernel vs the plain version at
               the same shapes and types with two tiles, one ragged; then
               the SpMV variant sweep (the JAX bench's bench_spmv): K1v1,
               K1 and the plain version timed on the 128^3 assembled
               elastic stencil;
  4. K2      — assembly combine kernel vs its plain versions at (32,32,32)
               and (20,9,27) elements and at the element shapes of the
               same path levels, f32 and f64; then timed at 127^3
               elements;
  5. goldens — the four J2 CG goldens and the FE² golden
               (tests/goldens/*.json) at f64 through the kernels;
  6. main    — ``macroc_tpu_torch.cli`` on the 128^3 J2 + MG bending case,
               3 time steps in f32, with the kernels' launch counters read
               around it;
  7. microfe — the micro-FE engine at the production RVE (micro_n=10,
               two-phase layers, f32) on 2048 GPs, every 10th driven past
               yield: elastic fast path on and off, flags and agreement;
  8. fe2     — ``macroc_tpu_torch.cli`` on FE² launch lines, with the
               kernels' launch counters read around each: the production
               shape of scripts/production_run.sh (50x3x50 nodes, lx=lz=50,
               circle BC, dt 1e-3, micro_n=10, fast path); the 50x3x50
               bending line at lx=lz=10; the 10x3x10 full-solve line; and
               the 50x3x50 bending grid loaded until micro GPs yield.

The second-to-last line is the per-kernel JSON record, the last line
{"ok": true, "device": {...}}.  Without a CUDA device the script exits 1
before doing anything.  ``--only PHASE[,PHASE]`` (a development aid) runs
a subset, build always included, prints "[partial] ..." instead of the
result lines and exits 4.
"""

import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(REPO, "tests", "goldens")
TOLS = {torch.float32: 1e-5, torch.float64: 1e-12}

# the two-phase micro-FE material of BASELINE.md's production-shaped
# micro-FE record
MICRO = ["-micro_n", "10", "-micro_type", "1", "-micro_mat_2", "1e6,0.3,1e4,1e7",
         "-dtype", "float32", "-log_phases"]
FE2_FLAGS = ["-lx", "10", "-ly", "1", "-lz", "10", "-bc_type", "0"] + MICRO
GRID_50 = ["-da_grid_x", "50", "-da_grid_y", "3", "-da_grid_z", "50"]
GRID_10 = ["-da_grid_x", "10", "-da_grid_y", "3", "-da_grid_z", "10"]
# scripts/production_run.sh's shape (the reference's launch_jobs.sh), 3 of
# its 10,000 steps, without its checkpoints
FE2_PRODUCTION = GRID_50 + [
    "-lx", "50", "-ly", "1", "-lz", "50", "-ts", "3", "-dt", "0.001",
    "-bc_type", "1", "-newton_max_its", "4",
] + MICRO
# the 50x3x50 bending line at lx=lz=10, 2 steps (elastic at the default dt)
FE2_BENDING = GRID_50 + FE2_FLAGS + ["-ts", "2"]
# the JAX bench's fe2_full shape: the full micro solve at every GP
FE2_FULL = GRID_10 + FE2_FLAGS + ["-ts", "2", "-micro_elastic_fastpath", "0"]
# the bending line loaded 250x faster, so ~8% of the micro GPs yield in
# step 2 (U = -0.5: the reference's unit-spacing B quirk makes the 50x3x50
# strains 5x smaller than the 10x3x10 ones at the same U): the screen and
# the compacted full solves at scale, with a trial state per homogenize;
# step 3 screens incrementally against that committed plastic state
FE2_PLASTIC = GRID_50 + FE2_FLAGS + ["-ts", "4", "-dt", "0.25"]
# f32 agreement of the micro-FE fast path with the full solve (normwise,
# relative to the largest entry): both routes stop at CG tolerances of 1e-8
# (equilibrium, elastic basis) and 1e-6 (tangent columns) relative, which
# f32 reaches to its roundoff times the RVE operator's conditioning; the
# driven GPs run the same full solve in other batch compositions
MICROFE_TOL = dict(stress=1e-5, ctan=1e-5)

# fine node grids of the driven paths: with an MG hierarchy (128^3 J2,
# 50x3x50 FE²), and with Jacobi PCG on one level (10x3x10 FE²)
MG_GRIDS = [(128, 128, 128), (50, 3, 50)]
JACOBI_GRID = (10, 3, 10)

MAIN_FLAGS = [
    "-da_grid_x", "128", "-da_grid_y", "128", "-da_grid_z", "128",
    "-lx", "4", "-ly", "4", "-lz", "4", "-bc_type", "0",
    "-constitutive", "j2", "-pc_type", "mg", "-dtype", "float32",
    "-ts", "3", "-log_phases",
]


def log(msg):
    print(msg, flush=True)


def rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max())


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def randn(rng, shape, dtype, device):
    npdt = np.float32 if dtype == torch.float32 else np.float64
    return torch.as_tensor(rng.standard_normal(shape, dtype=npdt), device=device)


def time_ms(fn, reps):
    """Mean device milliseconds per call over ``reps`` calls (CUDA events,
    after one warm-up call)."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_build():
    from macroc_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    log(f"[build] {os.path.relpath(path, REPO)} built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")


def path_node_shapes(dev):
    """Node shapes at which the driven paths launch K1 and K2: every level
    of the MG hierarchy that ``build_hierarchy`` builds on the 128^3 grid
    (J2 main path) and on the 50x3x50 grid (FE² lines), and the 10x3x10
    grid (FE² full-solve line, Jacobi PCG on one level)."""
    from macroc_tpu_torch import MaterialParams
    from macroc_tpu_torch.constitutive.elastic import elastic_matrix
    from macroc_tpu_torch.ops.assembly import assemble_stencil_soa_kernel
    from macroc_tpu_torch.solve.mg import build_hierarchy

    C = torch.as_tensor(elastic_matrix(MaterialParams()), dtype=torch.float32, device=dev)
    shapes = []
    for fine in MG_GRIDS:
        ctan = C.expand(tuple(n - 1 for n in fine) + (8, 6, 6)).contiguous()
        mask = torch.zeros((3,) + fine, dtype=torch.bool, device=dev)
        levels = build_hierarchy(ctan, mask, (1.0, 1.0, 1.0), True,
                                 assemble_fn=assemble_stencil_soa_kernel)
        shapes += [tuple(lv.A_soa.shape[-3:]) for lv in levels]
        del ctan, levels
    return list(dict.fromkeys(shapes + [JACOBI_GRID]))


def phase_k1(dev, path_shapes):
    from macroc_tpu_torch.ops.stencil_spmv import stencil_matvec, stencil_matvec_soa

    rng = np.random.default_rng(1)
    # the 128^3 fine level is checked (f32) and timed below
    shapes = [(64, 64, 64), (33, 17, 45)] + [s for s in path_shapes if s != (128, 128, 128)]
    for shape in shapes:
        errs = []
        for dtype, tol in TOLS.items():
            for halo in (False, True):
                A = randn(rng, (27, 3, 3) + shape, dtype, dev)
                xs = tuple(n + 2 for n in shape) if halo else shape
                x = randn(rng, (3,) + xs, dtype, dev)
                err = rel_err(stencil_matvec(A, x, halo=halo),
                              stencil_matvec_soa(A, x, halo=halo))
                errs.append(f"{str(dtype)[6:]}{' halo' if halo else ''} {err:.3e}")
                check(err < tol, f"K1 disagrees with its plain version at {shape} "
                      f"{dtype} halo={halo}: {err:.3e}")
        log(f"[K1] {shape}: max rel err " + ", ".join(errs)
            + f" (bounds {TOLS[torch.float32]:g}, {TOLS[torch.float64]:g})")
    # the 128^3 fine level of the main path, f32
    shape = (128, 128, 128)
    A = randn(rng, (27, 3, 3) + shape, torch.float32, dev)
    x = randn(rng, (3,) + shape, torch.float32, dev)
    y = stencil_matvec(A, x)
    y_ref = stencil_matvec_soa(A, x)
    err = rel_err(y, y_ref)
    check(err < TOLS[torch.float32], "K1 disagrees at 128^3")
    ms = time_ms(lambda: stencil_matvec(A, x), 50)
    plain_ms = time_ms(lambda: stencil_matvec_soa(A, x), 5)
    nnz = 243 * math.prod(shape)
    log(f"[K1] 128^3 f32: max abs err {float((y - y_ref).abs().max()):.3e}, rel "
        f"{err:.3e}; kernel {ms:.4f} ms ({nnz / ms / 1e6:.2f} Gnnz/s, "
        f"{(243 + 6) * 4 * math.prod(shape) / ms / 1e6:.1f} GB/s), plain {plain_ms:.4f} ms")
    return dict(max_abs_err=float((y - y_ref).abs().max()), ms=ms, plain_ms=plain_ms)


def phase_k1v1(dev):
    from macroc_tpu_torch.fem.element import b_matrix
    from macroc_tpu_torch.constitutive.elastic import elastic_matrix
    from macroc_tpu_torch.ops.assembly import assemble_stencil_soa_kernel
    from macroc_tpu_torch.ops.stencil_spmv import (
        V1_TILE,
        stencil_matvec,
        stencil_matvec_soa,
        stencil_matvec_v1,
    )
    from macroc_tpu_torch import MaterialParams

    rng = np.random.default_rng(7)
    for shape in [(64, 64, 64), (33, 17, 45)]:
        for dtype, tol in TOLS.items():
            A = randn(rng, (27, 3, 3) + shape, dtype, dev)
            x = randn(rng, (3,) + shape, dtype, dev)
            y_ref = stencil_matvec_soa(A, x)
            # (3,5,16) leaves ragged tiles on every axis of both shapes
            for tile in (V1_TILE, (3, 5, 16)):
                err = rel_err(stencil_matvec_v1(A, x, tile=tile), y_ref)
                log(f"[K1v1] {shape} {str(dtype)[6:]} tile {tile}: max rel err "
                    f"{err:.3e} (bound {tol:g})")
                check(err < tol, "K1v1 disagrees with its plain version")
    # the JAX bench's SpMV sweep operator: the assembled elastic stencil
    # at 128^3, f32, and a random (never constant) x
    n = 128
    shape = (n, n, n)
    B = torch.as_tensor(b_matrix((1.0, 1.0, 1.0)), dtype=torch.float32, device=dev)
    C = torch.as_tensor(elastic_matrix(MaterialParams()), dtype=torch.float32, device=dev)
    ctan = C.expand((n - 1,) * 3 + (8, 6, 6)).contiguous()
    A = assemble_stencil_soa_kernel(ctan, B, 0.125, shape)
    del ctan
    x = randn(rng, (3,) + shape, torch.float32, dev)
    y = stencil_matvec_v1(A, x)
    y_ref = stencil_matvec_soa(A, x)
    err = rel_err(y, y_ref)
    abs_err = float((y - y_ref).abs().max())
    check(err < TOLS[torch.float32], "K1v1 disagrees at 128^3")
    nnodes = n ** 3
    stencil_matvec_v1.launches = 0
    ms = {
        "K1v1": time_ms(lambda: stencil_matvec_v1(A, x), 50),
        "K1": time_ms(lambda: stencil_matvec(A, x), 50),
        "plain": time_ms(lambda: stencil_matvec_soa(A, x), 5),
    }
    launches = stencil_matvec_v1.launches
    rates = ", ".join(
        f"{k} {v:.4f} ms ({243 * nnodes / v / 1e6:.2f} Gnnz/s, "
        f"{(243 + 6) * 4 * nnodes / v / 1e6:.1f} GB/s)" for k, v in ms.items())
    log(f"[K1v1] 128^3 f32 elastic stencil: max abs err {abs_err:.3e}, rel {err:.3e}; "
        f"{rates}; K1v1 launches in the sweep {launches}")
    check(launches > 0, "K1v1 never launched in the sweep")
    return dict(max_abs_err=abs_err, ms=ms["K1v1"], plain_ms=ms["plain"],
                k1_ms=ms["K1"]), launches


def phase_k2(dev, path_shapes):
    from macroc_tpu_torch.fem.element import b_matrix
    from macroc_tpu_torch.fem.kernels import assemble_stencil_soa
    from macroc_tpu_torch.ops import assembly as asm

    rng = np.random.default_rng(2)
    # element shapes; the 127^3 fine level is checked (f32) and timed below
    elems = [(32, 32, 32), (20, 9, 27)] + [
        tuple(n - 1 for n in s) for s in path_shapes if s != (128, 128, 128)]
    for ne in elems:
        shape = tuple(n + 1 for n in ne)
        for dtype, tol in TOLS.items():
            B = torch.as_tensor(b_matrix((1.0, 1.0, 1.0)), dtype=dtype, device=dev)
            ct = randn(rng, ne + (8, 6, 6), dtype, dev)
            Ke = asm.element_stiffness_cm(ct, B, 0.1)
            same = torch.equal(asm.combine_cuda(Ke, shape), asm.combine_plain(Ke, shape))
            err = rel_err(asm.assemble_stencil_soa_kernel(ct, B, 0.1, shape),
                          assemble_stencil_soa(ct, B, 0.1, shape))
            log(f"[K2] {ne} elements {str(dtype)[6:]}: combine bitwise equal to plain "
                f"{same}; assembly max rel err vs slab {err:.3e} (bound {tol:g})")
            check(same and err < tol, f"K2 disagrees with its plain versions at {ne} {dtype}")
    # the 128^3 main path: 127^3 elements, f32
    ne, shape = (127, 127, 127), (128, 128, 128)
    B = torch.as_tensor(b_matrix((1.0, 1.0, 1.0)), dtype=torch.float32, device=dev)
    ct = randn(rng, ne + (8, 6, 6), torch.float32, dev)
    Ke = asm.element_stiffness_cm(ct, B, 0.1)
    A = asm.combine_cuda(Ke, shape)
    A_ref = asm.combine_plain(Ke, shape)
    abs_err = float((A - A_ref).abs().max())
    check(abs_err == 0.0, "K2 combine differs from its plain version at 128^3")
    del A, A_ref
    ms = time_ms(lambda: asm.combine_cuda(Ke, shape), 20)
    plain_ms = time_ms(lambda: asm.combine_plain(Ke, shape), 3)
    del Ke
    stage1_ms = time_ms(lambda: asm.element_stiffness_cm(ct, B, 0.1), 5)
    full_ms = time_ms(lambda: asm.assemble_stencil_soa_kernel(ct, B, 0.1, shape), 5)
    slab_ms = time_ms(lambda: assemble_stencil_soa(ct, B, 0.1, shape), 2)
    err = rel_err(asm.assemble_stencil_soa_kernel(ct, B, 0.1, shape),
                  assemble_stencil_soa(ct, B, 0.1, shape))
    check(err < TOLS[torch.float32], "K2 assembly disagrees with the slab form at 128^3")
    bytes_ = (576 * math.prod(ne) + 243 * math.prod(shape)) * 4
    log(f"[K2] 127^3 elements f32: combine max abs err {abs_err:.3e}; combine kernel "
        f"{ms:.4f} ms ({bytes_ / ms / 1e6:.1f} GB/s), plain combine {plain_ms:.4f} ms; "
        f"stage-1 matmul {stage1_ms:.4f} ms; whole assembly {full_ms:.4f} ms vs slab "
        f"{slab_ms:.4f} ms (max rel err {err:.3e})")
    return dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms)


def golden_configs():
    from macroc_tpu_torch import MacroConfig, MaterialParams

    # tests/make_goldens.py CONFIGS (the CG entries)
    return {
        "bending_elastic_5x3x3": MacroConfig(
            nx=5, ny=3, nz=3, lx=4.0, ly=2.0, lz=2.0, bc_type=0, ts=5,
            dtype="float64"),
        "bending_plastic_5x3x3": MacroConfig(
            nx=5, ny=3, nz=3, lx=4.0, ly=2.0, lz=2.0, bc_type=0, ts=4,
            dt=0.15, newton_max_its=10, dtype="float64"),
        "circle_elastic_9x3x9": MacroConfig(
            nx=9, ny=3, nz=9, lx=10.0, ly=1.0, lz=10.0, bc_type=1, rad=2.0,
            ts=4, dt=0.05, dtype="float64"),
        "default_grid_smoke": MacroConfig(ts=2, dtype="float64"),
        "hetero_micro_fe2_3x2x2": MacroConfig(
            nx=3, ny=2, nz=2, lx=2.0, ly=1.0, lz=1.0, bc_type=0, ts=2, dt=0.1,
            newton_max_its=5, micro_n=4, micro_type=1,
            micro_mat_2=MaterialParams(E=1.0e6, nu=0.3, Sy=5.0e3, Ka=2.0e6),
            dtype="float64"),
    }


def golden_failures(name, got, golden):
    """Mismatches against a golden, with tests/test_torch_golden.py's
    criteria: test_golden.py's tolerances for the goldens that are robust
    to summation order, the roundoff bounds for the two that pin last bits
    (circle_elastic_9x3x9, bending_plastic_5x3x3)."""
    exact = name not in ("circle_elastic_9x3x9", "bending_plastic_5x3x3")
    bad = []
    if len(got["steps"]) != len(golden["steps"]):
        return ["step count"]
    for gs, es in zip(got["steps"], golden["steps"]):
        t = es["ts"]
        if gs["nl_gps"] != es["nl_gps"] or gs["converged"] != es["converged"]:
            bad.append(f"ts {t}: nl_gps/converged")
        if exact:
            if gs["ksp_its"] != es["ksp_its"]:
                bad.append(f"ts {t}: KSP its {gs['ksp_its']} != {es['ksp_its']}")
            if not np.allclose(gs["res_norms"], es["res_norms"], rtol=1e-8):
                bad.append(f"ts {t}: |RES| trace")
            rt = 1e-8
        else:
            if len(gs["ksp_its"]) != len(es["ksp_its"]):
                bad.append(f"ts {t}: solves")
            if any(abs(a - b) > 6 for a, b in zip(gs["ksp_its"], es["ksp_its"])):
                bad.append(f"ts {t}: KSP its {gs['ksp_its']} vs {es['ksp_its']}")
            if not np.isclose(gs["res_norms"][0], es["res_norms"][0], rtol=1e-7, atol=1e-12):
                bad.append(f"ts {t}: first |RES|")
            rt = 1e-5
        for k in ("force", "f_trial_max"):
            if not np.isclose(gs[k], es[k], rtol=rt, atol=1e-12):
                bad.append(f"ts {t}: {k}")
    for k in ("u_norm", "u_min", "u_max"):
        if not np.isclose(got[k], golden[k], rtol=1e-8 if exact else 1e-6, atol=1e-15):
            bad.append(k)
    return bad


def phase_goldens(dev):
    from macroc_tpu_torch.problem import run_summary

    for name, cfg in golden_configs().items():
        with open(os.path.join(GOLDEN_DIR, f"{name}.json")) as f:
            golden = json.load(f)
        t0 = time.perf_counter()
        got = run_summary(cfg, dev)
        res_dev = max(
            float(np.max(np.abs(np.subtract(gs["res_norms"], es["res_norms"]))
                         / np.maximum(np.abs(es["res_norms"]), 1e-300)))
            for gs, es in zip(got["steps"], golden["steps"])
        )
        bad = golden_failures(name, got, golden)
        log(f"[golden] {name}: {'PASS' if not bad else 'FAIL'} in "
            f"{time.perf_counter() - t0:.2f} s; KSP its "
            f"{[s['ksp_its'] for s in got['steps']]} (golden "
            f"{[s['ksp_its'] for s in golden['steps']]}); max |RES| rel dev {res_dev:.2e}"
            + (f"; {bad}" if bad else ""))
        check(not bad, f"golden {name}")


def drive_cli(tag, flags):
    """``macroc_tpu_torch.cli`` on ``flags`` with the K1/K2 launch counters
    set to 0 just before and read just after; checks every step converged
    with finite diagnostics.  Returns (result, launches)."""
    from macroc_tpu_torch import cli
    from macroc_tpu_torch.ops.assembly import assemble_stencil_soa_kernel
    from macroc_tpu_torch.ops.stencil_spmv import stencil_matvec

    log(f"[{tag}] python -m macroc_tpu_torch " + " ".join(flags))
    with tempfile.TemporaryDirectory() as out_dir:
        argv = flags + ["-output_dir", out_dir]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        stencil_matvec.launches = 0
        assemble_stencil_soa_kernel.launches = 0
        result = cli.run(argv)
        launches = dict(K1=stencil_matvec.launches,
                        K2=assemble_stencil_soa_kernel.launches)
    peak = torch.cuda.max_memory_allocated()
    maxits = cli.parse_cli(argv).ksp_maxits
    for h in result["history"]:
        log(f"[{tag}] step {h['ts']}: {h['seconds']:.4f} s, {len(h['res_norms'])} "
            f"homogenize / {len(h['ksp_its'])} solves, KSP its {h['ksp_its']}, "
            f"converged {h['converged']}, nl_gps {h['nl_gps']}, |RES| {h['res_norms']}")
        check(h["converged"], f"{tag} step {h['ts']} did not converge")
        check(all(k < maxits for k in h["ksp_its"]), f"{tag} step {h['ts']}: KSP hit maxits")
        check(all(math.isfinite(v) for v in h["res_norms"] + [h["force"], h["f_trial_max"]]),
              f"{tag} step {h['ts']}: non-finite diagnostics")
    check(bool(torch.isfinite(result["u"]).all()), f"{tag}: non-finite displacement")
    check(bool(torch.isfinite(result["state"].eps_p).all()), f"{tag}: non-finite plastic strain")
    log(f"[{tag}] launches during the run: K1 {launches['K1']}, K2 {launches['K2']}; "
        f"peak device memory {peak / 2**30:.2f} GiB ({base / 2**30:.2f} GiB held "
        f"before the run); phases (s) "
        + json.dumps({k: round(v, 4) for k, v in result["phases"].items()}))
    check(launches["K1"] > 0 and launches["K2"] > 0, f"{tag}: a kernel of the path never launched")
    return result, launches


def phase_main(dev):
    return drive_cli("main", MAIN_FLAGS)[1]


def phase_microfe(dev):
    """The engine at the production RVE on 2048 GPs, every 10th driven far
    past the soft phase's yield (the JAX bench's bench_microfe_partial);
    then each route's committed state unloaded by 5%, which the fast path
    screens incrementally against the committed plastic state."""
    from macroc_tpu_torch import MaterialParams
    from macroc_tpu_torch.constitutive.microfe import MicroFEEngine

    n_gps = 2048
    rng = np.random.default_rng(3)
    eps_np = rng.standard_normal((n_gps, 6)).astype(np.float32) * 1e-4
    driven = np.arange(0, n_gps, 10)
    eps_np[driven] *= 600.0
    eps = torch.as_tensor(eps_np, device=dev)
    out = {True: [], False: []}
    for fast in (True, False):
        eng = MicroFEEngine(
            n=10, micro_type=1, mat1=MaterialParams(),
            mat2=MaterialParams(E=1.0e6, nu=0.3, Sy=1.0e4, Ka=1.0e7),
            dtype=torch.float32, device=dev, elastic_fastpath=fast,
        )
        t0 = time.perf_counter()
        eng._elastic_dense_inv()
        t_inv = time.perf_counter() - t0
        eng.homogenize(eps[:8], eng.init_state((8,)))  # warm-up, basis
        state = eng.init_state((n_gps,))
        for tag, e in (("load", eps), ("unload 5%", eps * 0.95)):
            torch.cuda.synchronize()
            syncs = eng.syncs[0]
            t0 = time.perf_counter()
            r = eng.homogenize(e, state)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            nl = r.non_linear.cpu().numpy()
            cost = r.cost.cpu().numpy()
            log(f"[microfe] fast path {fast}, {tag}: {dt:.3f} s, {n_gps / dt:.1f} GP/s; "
                f"non_linear {int(nl.sum())} (driven {len(driven)}); full solves "
                f"{int((cost > 0).sum())}, micro CG its per solved GP "
                f"{cost[cost > 0].mean() if (cost > 0).any() else 0:.1f}; unconverged "
                f"{int(r.unconverged.sum())}; host syncs {eng.syncs[0] - syncs}"
                + (f"; dense preconditioner build {t_inv:.2f} s" if tag == "load" else ""))
            check(bool(torch.isfinite(r.stress).all() and torch.isfinite(r.ctan).all()),
                  "non-finite homogenized response")
            out[fast].append(r)
            state = r.trial_state
        check(bool(out[fast][0].non_linear[torch.as_tensor(driven, device=dev)].all()),
              "a driven GP is not flagged non-linear")
    for k, tag in enumerate(("load", "unload 5%")):
        a, b = out[True][k], out[False][k]
        agree = {f: rel_err(getattr(a, f), getattr(b, f)) for f in MICROFE_TOL}
        same_nl = bool(torch.equal(a.non_linear, b.non_linear))
        log(f"[microfe] {tag}, fast path vs full solve: stress {agree['stress']:.3e} "
            f"(bound {MICROFE_TOL['stress']:g}), ctan {agree['ctan']:.3e} "
            f"(bound {MICROFE_TOL['ctan']:g}); non_linear equal {same_nl}")
        for f, tol in MICROFE_TOL.items():
            check(agree[f] < tol, f"micro-FE fast path and full solve disagree in {f} ({tag})")
        check(same_nl, f"micro-FE routes flag different GPs ({tag})")


def phase_fe2(dev):
    launches = {"fe2_production": drive_cli("fe2 production", FE2_PRODUCTION)[1],
                "fe2_bending": drive_cli("fe2 bending", FE2_BENDING)[1]}
    result, launches["fe2_full"] = drive_cli("fe2 full", FE2_FULL)
    cost = result["diag"].cost
    log(f"[fe2 full] micro CG its per real GP in the last step: min "
        f"{float(cost.min()):.0f}, mean {float(cost.mean()):.1f}, max {float(cost.max()):.0f} "
        f"over {cost.numel()} GPs")
    check(bool((cost > 0).all()), "fe2 full: a real GP ran no micro solve")
    del result
    result, launches["fe2_plastic"] = drive_cli("fe2 plastic", FE2_PLASTIC)
    d = result["diag"]
    log(f"[fe2 plastic] last step: {int(d.non_linear.sum())} non-linear GPs, "
        f"{int((d.cost > 0).sum())} of {d.cost.numel()} real GPs solved in full by "
        f"the last homogenize, {d.micro_unconverged} micro solves at the Newton cap")
    check(bool(d.non_linear.any()), "fe2 plastic: no GP yielded")
    return launches


PHASES = ("k1", "k1v1", "k2", "goldens", "main", "microfe", "fe2")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    only = PHASES
    if "--only" in sys.argv:
        only = sys.argv[sys.argv.index("--only") + 1].split(",")
    from macroc_tpu_torch.utils.runtime import setup_runtime

    setup_runtime()
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    phase_build()
    path_shapes = path_node_shapes(dev) if {"k1", "k2"} & set(only) else []
    got = {}
    for name in only:
        t0 = time.perf_counter()
        args = (path_shapes,) if name in ("k1", "k2") else ()
        got[name] = globals()[f"phase_{name}"](dev, *args)
        torch.cuda.empty_cache()
        log(f"[time] phase {name}: {time.perf_counter() - t0:.1f} s")
    if tuple(only) != PHASES:
        log(f"[partial] ran only {','.join(only)}: no result line")
        return 4
    k1v1, v1_launches = got["k1v1"]
    fe2 = got["fe2"]
    # ``launches`` is the 128^3 J2 main path's count, as since the first
    # slice; ``launches_by_path`` adds each FE² line's own count
    by_path = lambda k: {"j2_128": got["main"][k], **{p: c[k] for p, c in fe2.items()}}
    kernels = [
        dict(name="stencil_spmv (K1)", route="cuda",
             source="macroc_tpu_torch/csrc/stencil_spmv.cu",
             replaces="macroc_tpu/ops/stencil_pallas.py:223",
             launches=got["main"]["K1"], launches_by_path=by_path("K1"),
             **got["k1"]),
        dict(name="assembly_combine (K2)", route="cuda",
             source="macroc_tpu_torch/csrc/assembly_combine.cu",
             replaces="macroc_tpu/ops/assembly_pallas.py:80",
             launches=got["main"]["K2"], launches_by_path=by_path("K2"),
             **got["k2"]),
        dict(name="stencil_spmv_v1 (K1v1)", route="cuda",
             source="macroc_tpu_torch/csrc/stencil_spmv_v1.cu",
             replaces="macroc_tpu/ops/stencil_pallas.py:79",
             launches=v1_launches, **k1v1),
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
