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
               128^3, 50x3x50, 100^3, 33x3x33 and 48^3 grids, the
               10x3x10 grid), and its narrow
               operator forms (bf16 and f16 A with f32 and f64 x, f32 A
               with f64 x) at the same shapes; then f32, the bf16-operator
               form and the plain version timed at the 128^3 fine-level
               shape of the main path, beside the library yardstick: the
               same operator as one CSR matrix (int32 indices,
               out-of-grid neighbours dropped) through torch.sparse;
  3. K1v1    — the shared-memory-tile SpMV kernel vs the plain version at
               the same shapes and types with two tiles, one ragged; then
               the SpMV variant sweep (the JAX bench's bench_spmv): K1v1,
               K1 and the plain version timed on the 128^3 assembled
               elastic stencil;
  4. K2      — the fused assembly kernel vs its plain version and the
               slab form at (32,32,32) and (20,9,27) elements and at the
               element shapes of the same path levels, f32 and f64, two
               launches bitwise equal; then timed at 127^3 elements as the
               Newton step calls it (B's shape derivatives passed once),
               beside the same call reading B on every launch and the
               earlier two-stage path (stage-1 matmul + combine kernel),
               with each path's peak memory;
  4b. cg     — the fused PCG iteration's kernels (K1's p.q form, the two
               update kernels of csrc/cg_fused.cu) against their plain
               versions at 128^3 and every path node shape, f32 and f64,
               two launches bitwise equal, each timed at 128^3 f32 beside
               K1; K1's half-stencil p.q form on a symmetric A against its
               plain version and the full p.q form at 128^3, 10x3x10 and
               33x17x45, f32 and f64 (bitwise repeats, a NaN-poisoned
               lower half unread, a no-op at flag 0), timed in turns with
               the full form; a 128^3 Jacobi solve of the BC-eliminated
               elastic stencil (its asymmetry printed) through the fused
               loop (half-stencil form), the fused loop with the full p.q
               form, the same loop on the plain versions and the unfused
               loop (K1 behind an opaque operator), ms per iteration each;
               and the CLI on the main line with -pc_type jacobi (the
               benchmark's Jacobi cell), with the fused kernels' counters
               and its operators' asymmetry read around it;
  4c. j2     — the J2 return-map kernel (csrc/j2_return.cu) against its
               plain version at the 128^3 main path's 16,777,216 GP slots,
               f32 and f64, on a field about half plastic (the plastic
               flags equal away from yield), two launches bitwise equal;
               timed beside the plain version and its bound; one
               homogenize's peak above its inputs against its outputs'
               bytes, beside the plain version's;
  5. goldens — the four J2 CG goldens, the GMRES golden and the FE² golden
               (tests/goldens/*.json) at f64 through the kernels (the J2
               ones through the return-map kernel);
  6. main    — ``macroc_tpu_torch.cli`` on the 128^3 J2 + MG bending case,
               3 time steps in f32, with the kernels' launch counters read
               around it;
  7. solvers — the CLI on the same line with -mg_dtype bfloat16 (K1's
               bf16-operator form on every MG level) and with -ksp_type
               gmres; and the production grid (scripts/production_run.sh,
               J2, 3 steps) with -operator matfree beside -operator stencil
               -pc_type jacobi;
  8. checkpoint — the production_run.sh line as written (J2) with -ts 4
               -checkpoint_freq 2, then -resume -ts 6, against an
               uninterrupted 6-step run; checkpoint bytes, write and read
               seconds;
  9. profile — the production_run.sh line, 2 steps, with -profile_dir: the
               trace must hold K1;
 10. microfe — the micro-FE engine at the production RVE (micro_n=10,
               two-phase layers, f32) on 2048 GPs, every 10th driven past
               yield: elastic fast path on and off, flags and agreement;
 11. fe2     — ``macroc_tpu_torch.cli`` on FE² launch lines, with the
               kernels' launch counters read around each: the production
               shape of scripts/production_run.sh (50x3x50 nodes, lx=lz=50,
               circle BC, dt 1e-3, micro_n=10, fast path); the 50x3x50
               bending line at lx=lz=10; the 10x3x10 full-solve line
               (Jacobi PCG: the fused route with the full p.q form, its
               operators' asymmetry printed), 3 steps with a checkpoint at
               step 2 that a -resume run takes up (a MicroState); and the 50x3x50 bending grid loaded until
               micro GPs yield;
 12. dist    — the domain-decomposed run: K2 on each rank's local box plus
               one node plane per split axis (a slice of a node-shaped
               tangent field) and K1's halo form on the exchanged x, at the
               rank blocks of this phase's lines and of 128^3 and 48^3
               over 2, 4 and 8 ranks, f32 and f64, against their plain
               versions; the
               host cost of one all-reduce, halo exchange and K1 halo call,
               and of MG's level-1 tangent and coarse-vector all-reduces,
               and of MG's line gather on the production grid split along
               y; then ``macroc_tpu_torch.cli`` as separate processes, each
               with its launch counters and peak memory:
               scripts/pod_run.sh's 100^3 line as written (2 steps, MG,
               f32) as 2 ranks sharing the card (gloo by the backend rule)
               against 1 process; linesplit: production_run.sh's J2 line
               (3 steps, MG with lines along y) on rank grids that split y,
               (1,2,1) as 2 ranks and (2,2,1) as 4, against 1 process, the
               automatic 2-rank split and each other; the production FE²
               line at 2 ranks against 1 (with each rank's micro state and
               per-homogenize full solves and memory); the 10x3x10
               full-solve FE² line's MicroState
               checkpoint written by 2 ranks and resumed on 1 and on 2;
               and the f64 bending_plastic_5x3x3 golden line at 2 ranks
               (with -vtu_freq 1: PVTU pieces per rank) against 1 process
               within the golden roundoff bounds; where there are two
               cards, the 100^3 line again with NCCL;
 13. bench   — ``bench_torch.main(quick=True)``: every bench function once
               (one sample per timing, the micro-FE production rows at 2048
               GPs), its gates, and K1, K1v1 and K2 launched;
 14. scripts — the port's scripts through their functions: tune_microfe's
               six configurations on 256 GPs (micro_n=10), the pancake MG
               check at 33x3x33 f64 (counts within 1 of the CPU's, each
               solution within 3 rtol of the CPU's),
               bisect_newton's assembly forms at 127^3 and its 128^3 MG
               step, the scaling sweep's 48^3 grid on 1 and 2 ranks; K1
               and K2 launched in the pancake, bisect and scaling runs.

The second-to-last line is the per-kernel JSON record, the last line
{"ok": true, "device": {...}}.  Without a CUDA device the script exits 1
before doing anything.  ``--only PHASE[,PHASE]`` (a development aid) runs
a subset, build always included, prints "[partial] ..." instead of the
result lines and exits 4.
"""

import contextlib
import gc
import json
import math
import os
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(REPO, "tests", "goldens")
TOLS = {torch.float32: 1e-5, torch.float64: 1e-12}
# K1's narrow operator forms (A dtype, x dtype), held to the x dtype's bound
NARROW_PAIRS = [(torch.bfloat16, torch.float32), (torch.bfloat16, torch.float64),
                (torch.float16, torch.float32), (torch.float16, torch.float64),
                (torch.float32, torch.float64)]
HBM_GBS = 3350.0  # the H100 SXM's published device-memory rate, GB/s

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
# the JAX bench's fe2_full shape: the full micro solve at every GP; 3 steps,
# with the checkpoint at step 2 that the resume check takes up
FE2_FULL = GRID_10 + FE2_FLAGS + ["-ts", "3", "-micro_elastic_fastpath", "0",
                                  "-checkpoint_freq", "2"]
# the bending line loaded 250x faster, so ~8% of the micro GPs yield in
# step 2 (U = -0.5: the reference's unit-spacing B quirk makes the 50x3x50
# strains 5x smaller than the 10x3x10 ones at the same U): the screen and
# the compacted full solves at scale, with a trial state per homogenize
FE2_PLASTIC = GRID_50 + FE2_FLAGS + ["-ts", "3", "-dt", "0.25"]
# f32 agreement of the micro-FE fast path with the full solve (normwise,
# relative to the largest entry): both routes stop at CG tolerances of 1e-8
# (equilibrium, elastic basis) and 1e-6 (tangent columns) relative, which
# f32 reaches to its roundoff times the RVE operator's conditioning; the
# driven GPs run the same full solve in other batch compositions
MICROFE_TOL = dict(stress=1e-5, ctan=1e-5)

# fine node grids of the driven paths: with an MG hierarchy (128^3 J2,
# 50x3x50 FE², the 100^3 pod_run.sh line, whose coarse levels every rank
# runs whole, the scripts phase's 33x3x33 pancake check, f64, and 48^3
# scaling sweep), and with Jacobi PCG on one level (10x3x10 FE²)
MG_GRIDS = [(128, 128, 128), (50, 3, 50), (100, 100, 100), (33, 3, 33), (48, 48, 48)]
JACOBI_GRID = (10, 3, 10)

MAIN_FLAGS = [
    "-da_grid_x", "128", "-da_grid_y", "128", "-da_grid_z", "128",
    "-lx", "4", "-ly", "4", "-lz", "4", "-bc_type", "0",
    "-constitutive", "j2", "-pc_type", "mg", "-dtype", "float32",
    "-ts", "3", "-log_phases",
]
# scripts/production_run.sh's line as written: equal micro materials, so
# constitutive "auto" runs J2; later flags override its -ts and
# -checkpoint_freq
PRODUCTION_J2 = GRID_50 + [
    "-lx", "50", "-ly", "1", "-lz", "50", "-ts", "10000", "-dt", "0.001",
    "-bc_type", "1", "-newton_max_its", "4", "-micro_n", "10", "-micro_type", "1",
    "-checkpoint_freq", "500", "-log_phases",
]
# a resumed run's info.dat rows against the uninterrupted run's: counts
# and step data exactly, force and f_trial_max to this relative bound.  The
# state is restored bit for bit, so equal rows are expected; the bound
# leaves room for f32 roundoff of another summation order should a library
# routine of the step not be deterministic on the card
RESUME_RTOL = 1e-5


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


F32_TFLOPS = 67.0  # the H100 SXM's published FP32 rate outside the tensor cores


def bound(nbytes, flops):
    """(bound_ms, bound_by) of f32 work: the larger of moving ``nbytes`` at
    the HBM rate and doing ``flops`` at the card's FP32 peak."""
    mem_ms = nbytes / (HBM_GBS * 1e6)
    op_ms = flops / (F32_TFLOPS * 1e9)
    return (mem_ms, "bytes") if mem_ms >= op_ms else (op_ms, "operations")


def library_spmv(tag, A, x, y_kernel):
    """Time one cuSPARSE CSR SpMV (``torch.mv(A_csr, x)``) on the same operator and
    vector as K1, held against the kernel's y; returns ms."""
    from bench_torch import csr_from_soa

    A_csr = csr_from_soa(A)
    xv = x.permute(1, 2, 3, 0).reshape(-1)
    y = torch.mv(A_csr, xv).view(*x.shape[1:], 3).permute(3, 0, 1, 2)
    err = rel_err(y, y_kernel)
    check(err < TOLS[torch.float32], f"{tag}: the CSR SpMV disagrees with the kernel")
    ms = time_ms(lambda: torch.mv(A_csr, xv), 20)
    nnz = A_csr.values().numel()
    log(f"[{tag}] library CSR SpMV (torch.sparse, cuSPARSE, int32 indices): {ms:.4f} ms, "
        f"nnz {nnz}, {(nnz * 8 + (3 * x[0].numel() + 1) * 4 + 2 * x.numel() * 4) / 1e9:.3f} GB; "
        f"max rel dev from the kernel {err:.3e}")
    del A_csr
    return ms


def phase_build():
    from macroc_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    log(f"[build] {os.path.relpath(path, REPO)} built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")


def path_node_shapes(dev):
    """Node shapes at which the driven paths launch K1 and K2: every level
    of the MG hierarchy that ``build_hierarchy`` builds on each grid of
    MG_GRIDS (its level shapes depend on the node grid alone), and the
    10x3x10 grid (FE² full-solve line, Jacobi PCG on one level)."""
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
        # the narrow operator forms (-mg_dtype levels) at the same shape and
        # vector dtypes, bounded by the vector dtype; one random operator
        # per shape (host RNG dominates the phase at 64^3)
        errs = []
        A32 = randn(rng, (27, 3, 3) + shape, torch.float32, dev)
        for a_dtype, dtype in NARROW_PAIRS:
            A = A32.to(a_dtype)
            for halo in (False, True):
                xs = tuple(n + 2 for n in shape) if halo else shape
                x = randn(rng, (3,) + xs, dtype, dev)
                err = rel_err(stencil_matvec(A, x, halo=halo),
                              stencil_matvec_soa(A, x, halo=halo))
                errs.append(f"{str(a_dtype)[6:]}/{str(dtype)[6:]}{' halo' if halo else ''} "
                            f"{err:.3e}")
                check(err < TOLS[dtype], f"K1 narrow form disagrees with its plain version "
                      f"at {shape} A {a_dtype} x {dtype} halo={halo}: {err:.3e}")
        log(f"[K1 narrow] {shape}: max rel err " + ", ".join(errs))
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
    nodes = math.prod(shape)
    k1 = dict(max_abs_err=float((y - y_ref).abs().max()), ms=ms, plain_ms=plain_ms,
              library_ms=library_spmv("K1", A, x, y))
    k1["bound_ms"], k1["bound_by"] = bound((243 + 6) * 4 * nodes, 2 * 243 * nodes)
    # the bf16-operator form at 128^3 with f32 x (a bf16 MG fine level):
    # the same bf16 values as f32 through K1, and the plain version
    Ab = A.to(torch.bfloat16)
    del A
    Aw = Ab.float()
    y = stencil_matvec(Ab, x)
    y_ref = stencil_matvec_soa(Ab, x)
    err = rel_err(y, y_ref)
    check(err < TOLS[torch.float32], "K1 bf16-operator form disagrees at 128^3")
    check(rel_err(stencil_matvec(Aw, x), y_ref) < TOLS[torch.float32],
          "K1 on the widened operator disagrees with the bf16 form")
    t = {"bf16 A": time_ms(lambda: stencil_matvec(Ab, x), 50),
         "f32 A": time_ms(lambda: stencil_matvec(Aw, x), 50),
         "plain": time_ms(lambda: stencil_matvec_soa(Ab, x), 5)}
    byts = {"bf16 A": 243 * 2 + 6 * 4, "f32 A": (243 + 6) * 4, "plain": 243 * 2 + 6 * 4}
    log("[K1 narrow] 128^3 bf16 A, f32 x: max abs err "
        f"{float((y - y_ref).abs().max()):.3e}, rel {err:.3e}; " + ", ".join(
            f"{k} {v:.4f} ms ({byts[k] * nodes / v / 1e6:.1f} GB/s at {byts[k]} B/node, "
            f"{byts[k] * nodes / v / 1e6 / HBM_GBS:.3f} of {HBM_GBS / 1000:g} TB/s)"
            for k, v in t.items()))
    narrow = dict(max_abs_err=float((y - y_ref).abs().max()), ms=t["bf16 A"],
                  plain_ms=t["plain"], f32_operator_ms=t["f32 A"], library_ms=None,
                  library_note="no PyTorch call multiplies a bf16 matrix into an f32 "
                               "vector accumulating in f32")
    narrow["bound_ms"], narrow["bound_by"] = bound(byts["bf16 A"] * nodes, 2 * 243 * nodes)
    return k1, narrow


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


def peak_gib(fn):
    """Device memory one call of ``fn`` allocates above what was held
    before it, at its peak (GiB)."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**30


K2_TIMED = (127, 127, 127)  # the 128^3 main path's fine-level elements


def phase_k2(dev, path_shapes):
    """The fused K2 against its plain version (stage 1 + combine_plain) and
    the slab form at every element shape the driven paths give it, f32 and
    f64, with two launches bitwise equal; then, at the 128^3 main path's
    127^3 elements in f32, timed with B's shape derivatives passed once (as
    the Newton step calls it) and read from B per call, beside the earlier
    two-stage path (stage-1 matmul + the combine kernel) and the plain
    version."""
    from macroc_tpu_torch.fem.element import b_matrix
    from macroc_tpu_torch.fem.kernels import assemble_stencil_soa
    from macroc_tpu_torch.ops import assembly as asm

    rng = np.random.default_rng(2)
    # (20,9,27) elements: no tile divides its node grid on y or z
    elems = [(32, 32, 32), (20, 9, 27)] + [tuple(n - 1 for n in s) for s in path_shapes]
    for ne in elems:
        shape = tuple(n + 1 for n in ne)
        errs = []
        for dtype, tol in TOLS.items():
            if ne == K2_TIMED and dtype == torch.float32:
                continue  # checked and timed below
            B = torch.as_tensor(b_matrix((1.0, 1.1, 0.9)), dtype=dtype, device=dev)
            ct = randn(rng, ne + (8, 6, 6), dtype, dev)
            A = asm.assemble_stencil_soa_kernel(ct, B, 0.1, shape)
            same = torch.equal(asm.assemble_stencil_soa_kernel(ct, B, 0.1, shape), A)
            err = rel_err(A.reshape(243, *shape), asm.assemble_stencil_soa_plain(ct, B, 0.1, shape))
            err_slab = rel_err(A, assemble_stencil_soa(ct, B, 0.1, shape))
            errs.append(f"{str(dtype)[6:]} {err:.3e} (slab {err_slab:.3e}, repeat bitwise {same})")
            check(same and err < tol and err_slab < tol,
                  f"K2 disagrees with its plain version at {ne} {dtype}: {err:.3e}, slab "
                  f"{err_slab:.3e}, repeat bitwise {same}")
            del A, ct
        log(f"[K2] {ne} elements: max rel err vs plain " + ", ".join(errs)
            + f" (bounds {TOLS[torch.float32]:g}, {TOLS[torch.float64]:g})")
    ne = K2_TIMED
    shape = tuple(n + 1 for n in ne)
    B = torch.as_tensor(b_matrix((1.0, 1.0, 1.0)), dtype=torch.float32, device=dev)
    ct = randn(rng, ne + (8, 6, 6), torch.float32, dev)
    A = asm.assemble_stencil_soa_kernel(ct, B, 0.1, shape).reshape(243, *shape)
    check(torch.equal(asm.assemble_stencil_soa_kernel(ct, B, 0.1, shape).reshape(243, *shape), A),
          "K2 launches differ at 127^3")
    Ke = asm.element_stiffness_cm(ct, B, 0.1)
    A_two = asm.combine_cuda(Ke, shape)
    check(torch.equal(A_two, asm.combine_plain(Ke, shape)),
          "the two-stage combine differs from its plain version at 127^3")
    del Ke
    abs_err = float((A - A_two).abs().max())
    err = abs_err / float(A_two.abs().max())
    check(err < TOLS[torch.float32], f"K2 disagrees with its plain version at 127^3: {err:.3e}")
    err_slab = rel_err(A, assemble_stencil_soa(ct, B, 0.1, shape).reshape(243, *shape))
    check(err_slab < TOLS[torch.float32], "K2 disagrees with the slab form at 127^3")
    del A, A_two
    # B's shape derivatives taken once, as the Newton step does
    # (MacroProblem.dsh); without dsh every call reads B to the host and
    # checks its pattern: a device sync between launches
    dsh = asm.b_dsh(B)
    fused = lambda: asm.assemble_stencil_soa_kernel(ct, B, 0.1, shape, dsh=dsh)
    two_stage = lambda: asm.combine_cuda(asm.element_stiffness_cm(ct, B, 0.1), shape)
    t = {"fused": time_ms(fused, 20),
         "fused, B read per call": time_ms(
             lambda: asm.assemble_stencil_soa_kernel(ct, B, 0.1, shape), 20),
         "stage-1 matmul": time_ms(lambda: asm.element_stiffness_cm(ct, B, 0.1), 5),
         "stage 1 + combine kernel": time_ms(two_stage, 5),
         "plain": time_ms(lambda: asm.assemble_stencil_soa_plain(ct, B, 0.1, shape), 3)}
    peak = {"fused": peak_gib(fused), "two-stage": peak_gib(two_stage)}
    nbytes = (288 * math.prod(ne) + 243 * math.prod(shape)) * 4
    flops = 2 * 17280 * math.prod(ne)
    bound_ms, bound_by = bound(nbytes, flops)
    log(f"[K2] {ne} elements f32 (the 128^3 main path's fine level): fused vs plain max abs err {abs_err:.3e}, rel {err:.3e} "
        f"(slab {err_slab:.3e}); bound {bound_ms:.4f} ms ({bound_by}: {nbytes / 1e9:.3f} GB, "
        f"{flops / 1e9:.1f} GFLOP); " + ", ".join(
            f"{k} {v:.4f} ms ({nbytes / v / 1e6:.1f} GB/s, {bound_ms / v:.3f} of the bound)"
            for k, v in t.items())
        + f"; peak device memory of one call: fused {peak['fused']:.3f} GiB, two-stage "
        f"{peak['two-stage']:.3f} GiB")
    return dict(max_abs_err=abs_err, ms=t["fused"], plain_ms=t["plain"], bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None,
                library_note="no single PyTorch call assembles a stencil from tangents",
                fused_b_per_call_ms=t["fused, B read per call"],
                stage1_ms=t["stage-1 matmul"], two_stage_ms=t["stage 1 + combine kernel"],
                peak_gib=peak["fused"], two_stage_peak_gib=peak["two-stage"])


# the fused PCG iteration's checks: kernels and solves at the main line's
# fine grid; the CLI on the main line with Jacobi (the benchmark's Jacobi cell)
CG_GRID = (128, 128, 128)
JACOBI_FLAGS = MAIN_FLAGS + ["-pc_type", "jacobi"]
# the 128^3 Jacobi solve at rtol 1e-5: the fused loop against the same loop
# on the plain versions, x's max deviation over its largest value.  x
# carries each loop's roundoff through ~540 iterations: measured 2.8e-5
# (f32) and 5.4e-13 (f64) on an H100; bounds at ~10x and ~200x that
CG_SOLVE_TOL = {torch.float32: 3e-4, torch.float64: 1e-10}
CG_SOLVE_ITS = 1
# the half-stencil p.q form's checks: the fused route's grids (the main
# line's, the FE² Jacobi line's) and a ragged one
SYM_GRIDS = [CG_GRID, JACOBI_GRID, (33, 17, 45)]


def cg_state(like, rz, maxits=1 << 30, tol=-1.0):
    """A CGState on ``like``'s device after a made-up iteration 0; the
    defaults never stop (timing)."""
    from macroc_tpu_torch.solve.cg_state import CGState

    return CGState(like.device, rz=rz, rnorm0=1.0, tol=tol, div=math.inf, abstol=1e-50,
                   maxits=maxits, reason0=0, pnorm=True, nodes=like[0].numel(),
                   record_trace=maxits < 1000)


def cg_clone(state, like):
    new = cg_state(like, 0.0, maxits=int(state.st[3]))
    for name in ("sc", "st", "trace"):
        getattr(new, name).copy_(getattr(state, name))
    return new


def cg_step_fields(state):
    """The state's scalars (0-7), flags and counts (8-13) and the first
    trace entries (14-15) as one float64 vector; NaN (an unwritten trace
    entry) as 0."""
    return torch.cat([state.sc, state.st.double(), state.trace[:2]]).nan_to_num()


@contextlib.contextmanager
def fused_asymmetry(rec):
    """Appends (stencil_asymmetry(A), the operator's ``symmetric`` flag) to
    ``rec`` for every operator that takes cg_solve's fused route while the
    block runs (a read of A; no kernel launches)."""
    from macroc_tpu_torch.ops.stencil_spmv import stencil_asymmetry
    from macroc_tpu_torch.solve import cg as cg_mod

    fused_operands = cg_mod._fused_operands

    def recording(matvec, b, precond, allreduce):
        out = fused_operands(matvec, b, precond, allreduce)
        if out is not None:
            rec.append((stencil_asymmetry(out[0]), matvec.symmetric))
        return out

    cg_mod._fused_operands = recording
    try:
        yield rec
    finally:
        cg_mod._fused_operands = fused_operands


def check_dot_sym(dev, gen):
    """The half-stencil p.q form against its plain version and against the
    full p.q form on a symmetric random A (the dominant diagonal of
    phase_cg's check, mirrored into the lower half) at SYM_GRIDS, f32 and
    f64: two launches bitwise equal, the lower half poisoned with NaN
    giving the same q, a no-op when the flag is 0.  Returns the 128^3 f32
    operands for the timing and the largest abs error of q there."""
    from macroc_tpu_torch.ops.stencil_spmv import (
        stencil_matvec_dot,
        stencil_matvec_dot_sym,
        stencil_matvec_dot_sym_plain,
        stencil_transpose_soa,
    )

    kept = None
    for shape in SYM_GRIDS:
        errs = []
        for dtype, tol in TOLS.items():
            A = 0.1 * torch.randn((27, 3, 3) + shape, dtype=dtype, device=dev, generator=gen)
            A[13].diagonal(dim1=0, dim2=1).add_(3.0)
            A = 0.5 * (A + stencil_transpose_soa(A))
            p = torch.randn((3,) + shape, dtype=dtype, device=dev, generator=gen)
            q = {}
            for name, fn in (("sym", stencil_matvec_dot_sym), ("sym again", stencil_matvec_dot_sym),
                             ("plain", stencil_matvec_dot_sym_plain), ("full", stencil_matvec_dot)):
                st = cg_state(p, 2.0)
                q[name] = torch.empty_like(p)
                fn(A, p, q[name], st)
                q[name + " sc"] = st.sc.clone()
            check(torch.equal(q["sym"], q["sym again"]) and torch.equal(q["sym sc"], q["sym again sc"]),
                  f"cg sym: two launches differ at {shape} {dtype}")
            pq_scale = float((p * q["plain"]).abs().sum(dtype=torch.float64))
            e = {}
            for ref in ("plain", "full"):
                e[f"q vs {ref}"] = rel_err(q["sym"], q[ref])
                e[f"pq vs {ref}"] = float((q["sym sc"][1] - q[ref + " sc"][1]).abs()) / pq_scale
                e[f"alpha vs {ref}"] = float(((q["sym sc"][2] - q[ref + " sc"][2])
                                              / q[ref + " sc"][2]).abs())
            bad = {f: v for f, v in e.items() if not v < tol}
            check(not bad, f"cg sym: the half-stencil form disagrees at {shape} {dtype}: {bad}")
            A[:13] = float("nan")
            st = cg_state(p, 2.0)
            q_nan = torch.empty_like(p)
            stencil_matvec_dot_sym(A, p, q_nan, st)
            check(torch.equal(q_nan, q["sym"]) and torch.equal(st.sc, q["sym sc"]),
                  f"cg sym: the NaN-poisoned lower half changed q at {shape} {dtype}")
            st = cg_state(p, 2.0)
            st.st[2] = 0
            sc0 = st.sc.clone()
            q_idle = torch.full_like(p, 7.0)
            stencil_matvec_dot_sym(A, p, q_idle, st)
            check(bool((q_idle == 7.0).all()) and torch.equal(st.sc, sc0),
                  f"cg sym: not a no-op with the flag at 0 at {shape} {dtype}")
            errs.append(f"{str(dtype)[6:]} " + ", ".join(f"{f} {v:.2e}" for f, v in e.items()))
            if shape == CG_GRID and dtype == torch.float32:
                A[:13] = stencil_transpose_soa(A)[:13]  # the mirror again, for the full form
                kept = (A, p, float((q["sym"] - q["plain"]).abs().max()))
            del A
        log(f"[cg sym] {shape}: max rel err " + "; ".join(errs)
            + f" (bounds {TOLS[torch.float32]:g}, {TOLS[torch.float64]:g}); two launches "
            "bitwise equal; NaN in blocks 0..12 changes nothing; a no-op at flag 0")
    return kept


def phase_cg(dev, path_shapes):
    """The fused PCG iteration's three kernels against their plain
    versions, then a 128^3 Jacobi solve through the three loops, then the
    CLI's Jacobi line (module docstring, phase 4b)."""
    from macroc_tpu_torch import MacroConfig, MaterialParams
    from macroc_tpu_torch import bc as tbc
    from macroc_tpu_torch.constitutive.elastic import elastic_matrix
    from macroc_tpu_torch.fem.element import b_matrix
    from macroc_tpu_torch.grid import make_grid
    from macroc_tpu_torch.ops.assembly import assemble_stencil_soa_kernel
    from macroc_tpu_torch.ops.cg_fused import (
        cg_update_p,
        cg_update_p_plain,
        cg_update_xr,
        cg_update_xr_plain,
    )
    from macroc_tpu_torch.ops.stencil_spmv import (
        StencilOperator,
        stencil_asymmetry,
        stencil_matvec,
        stencil_matvec_dot,
        stencil_matvec_dot_plain,
        stencil_matvec_dot_sym,
        stencil_matvec_dot_sym_plain,
        stencil_matvec_soa,
    )
    from macroc_tpu_torch.solve.cg import cg_solve
    from macroc_tpu_torch.solve.precond import jacobi_precond_soa

    gen = torch.Generator(device=dev).manual_seed(12)
    rec = {}
    for shape in [CG_GRID] + [s for s in path_shapes if s != CG_GRID]:
        errs = []
        for dtype, tol in TOLS.items():
            rnd = lambda *sh: torch.randn(sh, dtype=dtype, device=dev, generator=gen)
            # a dominant positive diagonal keeps p.Ap, and so alpha, away
            # from cancellation, as on a solve's SPD operator
            A = 0.1 * rnd(27, 3, 3, *shape)
            A[13].diagonal(dim1=0, dim2=1).add_(3.0)
            p, x, r = (rnd(3, *shape) for _ in range(3))
            inv = rnd(3, *shape).abs() + 0.5  # a Jacobi inverse diagonal is positive
            st0 = cg_state(p, 2.0, maxits=40, tol=1e-30)
            out = {}
            for name, (mv, xr, up) in {
                    "kernel": (stencil_matvec_dot, cg_update_xr, cg_update_p),
                    "plain": (stencil_matvec_dot_plain, cg_update_xr_plain,
                              cg_update_p_plain)}.items():
                reps = []
                for _ in range(2 if name == "kernel" else 1):
                    st = cg_clone(st0, p)
                    q = torch.empty_like(p)
                    xx, rr, pp = x.clone(), r.clone(), p.clone()
                    mv(A, pp, q, st)
                    after_dot = cg_step_fields(st)
                    xr(xx, pp, rr, q, inv, st)
                    up(pp, rr, inv, st)
                    reps.append(dict(q=q, dot=after_dot, x=xx, r=rr, p=pp,
                                     end=cg_step_fields(st)))
                if name == "kernel":
                    check(all(torch.equal(reps[0][k], reps[1][k]) for k in reps[0]),
                          f"cg kernels: two launches differ at {shape} {dtype}")
                out[name] = reps[0]
            k, pl = out["kernel"], out["plain"]
            e = {f: rel_err(k[f], pl[f]) for f in ("q", "x", "r", "p")}
            # p.q has cancelling terms: its error is held against the sum of
            # |p_i q_i|; rz and rnorm are sums of positive terms; each
            # scalar against its own magnitude
            pq_scale = float((p * pl["q"]).abs().sum(dtype=torch.float64))
            e["pq"] = float((k["dot"][1] - pl["dot"][1]).abs()) / pq_scale
            scal = lambda a, b: float(((a - b).abs() / b.abs()).max())
            e["alpha"] = scal(k["dot"][2], pl["dot"][2])
            e["rz,beta,rnorm,trace"] = scal(k["end"][[0, 3, 4, 15]], pl["end"][[0, 3, 4, 15]])
            check(torch.equal(k["end"][8:14], pl["end"][8:14]),
                  f"cg kernels: its/reason/active differ at {shape} {dtype}")
            bad = {f: v for f, v in e.items() if not v < tol}
            check(not bad, f"cg kernels disagree with their plain versions at {shape} "
                  f"{dtype}: {bad}")
            errs.append(f"{str(dtype)[6:]} " + ", ".join(f"{f} {v:.2e}" for f, v in e.items()))
            if shape == CG_GRID and dtype == torch.float32:
                rec["abs"] = {f: float((k[f] - pl[f]).abs().max()) for f in ("q", "x", "r", "p")}
                rec["A"], rec["p"], rec["x"], rec["r"], rec["inv"] = A, p, x, r, inv
            else:
                del A
        log(f"[cg] {shape}: max rel err " + "; ".join(errs)
            + f" (bounds {TOLS[torch.float32]:g}, {TOLS[torch.float64]:g}); two launches "
            "bitwise equal")
    A_sym, p_sym, rec["abs"]["q_sym"] = check_dot_sym(dev, gen)
    # timed at 128^3 f32 beside K1, on a state that never stops
    A, p, x, r, inv = (rec.pop(k) for k in ("A", "p", "x", "r", "inv"))
    q = torch.empty_like(p)
    nodes = math.prod(CG_GRID)
    st = cg_state(p, 2.0)
    stp = cg_state(p, 2.0)
    t = {
        "K1": time_ms(lambda: stencil_matvec(A, p), 50),
        "K1_dot": time_ms(lambda: stencil_matvec_dot(A, p, q, st), 50),
        "K1_dot_plain": time_ms(lambda: stencil_matvec_dot_plain(A, p, q, stp), 5),
        "xr": time_ms(lambda: cg_update_xr(x, p, r, q, inv, st), 50),
        "xr_plain": time_ms(lambda: cg_update_xr_plain(x, p, r, q, inv, stp), 5),
        "p": time_ms(lambda: cg_update_p(p, r, inv, st), 50),
        "p_plain": time_ms(lambda: cg_update_p_plain(p, r, inv, stp), 5),
    }
    check(bool(st.st[2]) and int(st.st[0]) > 50, "cg: the timing state stopped")
    # the half-stencil form beside the full p.q form on one symmetric A, in
    # turns (full, half, half, full)
    q_sym = torch.empty_like(p_sym)
    st_sym, stp_sym = cg_state(p_sym, 2.0), cg_state(p_sym, 2.0)
    turns = []
    for name in ("K1_dot", "K1_dot_sym", "K1_dot_sym", "K1_dot"):
        fn = stencil_matvec_dot_sym if name == "K1_dot_sym" else stencil_matvec_dot
        turns.append((name, time_ms(lambda: fn(A_sym, p_sym, q_sym, st_sym), 50)))
    t["K1_dot_sym"] = min(ms for n, ms in turns if n == "K1_dot_sym")
    t["K1_dot_sym_plain"] = time_ms(
        lambda: stencil_matvec_dot_sym_plain(A_sym, p_sym, q_sym, stp_sym), 5)
    log("[cg sym] 128^3 f32, in turns on one symmetric A: " + ", ".join(
        f"{n} {ms:.4f} ms" for n, ms in turns))
    check(bool(st_sym.st[2]), "cg sym: the timing state stopped")
    del A_sym, p_sym, q_sym, st_sym, stp_sym
    work = {"K1_dot": ((243 + 6) * 4 * nodes, 2 * 243 * nodes + 6 * nodes),
            # blocks 13..26 (126 planes), p and q
            "K1_dot_sym": ((126 + 6) * 4 * nodes, 2 * 243 * nodes + 6 * nodes),
            "xr": (7 * 4 * 3 * nodes, 12 * 3 * nodes), "p": (4 * 4 * 3 * nodes, 3 * 3 * nodes)}
    err_of = {"K1_dot": "q", "K1_dot_sym": "q_sym", "xr": "r", "p": "p"}
    kern = {}
    for name in ("K1_dot", "K1_dot_sym", "xr", "p"):
        b_ms, b_by = bound(*work[name])
        kern[name] = dict(max_abs_err=rec["abs"][err_of[name]], ms=t[name], plain_ms=t[name + "_plain"], bound_ms=b_ms,
                          bound_by=b_by, library_ms=None)
    kern["xr"]["max_abs_err"] = max(rec["abs"]["x"], rec["abs"]["r"])
    log("[cg] 128^3 f32: " + ", ".join(
        f"{n} {t[n]:.4f} ms (bound {kern[n]['bound_ms']:.4f}, "
        f"{kern[n]['bound_ms'] / t[n]:.2f} of it; plain {t[n + '_plain']:.4f})"
        for n in ("K1_dot", "K1_dot_sym", "xr", "p")) + f"; K1 {t['K1']:.4f} ms, so the p.q "
        f"epilogue costs {t['K1_dot'] - t['K1']:+.4f} ms; one fused iteration "
        f"{t['K1_dot_sym'] + t['xr'] + t['p']:.4f} ms of kernels (with the full p.q form "
        f"{t['K1_dot'] + t['xr'] + t['p']:.4f})")
    del A, p, x, r, inv, q, st, stp
    # a 128^3 Jacobi solve: the BC-eliminated elastic stencil of the main
    # line's grid, a seeded right-hand side zero on constrained rows
    cfg = MacroConfig(nx=CG_GRID[0], ny=CG_GRID[1], nz=CG_GRID[2], lx=4.0, ly=4.0,
                      lz=4.0, bc_type=0)
    grid = make_grid(cfg, 1)
    shape = (grid.nx, grid.ny, grid.nz)
    solves = {}
    b64 = torch.randn((3,) + shape, dtype=torch.float64, device=dev, generator=gen)
    for dtype in (torch.float64, torch.float32):
        Bm = torch.as_tensor(b_matrix(grid.spacing), dtype=dtype, device=dev)
        C = torch.as_tensor(elastic_matrix(MaterialParams()), dtype=dtype, device=dev)
        ctan = C.expand(tuple(n - 1 for n in shape) + (8, 6, 6)).contiguous()
        bc = tbc.build_bc(grid, cfg, dtype, dev)
        A = tbc.apply_bc_stencil_soa(assemble_stencil_soa_kernel(ctan, Bm, grid.wg, shape), bc)
        del ctan
        b = b64.to(dtype).masked_fill(bc.mask.permute(3, 0, 1, 2), 0.0)
        log(f"[cg] 128^3 elastic operator, BC-eliminated, {str(dtype)[6:]}: asymmetry "
            f"max|A[o,d,e,p] - A[26-o,e,d,p+off]| / max|A| = {stencil_asymmetry(A):.3e}")
        M = jacobi_precond_soa(A)
        loops = {"fused": (StencilOperator(A), M),
                 "fused full": (StencilOperator(A, symmetric=False), M),
                 "plain": (StencilOperator(A, stencil_matvec_soa), M),
                 "unfused": (lambda v: stencil_matvec(A, v), lambda v: M(v))}
        res = {}
        for name, (mv, pc) in loops.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = cg_solve(mv, b, pc)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            true_res = float((b - stencil_matvec(A, out.x)).norm() / b.norm())
            res[name] = dict(its=out.its, reason=out.reason, ms_per_it=sec * 1e3 / out.its,
                             x=out.x, true_res=true_res)
        ref = res["plain"]
        for name, v in res.items():
            v["x_err"] = rel_err(v["x"], ref["x"])
            v["x_err_f64"] = rel_err(v["x"].double(), solves[torch.float64]["plain"]["x"]
                                     if dtype == torch.float32 else ref["x"])
        log(f"[cg] 128^3 Jacobi solve {str(dtype)[6:]}: " + "; ".join(
            f"{n} {v['its']} its (reason {v['reason']}), {v['ms_per_it']:.4f} ms/it, "
            f"x rel dev from the plain loop {v['x_err']:.2e} (from the f64 plain loop "
            f"{v['x_err_f64']:.2e}), |b-Ax|/|b| {v['true_res']:.2e}" for n, v in res.items())
            + f" (bounds: its within {CG_SOLVE_ITS}, x {CG_SOLVE_TOL[dtype]:g})")
        for name, v in res.items():
            check(v["reason"] > 0 and abs(v["its"] - ref["its"]) <= CG_SOLVE_ITS
                  and v["x_err"] < CG_SOLVE_TOL[dtype],
                  f"cg: the {name} loop's {dtype} solve disagrees with the plain loop's")
        solves[dtype] = res
        del A, b, M, loops
    del b64
    for res in solves.values():
        for v in res.values():
            del v["x"]
    for name in ("xr", "p", "K1_dot", "K1_dot_sym"):
        kern[name]["solve_ms_per_it"] = {str(d)[6:]: {n: v["ms_per_it"] for n, v in r.items()}
                                         for d, r in solves.items()}
    del solves
    # the CLI's Jacobi line: the fused kernels on a driven path, with the
    # asymmetry of each operator it solves
    with fused_asymmetry([]) as asym:
        _, launches = drive_cli("jacobi", JACOBI_FLAGS,
                                need=("K1", "K2", "K1_dot_sym", "cg_update_xr", "cg_update_p"))
    log(f"[jacobi] asymmetry of the {len(asym)} operators on the fused route: max "
        f"{max(a for a, _ in asym):.3e}; marked symmetric {sorted({s for _, s in asym})}")
    check(launches["K1_dot"] == 0 and all(s for _, s in asym),
          "jacobi: a J2 operator took the full p.q form")
    kern["K1_dot_sym"]["asymmetry_j2_128"] = max(a for a, _ in asym)
    return kern, launches


# the J2 return-map kernel: the 128^3 main path's GP slots (node layout,
# the trailing element slots padded), a field about half plastic
J2_GPS = (128, 128, 128, 8)
J2_FLOPS = (140, 216)  # operations a GP, and those a plastic GP adds (the tangent)


def j2_field(gps, dev):
    """(eps, eps_p, alpha) in float64 on ``dev``: random strain directions
    with magnitudes spread from 0 to about twice first yield (~Sy/E), from
    a state that already carries plastic strain, so about half the GPs
    yield and some lie within roundoff of yield."""
    rng = np.random.default_rng(15)
    t = lambda a: torch.as_tensor(a, device=dev)
    eps = t(rng.standard_normal(gps + (6,))).mul_(1.5e-3).mul_(t(rng.random(gps + (1,))))
    eps_p = t(rng.standard_normal(gps + (6,))).mul_(1e-4)
    alpha = t(rng.standard_normal(gps)).abs_().mul_(1e-4)
    return eps, eps_p, alpha


def j2_compare(got, want, tol, Sy):
    """Max abs error, and max rel error per output (max abs difference over
    the plain output's max magnitude), of the kernel's outputs against the
    plain version's; ``plastic`` must agree wherever |f_trial| > tol Sy,
    and the tangent is compared where it does (at yield it jumps from C to
    C_ep)."""
    names = ("stress", "ctan", "eps_p", "alpha", "f_trial")
    same = got[5] == want[5]
    flips = int((~same).sum())
    near = want[4].abs() <= tol * Sy
    check(bool((same | near).all()), f"j2: plastic differs {flips} times away from yield")
    rel, abs_err = {}, 0.0
    for name, g, w in zip(names, got, want):
        d = (g - w).abs()
        if name == "ctan":
            d = d * same[..., None, None]
        abs_err = max(abs_err, float(d.max()))
        rel[name] = float(d.max() / w.abs().max())
    return abs_err, rel, flips


def phase_j2(dev):
    """The J2 return-map kernel (csrc/j2_return.cu) against its plain
    version (j2_radial_return) at the 128^3 main path's 16,777,216 GP
    slots, f32 and f64, about half plastic, two launches bitwise equal;
    timed at f32 beside the plain version and its bound; one
    ``J2Engine.homogenize``'s peak above what it is given against its
    outputs' bytes, beside the plain version's."""
    from macroc_tpu_torch import MaterialParams
    from macroc_tpu_torch.constitutive import J2Engine, J2State
    from macroc_tpu_torch.constitutive.elastic import elastic_matrix
    from macroc_tpu_torch.ops.j2_return import j2_return, j2_return_plain

    mat = MaterialParams()
    fields = j2_field(J2_GPS, dev)
    n = math.prod(J2_GPS)
    C = elastic_matrix(mat)
    out = {}
    for dtype, tol in TOLS.items():
        eps, eps_p, alpha = (f.to(dtype) for f in fields)
        got = j2_return(eps, eps_p, alpha, mat, C)
        again = j2_return(eps, eps_p, alpha, mat, C)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        del again
        want = j2_return_plain(eps, eps_p, alpha, mat, C)
        abs_err, rel, flips = j2_compare(got, want, tol, mat.Sy)
        share = float(got[5].float().mean())
        log(f"[j2] {J2_GPS} GPs {str(dtype)[6:]}: plastic share {share:.4f}, flags that differ "
            f"{flips} (all within {tol:g} Sy of yield); max rel err vs plain "
            + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
            + f" (bound {tol:g}); repeat bitwise {same}")
        check(same and all(v < tol for v in rel.values()) and 0.3 < share < 0.7,
              f"j2: the kernel disagrees with its plain version at {dtype}")
        del want
        n_plastic = int(got[5].sum())
        del got
        size = eps.element_size()
        nbytes = n * (13 * size + 50 * size + 1)
        flops = n * J2_FLOPS[0] + n_plastic * J2_FLOPS[1]
        bound_ms, bound_by = bound(nbytes, flops)
        ms = time_ms(lambda: j2_return(eps, eps_p, alpha, mat, C), 20)
        plain_ms = time_ms(lambda: j2_return_plain(eps, eps_p, alpha, mat, C), 3)
        eng, state = J2Engine(mat, dtype, dev), J2State(eps_p=eps_p, alpha=alpha)
        peak = peak_gib(lambda: eng.homogenize(eps, state))
        plain_peak = peak_gib(lambda: j2_return_plain(eps, eps_p, alpha, mat, C))
        # the outputs: stress, ctan, eps_p, alpha, f_trial, plastic, cost
        reckoned = n * (51 * size + 1) / 2**30
        log(f"[j2] {str(dtype)[6:]}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; bound "
            f"{bound_ms:.4f} ms ({bound_by}: {nbytes / 1e9:.3f} GB, {flops / 1e9:.2f} GFLOP), "
            f"{bound_ms / ms:.3f} of it, {nbytes / ms / 1e6:.1f} GB/s; one homogenize's peak "
            f"above its inputs {peak:.4f} GiB against its outputs' {reckoned:.4f} GiB "
            f"(bound +{64 / 1024:.4f}); the plain return map's {plain_peak:.4f} GiB")
        check(peak <= reckoned + 64 / 1024, "j2: homogenize allocates beyond its outputs")
        out[dtype] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=None, max_rel_err=rel,
                          peak_gib=peak, plain_peak_gib=plain_peak)
        del eps, eps_p, alpha, state
    kern = out[torch.float32]
    kern.update(library_note="no single PyTorch call does a J2 return map",
                f64={k: out[torch.float64][k] for k in ("max_abs_err", "ms", "plain_ms",
                                                        "bound_ms", "peak_gib")})
    return kern


def golden_configs():
    from macroc_tpu_torch import MacroConfig, MaterialParams

    # tests/make_goldens.py CONFIGS
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
        "gmres_circle_9x3x9": MacroConfig(
            nx=9, ny=3, nz=9, lx=10.0, ly=1.0, lz=10.0, bc_type=1, rad=2.0,
            ts=3, dt=0.05, ksp_type="gmres", dtype="float64"),
        "hetero_micro_fe2_3x2x2": MacroConfig(
            nx=3, ny=2, nz=2, lx=2.0, ly=1.0, lz=1.0, bc_type=0, ts=2, dt=0.1,
            newton_max_its=5, micro_n=4, micro_type=1,
            micro_mat_2=MaterialParams(E=1.0e6, nu=0.3, Sy=5.0e3, Ka=2.0e6),
            dtype="float64"),
    }


def golden_failures(name, got, golden):
    """Mismatches against a golden, with tests/test_torch_golden.py's
    criteria: test_golden.py's tolerances for the goldens that are robust
    to summation order, the roundoff bounds for the three that pin last
    bits (circle_elastic_9x3x9, bending_plastic_5x3x3, gmres_circle_9x3x9)."""
    exact = name not in ("circle_elastic_9x3x9", "bending_plastic_5x3x3",
                         "gmres_circle_9x3x9")
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
    """The goldens at f64 on the card; every J2 one (all but the FE² one)
    through the return-map kernel."""
    from macroc_tpu_torch.constitutive import engine_kind
    from macroc_tpu_torch.ops.j2_return import j2_return
    from macroc_tpu_torch.problem import run_summary

    for name, cfg in golden_configs().items():
        with open(os.path.join(GOLDEN_DIR, f"{name}.json")) as f:
            golden = json.load(f)
        t0 = time.perf_counter()
        j2_return.launches = 0
        got = run_summary(cfg, dev)
        j2_launches = j2_return.launches
        res_dev = max(
            float(np.max(np.abs(np.subtract(gs["res_norms"], es["res_norms"]))
                         / np.maximum(np.abs(es["res_norms"]), 1e-300)))
            for gs, es in zip(got["steps"], golden["steps"])
        )
        bad = golden_failures(name, got, golden)
        log(f"[golden] {name}: {'PASS' if not bad else 'FAIL'} in "
            f"{time.perf_counter() - t0:.2f} s; KSP its "
            f"{[s['ksp_its'] for s in got['steps']]} (golden "
            f"{[s['ksp_its'] for s in golden['steps']]}); max |RES| rel dev {res_dev:.2e}; "
            f"j2_return launches {j2_launches}" + (f"; {bad}" if bad else ""))
        check(not bad, f"golden {name}")
        check((j2_launches > 0) == (engine_kind(cfg) == "j2"),
              f"golden {name}: the J2 kernel ran {j2_launches} times")


def drive_cli(tag, flags, out_dir=None, ckpt_dir=None, need=("K1", "K2")):
    """``macroc_tpu_torch.cli`` on ``flags`` with the K1/K2 launch counters
    set to 0 just before and read just after; checks every step converged
    with finite diagnostics and that the kernels in ``need`` launched.
    Output goes to ``out_dir`` (a temporary directory when None),
    checkpoints to ``ckpt_dir`` (default ``out_dir/checkpoints``).  Returns
    (result, launches)."""
    from macroc_tpu_torch import cli
    from macroc_tpu_torch.ops.assembly import assemble_stencil_soa_kernel
    from macroc_tpu_torch.ops.cg_fused import cg_update_p, cg_update_xr
    from macroc_tpu_torch.ops.j2_return import j2_return
    from macroc_tpu_torch.ops.stencil_spmv import (
        stencil_matvec,
        stencil_matvec_dot,
        stencil_matvec_dot_sym,
    )

    log(f"[{tag}] python -m macroc_tpu_torch " + " ".join(flags))
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = out_dir or tmp
        argv = flags + ["-output_dir", out_dir, "-checkpoint_dir",
                        ckpt_dir or os.path.join(out_dir, "checkpoints")]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        stencil_matvec.launches = stencil_matvec.narrow_launches = 0
        stencil_matvec_dot.launches = stencil_matvec_dot_sym.launches = 0
        cg_update_xr.launches = cg_update_p.launches = 0
        assemble_stencil_soa_kernel.launches = j2_return.launches = 0
        result = cli.run(argv)
        launches = dict(K1=stencil_matvec.launches,
                        K1_narrow=stencil_matvec.narrow_launches,
                        K2=assemble_stencil_soa_kernel.launches,
                        K1_dot=stencil_matvec_dot.launches,
                        K1_dot_sym=stencil_matvec_dot_sym.launches,
                        cg_update_xr=cg_update_xr.launches,
                        cg_update_p=cg_update_p.launches,
                        j2_return=j2_return.launches)
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
    log(f"[{tag}] launches during the run: K1 {launches['K1']} (narrow operator "
        f"{launches['K1_narrow']}, p.q form {launches['K1_dot']}, half-stencil p.q form "
        f"{launches['K1_dot_sym']}), K2 {launches['K2']}, "
        f"cg_update_xr {launches['cg_update_xr']}, cg_update_p {launches['cg_update_p']}, "
        f"j2_return {launches['j2_return']}; "
        f"peak device memory {peak / 2**30:.2f} GiB ({base / 2**30:.2f} GiB held "
        f"before the run); phases (s) "
        + json.dumps({k: round(v, 4) for k, v in result["phases"].items()}))
    check(all(launches[k] > 0 for k in need), f"{tag}: a kernel of the path never launched")
    return result, launches


def info_rows(out_dir):
    with open(os.path.join(out_dir, "info.dat")) as f:
        return f.read().splitlines()


def compare_rows(tag, got, want):
    """info.dat rows of a resumed run against the uninterrupted run's: step,
    time, load and yielded-GP count exactly, force and f_trial_max to
    RESUME_RTOL."""
    check(len(got) == len(want), f"{tag}: {len(got)} info.dat rows, want {len(want)}")
    worst = 0.0
    for g, w in zip(got, want):
        g, w = g.split("\t"), w.split("\t")
        check((g[0], g[1], g[2], g[5]) == (w[0], w[1], w[2], w[5]),
              f"{tag}: info.dat row {w[0]} differs: {g} vs {w}")
        for a, b in zip(g[3:5], w[3:5]):
            worst = max(worst, abs(float(a) - float(b)) / max(abs(float(b)), 1e-30))
    log(f"[{tag}] resumed info.dat rows {[r.split(chr(9))[0] for r in got]} against the "
        f"uninterrupted run: text identical {got == want}, max rel dev of force and "
        f"f_trial_max {worst:.2e} (bound {RESUME_RTOL:g})")
    check(worst <= RESUME_RTOL, f"{tag}: resumed rows deviate by {worst:.2e}")


def phase_main(dev):
    launches = drive_cli("main", MAIN_FLAGS, need=("K1", "K2", "j2_return"))[1]
    # MG preconditions through the host loop: full K1, no p.q form
    check(launches["K1_dot"] == launches["K1_dot_sym"] == 0, "main: an MG solve took the fused route")
    return launches


def phase_solvers(dev):
    """The main line with bf16 MG level operators and with GMRES; the
    production grid with the matrix-free operator (Jacobi, no kernel on its
    path: the JAX package's matfree path has none either) beside the
    assembled stencil with Jacobi, whose KSP counts it must match to
    roundoff."""
    _, bf16 = drive_cli("main bf16 MG", MAIN_FLAGS + ["-mg_dtype", "bfloat16"])
    check(bf16["K1_narrow"] > 0, "bf16 MG: K1's narrow operator form never launched")
    drive_cli("main gmres", MAIN_FLAGS + ["-ksp_type", "gmres"])
    mf, mf_launches = drive_cli("production matfree",
                                PRODUCTION_J2 + ["-ts", "3", "-operator", "matfree"], need=())
    check(mf_launches["K1"] == 0 and mf_launches["K2"] == 0,
          "matfree: the stencil kernels ran, so the operator was assembled")
    st, _ = drive_cli("production stencil jacobi",
                      PRODUCTION_J2 + ["-ts", "3", "-operator", "stencil", "-pc_type", "jacobi"])
    its = lambda r: [k for h in r["history"] for k in h["ksp_its"]]
    close = all(abs(a - b) <= max(2, 0.02 * b) for a, b in zip(its(mf), its(st)))
    log(f"[solvers] Jacobi KSP its matfree {its(mf)} vs stencil {its(st)} (bound: 2% or 2)")
    check(len(its(mf)) == len(its(st)) and close, "matfree and stencil Jacobi counts differ")
    return bf16["K1_narrow"]


def phase_checkpoint(dev):
    """scripts/production_run.sh's line as written (J2): 4 steps with a
    checkpoint every 2, resumed to 6 steps in the same output directory,
    against an uninterrupted 6-step run."""
    from macroc_tpu_torch.utils import checkpoint as ckpt

    with tempfile.TemporaryDirectory() as first, tempfile.TemporaryDirectory() as whole:
        r1, _ = drive_cli("checkpoint first", PRODUCTION_J2 + ["-ts", "4", "-checkpoint_freq", "2"],
                          out_dir=first)
        ck = os.path.join(first, "checkpoints")
        check(sorted(os.listdir(ck)) == ["step_2", "step_4"], f"checkpoints {os.listdir(ck)}")
        step_dir = os.path.join(ck, "step_4")
        nbytes = sum(os.path.getsize(os.path.join(step_dir, f)) for f in os.listdir(step_dir))
        like = (torch.zeros_like(r1["u"]), type(r1["state"])(
            *(torch.zeros_like(t) for t in (r1["state"].eps_p, r1["state"].alpha))))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step, (u, state) = ckpt.load_latest(ck, like)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        check(step == 4 and torch.equal(u, r1["u"]) and torch.equal(state.eps_p, r1["state"].eps_p)
              and torch.equal(state.alpha, r1["state"].alpha), "checkpoint read back differs")
        log(f"[checkpoint] step_4: {nbytes} bytes (u, eps_p, alpha); write "
            f"{r1['phases']['checkpoint'] / 2:.4f} s per checkpoint (mean of 2), read to the "
            f"card {read_s:.4f} s; read back bit for bit")
        del r1, u, state, like
        r2, _ = drive_cli("checkpoint resume", PRODUCTION_J2 + ["-ts", "6", "-resume"],
                          out_dir=first)
        check([h["ts"] for h in r2["history"]] == [4, 5], "resume did not start at step 4")
        drive_cli("checkpoint whole", PRODUCTION_J2 + ["-ts", "6"], out_dir=whole)
        compare_rows("checkpoint", info_rows(first), info_rows(whole))


def phase_profile(dev):
    """-profile_dir on 2 steps of the production_run.sh line: the Chrome
    trace that torch.profiler writes must hold K1's kernel."""
    with tempfile.TemporaryDirectory() as out:
        prof = os.path.join(out, "profile")
        _, launches = drive_cli("profile", PRODUCTION_J2 + ["-ts", "2", "-profile_dir", prof],
                                out_dir=out)
        files = [f for f in os.listdir(prof) if f.startswith("trace_") and f.endswith(".json")]
        check(len(files) == 1, f"profile: trace files {files}")
        path = os.path.join(prof, files[0])
        size = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k1 = [e for e in kernels if "stencil_spmv_kernel" in e.get("name", "")]
    log(f"[profile] trace {size / 2**20:.1f} MiB, {len(events)} events, {len(kernels)} device "
        f"kernels ({sum(e.get('dur', 0) for e in kernels) / 1e3:.1f} ms), K1 "
        f"{len(k1)} ({sum(e.get('dur', 0) for e in k1) / 1e3:.1f} ms; "
        f"{launches['K1']} launches counted)"
        + (f", named {k1[0]['name'][:80]!r}" if k1 else ""))
    check(len(k1) > 0, "profile: K1 is not in the profiler trace")


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
    from macroc_tpu_torch.utils import checkpoint as ckpt

    launches = {"fe2_production": drive_cli("fe2 production", FE2_PRODUCTION)[1],
                "fe2_bending": drive_cli("fe2 bending", FE2_BENDING)[1]}
    with tempfile.TemporaryDirectory() as whole, tempfile.TemporaryDirectory() as resumed:
        with fused_asymmetry([]) as asym:
            result, launches["fe2_full"] = drive_cli("fe2 full", FE2_FULL, out_dir=whole)
        # the micro-FE tangent is symmetric to its micro CG tolerance only:
        # Jacobi PCG on this grid takes the fused route with the full p.q form
        log(f"[fe2 full] asymmetry max|A[o,d,e,p] - A[26-o,e,d,p+off]| / max|A| of the "
            f"{len(asym)} operators on the fused route: max {max(a for a, _ in asym):.3e}, "
            f"min {min(a for a, _ in asym):.3e}; marked symmetric {sorted({s for _, s in asym})}")
        check(not any(s for _, s in asym) and launches["fe2_full"]["K1_dot"] > 0
              and launches["fe2_full"]["K1_dot_sym"] == 0,
              "fe2 full: the micro-FE operator did not take the full p.q form")
        fe2_asymmetry = max(a for a, _ in asym)
        cost = result["diag"].cost
        log(f"[fe2 full] micro CG its per real GP in the last step: min "
            f"{float(cost.min()):.0f}, mean {float(cost.mean()):.1f}, max "
            f"{float(cost.max()):.0f} over {cost.numel()} GPs")
        check(bool((cost > 0).all()), "fe2 full: a real GP ran no micro solve")
        # the MicroState checkpoint the run wrote at step 2, taken up by a
        # -resume run that redoes step 2 (the files equal those of a run
        # stopped after step 1: later steps do not touch them)
        ck = os.path.join(whole, "checkpoints")
        step_dir = os.path.join(ck, "step_2")
        nbytes = sum(os.path.getsize(os.path.join(step_dir, f)) for f in os.listdir(step_dir))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.load_latest(ck, (result["u"], result["state"]))
        torch.cuda.synchronize()
        log(f"[checkpoint fe2] step_2: {nbytes} bytes (u, micro eps_p, alpha, u); write "
            f"{result['phases']['checkpoint']:.4f} s, read to the card "
            f"{time.perf_counter() - t0:.4f} s")
        res, _ = drive_cli("checkpoint fe2 resume", FE2_FULL + ["-resume"], out_dir=resumed,
                           ckpt_dir=ck)
        check(type(res["state"]).__name__ == "MicroState", "fe2 resume: not a MicroState")
        check([h["ts"] for h in res["history"]] == [2], "fe2 resume did not start at step 2")
        compare_rows("checkpoint fe2", info_rows(resumed), info_rows(whole)[2:])
        dev_u = rel_err(res["u"], result["u"])
        dev_micro = rel_err(res["state"].u, result["state"].u)
        log(f"[checkpoint fe2] resumed step 2 against the uninterrupted one: u max rel dev "
            f"{dev_u:.2e}, micro u {dev_micro:.2e}")
        check(max(dev_u, dev_micro) <= RESUME_RTOL, "fe2 resume: fields deviate")
        del result, res
    result, launches["fe2_plastic"] = drive_cli("fe2 plastic", FE2_PLASTIC)
    d = result["diag"]
    log(f"[fe2 plastic] last step: {int(d.non_linear.sum())} non-linear GPs, "
        f"{int((d.cost > 0).sum())} of {d.cost.numel()} real GPs solved in full by "
        f"the last homogenize, {d.micro_unconverged} micro solves at the Newton cap")
    check(bool(d.non_linear.any()), "fe2 plastic: no GP yielded")
    return launches, fe2_asymmetry


# the JAX package's documented multi-device line (scripts/pod_run.sh: the
# reference's 100^3 strong-scaling grid) as written, 2 of its 10 steps:
# pc_type auto (MG), f32; pod_run.sh pins -da_processors_x to the process
# count when MACROC_NUM_PROCESSES is set (POD_RUN_2)
POD_RUN = [
    "-da_grid_x", "100", "-da_grid_y", "100", "-da_grid_z", "100", "-lx", "50", "-ly", "50",
    "-lz", "50", "-ts", "2", "-dt", "0.001", "-bc_type", "1", "-rad", "10",
    "-newton_max_its", "4", "-checkpoint_freq", "0", "-log_phases",
]
POD_RUN_2 = POD_RUN + ["-da_processors_x", "2"]
# the bending_plastic_5x3x3 golden's flags (tests/make_goldens.py), f64
PLASTIC_5 = [
    "-da_grid_x", "5", "-da_grid_y", "3", "-da_grid_z", "3", "-lx", "4", "-ly", "2", "-lz", "2",
    "-bc_type", "0", "-ts", "4", "-dt", "0.15", "-newton_max_its", "10", "-dtype", "float64",
]
# N ranks against one process on the pod_run.sh and production FE² lines,
# and 1 against 2 ranks resuming one checkpoint: info.dat rows to this
# relative bound (f32 dots, restrictions and coarse tangents summed in
# another order through the solves), yielded-GP counts exactly, KSP its per
# solve within 2% or 2
POD_RTOL = 1e-4
# scripts/production_run.sh's line as written (J2, pc_type auto -> MG with
# lines along y), 3 steps, f32, on rank grids that split the line dimension:
# 50x3x50 pads y to 4, which coarsens once, so the hierarchy differs from
# one process's and from the automatic 2-rank split's (1,1,2).  Solves of
# one system to ksp_rtol (tests/test_dist.py:129-135): the same Newton
# iterations, info.dat rows within POD_RTOL and KSP its per solve within
# LINESPLIT_KSP (absolute, relative) of the unpadded runs; the two split
# grids share the padded hierarchy, so within 2% or 2 of each other
LINESPLIT = PRODUCTION_J2 + ["-ts", "3"]
LINESPLIT_GRIDS = [(1, 2, 1), (2, 2, 1)]
LINESPLIT_KSP = (4, 0.15)
# the per-rank kernel shapes against the plain versions, relative: K2 (f32,
# f64) as PR 5 held it; K1 to the same f32 bound and ~9 f64 ulps (its 81
# products per entry are summed in another order than the plain version's;
# the largest block here, 128^3 over 2, deviates by 1.0e-15 at f64)
DIST_TOLS = {"K2": {torch.float32: 1e-6, torch.float64: 1e-15},
             "K1": {torch.float32: 1e-6, torch.float64: 2e-15}}
# one rank of a run: macroc_tpu_torch.cli with the kernels' launch counters
# set to 0 before it; prints its history, counts, process-group backend,
# the bytes of its state and, per micro-FE homogenize, the GPs solved in
# full and the device memory held after it and at the peak so far (GiB)
RANK_PROGRAM = r"""
import json, os, sys
import torch
from macroc_tpu_torch import cli
from macroc_tpu_torch.constitutive.microfe import MicroFEEngine
from macroc_tpu_torch.ops.assembly import assemble_stencil_soa_kernel as k2
from macroc_tpu_torch.ops.stencil_spmv import stencil_matvec as k1
from macroc_tpu_torch.parallel import distributed

backend = []
shutdown = distributed.shutdown
distributed.shutdown = lambda: (backend.append(torch.distributed.get_backend()), shutdown())
micro = []
homogenize = MicroFEEngine.homogenize

def watched(self, eps, state):
    r = homogenize(self, eps, state)
    micro.append([int((r.cost > 0).sum()), round(torch.cuda.memory_allocated() / 2**30, 3),
                  round(torch.cuda.max_memory_allocated() / 2**30, 3)])
    return r

MicroFEEngine.homogenize = watched
k1.launches = k1.narrow_launches = 0
k2.launches = 0
result = cli.run(json.loads(sys.argv[1]))
print("RANK " + json.dumps(dict(
    rank=int(os.environ.get("MACROC_PROCESS_ID", "0")), backend=(backend or [None])[0],
    K1=k1.launches, K2=k2.launches, history=result["history"], phases=result["phases"],
    state=type(result["state"]).__name__, micro=micro,
    state_gib=sum(t.numel() * t.element_size() for t in vars(result["state"]).values()) / 2**30,
    peak_gib=torch.cuda.max_memory_allocated() / 2**30)), flush=True)
"""


# the rank-grid costs of one CG iteration on the pod_run.sh block, each
# rank timing on the host clock (they share the card): a 2-element
# all-reduce, the halo exchange of x, K1's halo form, and both together;
# and MG's two all-reduces across ranks: the level-1 tangents (once per
# Newton iteration) and the restricted coarse vector (once per V-cycle)
COMM_PROGRAM = r"""
import json, sys, time
import torch
import torch.nn.functional as F
from macroc_tpu_torch.grid import StructuredGrid3D
from macroc_tpu_torch.ops.stencil_spmv import stencil_matvec
from macroc_tpu_torch.parallel import distributed, halo
from macroc_tpu_torch.parallel.mesh import RankMesh

distributed.maybe_initialize()
dev = distributed.local_device("cuda")
nx, ny, nz, procs = json.loads(sys.argv[1])
mesh = RankMesh(StructuredGrid3D(nx, ny, nz, 50.0, 50.0, 50.0, procs=tuple(procs)),
                distributed.Comm(dev))
gen = torch.Generator(device=dev)
gen.manual_seed(8)
A = torch.randn((27, 3, 3) + mesh.block, device=dev, generator=gen)
x = torch.randn((3,) + mesh.block, device=dev, generator=gen)
xe = F.pad(x, (1, 1, 1, 1, 1, 1))
dots = torch.randn(2, device=dev, generator=gen)

def per_call_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    torch.distributed.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3

from macroc_tpu_torch.solve.mg import coarse_size
coarse = [coarse_size(n) for n in mesh.node_shape]
tangents = torch.zeros(tuple(c - 1 for c in coarse) + (8, 6, 6), device=dev)
rc = torch.zeros((3,) + tuple(coarse), device=dev)
out = dict(rank=mesh.comm.rank, backend=mesh.comm.backend,
           level1_bytes=tangents.numel() * 4, restrict_bytes=rc.numel() * 4,
           level1_allreduce_ms=per_call_ms(lambda: mesh.comm.sum(tangents), 3),
           restrict_allreduce_ms=per_call_ms(lambda: mesh.comm.sum(rc), 20),
           allreduce_ms=per_call_ms(lambda: mesh.comm.sum(dots), 200),
           halo_exchange_ms=per_call_ms(lambda: halo.halo_exchange(x, mesh, dims=(1, 2, 3)), 100),
           k1_halo_ms=per_call_ms(lambda: stencil_matvec(A, xe, halo=True), 100),
           matvec_local_ms=per_call_ms(lambda: halo.stencil_matvec_local(A, x, mesh), 100))
if procs[1] > 1:
    # MG's line gather of a residual along a split y (one per colour
    # half-sweep on level 0)
    out.update(line_gather_bytes=x.numel() * 4 * procs[1],
               line_gather_ms=per_call_ms(lambda: halo.axis_gather(x, mesh, 1, 2), 100))
print("RANK " + json.dumps(out), flush=True)
distributed.shutdown()
"""


def launch_ranks(tag, flags, n, out_dir, ckpt_dir=None):
    """``RANK_PROGRAM`` (the CLI) on ``flags`` as n ranks; checks every
    step converged and every rank launched K1 and K2."""
    from macroc_tpu_torch.parallel.launch import spawn_local

    argv = flags + ["-output_dir", out_dir] + (["-checkpoint_dir", ckpt_dir] if ckpt_dir else [])
    records = spawn_local(RANK_PROGRAM, json.dumps(argv), n)
    for r in records:
        h = r["history"]
        log(f"[{tag}] rank {r['rank']} of {n} (backend {r['backend']}): step seconds "
            f"{[round(s['seconds'], 4) for s in h]}, KSP its {[s['ksp_its'] for s in h]}, "
            f"launches K1 {r['K1']} K2 {r['K2']}, peak device memory {r['peak_gib']:.2f} GiB"
            + (f", phases (s) {json.dumps({k: round(v, 4) for k, v in r['phases'].items()})}"
               if r["phases"] else ""))
        check(all(s["converged"] for s in h), f"{tag}: a step did not converge")
        check(r["K1"] > 0 and r["K2"] > 0, f"{tag}: rank {r['rank']} launched no K1 or K2")
    return records


def summed(records):
    """The K1/K2 launches of a run, summed over its ranks."""
    return {k: sum(r[k] for r in records) for k in ("K1", "K2")}


def compare_ranks(tag, h1, h2, t1, t2, rtol, ksp=(2, 0.02), names=("1 process", "2 ranks")):
    """The run ``names[1]`` against ``names[0]``: the same Newton
    iterations, KSP its per solve within ``ksp[0]`` or the fraction
    ``ksp[1]``, info.dat rows (yielded GPs exactly) within ``rtol``;
    returns the worst row deviation."""
    check([len(s["res_norms"]) for s in h1] == [len(s["res_norms"]) for s in h2],
          f"{tag}: Newton iteration counts differ")
    its = lambda h: [k for s in h for k in s["ksp_its"]]
    check(len(its(h1)) == len(its(h2)) and all(
        abs(a - b) <= max(ksp[0], ksp[1] * a) for a, b in zip(its(h1), its(h2))),
        f"{tag}: KSP its {its(h2)} vs {its(h1)}")
    check(len(t1) == len(t2) and all(r[5] == q[5] for r, q in zip(t1, t2)),
          f"{tag}: info.dat rows or yielded-GP counts differ")
    worst = max(abs(a - b) / max(abs(a), 1e-30) for r, q in zip(t1, t2) for a, b in zip(r, q))
    log(f"[{tag}] {names[1]} vs {names[0]}: Newton its {[len(s['res_norms']) for s in h2]}, "
        f"KSP its {its(h2)} vs {its(h1)} (bound {ksp[0]} or {ksp[1]:.0%}), info.dat max rel dev "
        f"{worst:.3e} (bound {rtol:g}); per KSP iteration {step_ms_per_its(h2):.4f} ms on "
        f"{names[1]} vs {step_ms_per_its(h1):.4f} ms on {names[0]} (ranks sharing one card: "
        "not a scaling figure)")
    check(worst <= rtol, f"{tag}: info.dat rows deviate by {worst:.3e}")
    return worst


def info_table(out_dir):
    return [[float(v) for v in row.split("\t")] for row in info_rows(out_dir)]


def dist_shapes():
    """(label, node grid, rank grid) of the decompositions the dist phase
    runs, of 128^3 over 2, 4 and 8 ranks and of the scaling sweep's 48^3
    over 2, 4 and 8, by decide_processor_grid."""
    from macroc_tpu_torch.grid import decide_processor_grid

    grids = [("pod_run 100^3", (100,) * 3, 2, (2, None, None)),
             ("plastic 5x3x3", (5, 3, 3), 2, (None,) * 3),
             ("fe2 production 50x3x50", (50, 3, 50), 2, (None,) * 3),
             ("fe2 full 10x3x10", (10, 3, 10), 2, (None,) * 3)]
    grids += [("linesplit 50x3x50", (50, 3, 50), int(np.prod(p)), p) for p in LINESPLIT_GRIDS]
    grids += [("128^3", (128,) * 3, n, (None,) * 3) for n in (2, 4, 8)]
    # scripts/scaling_sweep_torch.py's grid at its rank counts
    grids += [("scaling 48^3", (48,) * 3, n, (None,) * 3) for n in (2, 4, 8)]
    return [(f"{label} over {n}", g, decide_processor_grid(n, *g, fixed=fixed))
            for label, g, n, fixed in grids]


def phase_dist(dev):
    """The domain-decomposed run: per-rank kernel shapes; the pod_run.sh
    line (MG across ranks) and the production FE² line as 2 processes on
    the card against 1 process; FE2_FULL's MicroState checkpoint written by
    2 ranks and taken up by 1 and by 2; the f64 plastic golden line at 2
    ranks, writing its PVTU pieces per rank, against 1; and the NCCL run
    where there is a card per rank."""
    from macroc_tpu_torch.fem.element import b_matrix
    from macroc_tpu_torch.ops import assembly as asm
    from macroc_tpu_torch.ops.stencil_spmv import stencil_matvec, stencil_matvec_soa
    from macroc_tpu_torch.parallel.launch import spawn_local

    gen = torch.Generator(device=dev)
    for label, g, procs in dist_shapes():
        padded = tuple(-(-n // p) * p for n, p in zip(g, procs))
        block = tuple(n // p for n, p in zip(padded, procs))
        split = tuple(p > 1 for p in procs)
        sl = tuple(slice(0, b if s else b - 1) for b, s in zip(block, split))
        grid_l = tuple(b + int(s) for b, s in zip(block, split))
        errs = []
        for dtype in (torch.float32, torch.float64):
            gen.manual_seed(6)
            B = torch.as_tensor(b_matrix((1.0, 1.0, 1.0)), dtype=dtype, device=dev)
            ct = torch.randn(block + (8, 6, 6), dtype=dtype, device=dev, generator=gen)[sl]
            A = asm.assemble_stencil_soa_kernel(ct, B, 0.1, grid_l)
            same = torch.equal(asm.assemble_stencil_soa_kernel(ct, B, 0.1, grid_l), A)
            e2 = rel_err(A.reshape(243, *grid_l), asm.assemble_stencil_soa_plain(ct, B, 0.1, grid_l))
            del A, ct
            A = torch.randn((27, 3, 3) + block, dtype=dtype, device=dev, generator=gen)
            x = torch.randn((3,) + tuple(b + 2 for b in block), dtype=dtype, device=dev,
                            generator=gen)
            e1 = rel_err(stencil_matvec(A, x, halo=True), stencil_matvec_soa(A, x, halo=True))
            del A, x
            errs.append(f"{str(dtype)[6:]} K2 {e2:.3e} (repeat bitwise {same}), K1 halo {e1:.3e}")
            check(same and e2 <= DIST_TOLS["K2"][dtype] and e1 <= DIST_TOLS["K1"][dtype],
                  f"per-rank kernels disagree at {label} {dtype}: K2 {e2:.3e} bitwise {same}, "
                  f"K1 {e1:.3e}")
        log(f"[dist shapes] {label} ranks {procs}: block {block}, K2 on a node-shaped tangent "
            f"slice {tuple(s.stop for s in sl)} elements -> grid {grid_l}, K1 halo on x "
            f"{tuple(b + 2 for b in block)}: " + "; ".join(errs))
    # the pod_run.sh block's kernels timed, f32 (two ranks share the card)
    label, g, procs = dist_shapes()[0]
    block = tuple(n // p for n, p in zip(g, procs))
    gen.manual_seed(7)
    A = torch.randn((27, 3, 3) + block, device=dev, generator=gen)
    x = torch.randn((3,) + tuple(b + 2 for b in block), device=dev, generator=gen)
    k1_ms = time_ms(lambda: stencil_matvec(A, x, halo=True), 50)
    del A, x
    log(f"[dist shapes] {label}: K1 halo form on the rank block {block} f32 {k1_ms:.4f} ms")
    grid_args = json.dumps(list(g) + [list(procs)])
    for r in spawn_local(COMM_PROGRAM, grid_args, 2):
        log(f"[dist comm] rank {r['rank']} of 2 ({r['backend']}, sharing the card), host ms per "
            f"call: 2-element all-reduce {r['allreduce_ms']:.4f}, halo exchange of x "
            f"{r['halo_exchange_ms']:.4f}, K1 halo form {r['k1_halo_ms']:.4f}, exchange + K1 "
            f"{r['matvec_local_ms']:.4f}; MG level-1 tangents all-reduce "
            f"({r['level1_bytes']} B, once per Newton iteration) {r['level1_allreduce_ms']:.4f}, "
            f"restricted vector all-reduce ({r['restrict_bytes']} B, once per V-cycle) "
            f"{r['restrict_allreduce_ms']:.4f}")
    # MG's line gather on the production grid split along y
    grid_args = json.dumps([50, 3, 50, list(LINESPLIT_GRIDS[0])])
    for r in spawn_local(COMM_PROGRAM, grid_args, 2):
        log(f"[dist comm linesplit] rank {r['rank']} of 2 ranks {LINESPLIT_GRIDS[0]} "
            f"({r['backend']}, sharing the card), host ms per call: line gather of the residual "
            f"({r['line_gather_bytes']} B, 4 nu per V-cycle) {r['line_gather_ms']:.4f}, halo "
            f"exchange of x {r['halo_exchange_ms']:.4f}, 2-element all-reduce "
            f"{r['allreduce_ms']:.4f}, restricted vector all-reduce {r['restrict_allreduce_ms']:.4f}")
    return dist_lines(), k1_ms


def dist_lines():
    """The dist phase's CLI lines, each as separate processes: returns
    each 2-rank line's launches, summed over its ranks."""
    launches = {}
    with tempfile.TemporaryDirectory() as one, tempfile.TemporaryDirectory() as two:
        r1 = launch_ranks("dist pod_run 1 process", POD_RUN, 1, one)[0]
        r2 = launch_ranks("dist pod_run 2 ranks", POD_RUN_2, 2, two)
        launches["dist_pod_mg_2ranks"] = summed(r2)
        check(r2[0]["backend"] == "gloo", f"dist pod_run: backend {r2[0]['backend']}, want gloo "
              "(two ranks share the one card)")
        compare_ranks("dist pod_run", r1["history"], r2[0]["history"], info_table(one),
                      info_table(two), POD_RTOL)
    launches.update(linesplit_lines())
    with tempfile.TemporaryDirectory() as one, tempfile.TemporaryDirectory() as two:
        r1 = launch_ranks("dist fe2 production 1 process", FE2_PRODUCTION, 1, one)[0]
        r2 = launch_ranks("dist fe2 production 2 ranks", FE2_PRODUCTION, 2, two)
        launches["dist_fe2_production_2ranks"] = summed(r2)
        compare_ranks("dist fe2 production", r1["history"], r2[0]["history"], info_table(one),
                      info_table(two), POD_RTOL)
        log(f"[dist fe2 production] peak device memory per rank "
            f"{[round(r['peak_gib'], 2) for r in r2]} GiB on 2 ranks against "
            f"{r1['peak_gib']:.2f} GiB on 1 process")
        for r in r2 + [r1]:
            log(f"[dist fe2 production] rank {r['rank']} of {len(r2) if r is not r1 else 1}: "
                f"micro state {r['state_gib']:.3f} GiB; per homogenize [GPs solved in full, GiB "
                f"held after it, peak GiB so far] {r['micro']}")
    with tempfile.TemporaryDirectory() as out:
        # FE2_FULL's checkpoint at step 2 written by 2 ranks (one file each),
        # taken up by 1 process and by 2 ranks, each redoing step 2
        ck = os.path.join(out, "checkpoints")
        r2 = launch_ranks("dist fe2 full 2 ranks", FE2_FULL + ["-ts", "2"], 2,
                          os.path.join(out, "first"), ckpt_dir=ck)
        launches["dist_fe2_full_2ranks"] = summed(r2)
        files = sorted(os.listdir(os.path.join(ck, "step_2")))
        check(files == ["proc_0.json", "proc_0.npz", "proc_1.json", "proc_1.npz"],
              f"dist fe2 checkpoint: files {files}")
        resumed = {}
        for n in (1, 2):
            rr = launch_ranks(f"dist fe2 resume on {n}", FE2_FULL + ["-resume"], n,
                              os.path.join(out, f"resume{n}"), ckpt_dir=ck)
            check(all(r["state"] == "MicroState" for r in rr)
                  and [s["ts"] for s in rr[0]["history"]] == [2],
                  f"dist fe2 resume on {n}: not a MicroState taken up at step 2")
            resumed[n] = info_table(os.path.join(out, f"resume{n}"))
            if n == 2:
                launches["dist_fe2_resume_2ranks"] = summed(rr)
        worst = max(abs(a - b) / max(abs(a), 1e-30)
                    for r, q in zip(resumed[1], resumed[2]) for a, b in zip(r, q))
        log(f"[dist fe2 resume] the 2 ranks' MicroState checkpoint taken up by 1 process and by "
            f"2 ranks: step-2 info.dat rows within {worst:.3e} (bound {POD_RTOL:g})")
        check(len(resumed[1]) == len(resumed[2]) == 1 and resumed[1][0][5] == resumed[2][0][5]
              and worst <= POD_RTOL, "dist fe2 resume: the resumed rows differ")
    with tempfile.TemporaryDirectory() as one, tempfile.TemporaryDirectory() as two:
        h1 = launch_ranks("dist plastic 1 process", PLASTIC_5, 1, one)[0]["history"]
        r2 = launch_ranks("dist plastic 2 ranks", PLASTIC_5 + ["-vtu_freq", "1"], 2, two)
        launches["dist_plastic_vtu_2ranks"] = summed(r2)
        bad = roundoff_failures(r2[0]["history"], h1)
        log(f"[dist plastic] 2 ranks vs 1 process at f64: nl_gps "
            f"{[s['nl_gps'] for s in r2[0]['history']]}, KSP its "
            f"{[s['ksp_its'] for s in r2[0]['history']]} vs {[s['ksp_its'] for s in h1]}: "
            + ("PASS" if not bad else f"FAIL {bad}"))
        check(not bad, "dist plastic: 2 ranks outside the roundoff bounds")
        check_pieces(two, PLASTIC_5, 2)
    if torch.cuda.device_count() >= 2:
        with tempfile.TemporaryDirectory() as two:
            r = launch_ranks("dist pod_run 2 ranks nccl", POD_RUN_2, 2, two)
            check(r[0]["backend"] == "nccl", "dist nccl: the backend rule did not pick NCCL")
    else:
        log(f"[dist] the NCCL run (one card per rank) not made: {torch.cuda.device_count()} card")
    return launches


def linesplit_lines():
    """The production_run.sh J2 line (MG, lines along y) on the rank grids
    of LINESPLIT_GRIDS, which split y ((1,2,1) as 2 ranks, (2,2,1) as 4,
    sharing the card), against 1 process and the automatic 2-rank split;
    returns each split line's launches, summed over its ranks."""
    def pinned(p):
        return LINESPLIT + [v for a, q in zip("xyz", p) for v in (f"-da_processors_{a}", str(q))]

    lines = [("1 process", LINESPLIT, 1), ("auto 2 ranks", LINESPLIT, 2)] + [
        (f"ranks {p}", pinned(p), int(np.prod(p))) for p in LINESPLIT_GRIDS]
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, flags, n in lines:
            out = os.path.join(tmp, name.replace(" ", "_"))
            records = launch_ranks(f"linesplit {name}", flags, n, out)
            runs[name] = (records[0]["history"], info_table(out), records)
    launches = {}
    for p in LINESPLIT_GRIDS:
        name = f"ranks {p}"
        h, t, records = runs[name]
        for ref in ("1 process", "auto 2 ranks"):
            compare_ranks("linesplit", runs[ref][0], h, runs[ref][1], t, POD_RTOL,
                          ksp=LINESPLIT_KSP, names=(ref, name))
        launches["dist_linesplit_" + "".join(map(str, p))] = summed(records)
    # the split grids share the padded box's hierarchy
    a, b = (f"ranks {p}" for p in LINESPLIT_GRIDS)
    compare_ranks("linesplit", runs[a][0], runs[b][0], runs[a][1], runs[b][1], POD_RTOL,
                  names=(a, b))
    return launches


def check_pieces(out_dir, flags, n):
    """Each step's PVTU of an n-rank -vtu_freq 1 run: one master listing n
    pieces, and each piece holding its DMDA ghost box's points."""
    import re

    from macroc_tpu_torch.config import parse_cli
    from macroc_tpu_torch.grid import make_grid

    cfg = parse_cli(flags)
    g = make_grid(cfg, n)
    for ts in range(cfg.ts):
        with open(os.path.join(out_dir, f"solution_{ts}.pvtu")) as f:
            master = f.read()
        check(master.count("<Piece Source=") == n, f"dist vtu: step {ts} master lists pieces")
        for r in range(n):
            b = g.local_box(r)
            with open(os.path.join(out_dir, f"solution_{ts}-subdo-{r}.vtu")) as f:
                points = int(re.search(r'NumberOfPoints="(\d+)"', f.read()).group(1))
            check(points == b.nx_ghost * b.ny_ghost * b.nz_ghost,
                  f"dist vtu: step {ts} piece {r} has {points} points")
    log(f"[dist vtu] {cfg.ts} steps: one master and {n} pieces each, written by the ranks")


def step_ms_per_its(history):
    """Milliseconds of step time per KSP iteration over the steps that
    solved."""
    steps = [s for s in history if s["ksp_its"]]
    return 1e3 * sum(s["seconds"] for s in steps) / max(1, sum(sum(s["ksp_its"]) for s in steps))


def roundoff_failures(got, want):
    """tests/test_torch_golden.py's roundoff bounds, step by step: solves,
    converged and yielded-GP counts exact, KSP its within 6, first |RES|
    1e-7, force and f_trial_max 1e-5."""
    bad = []
    if len(got) != len(want):
        return ["step count"]
    for g, w in zip(got, want):
        t = w["ts"]
        if (len(g["ksp_its"]), g["converged"], g["nl_gps"]) != (
                len(w["ksp_its"]), w["converged"], w["nl_gps"]):
            bad.append(f"ts {t}: solves/converged/nl_gps")
        if any(abs(a - b) > 6 for a, b in zip(g["ksp_its"], w["ksp_its"])):
            bad.append(f"ts {t}: KSP its")
        if not np.isclose(g["res_norms"][0], w["res_norms"][0], rtol=1e-7, atol=1e-12):
            bad.append(f"ts {t}: first |RES|")
        for k in ("force", "f_trial_max"):
            if not np.isclose(g[k], w[k], rtol=1e-5, atol=1e-12):
                bad.append(f"ts {t}: {k}")
    return bad


def phase_bench(dev):
    """bench_torch.main(quick=True): every bench function once on the card
    at the full bench's shapes, one sample per timing, the micro-FE
    production rows at 2048 GPs; the bench raises on an unconverged step or
    a hand SpMV variant off its plain version.  K1, K1v1 and K2 must each
    have launched.  Returns the launches per bench function."""
    import bench_torch

    with tempfile.TemporaryDirectory() as tmp:
        result = bench_torch.main(["--out", os.path.join(tmp, "bench.json")], quick=True)
    e = result["extras"]
    totals = {k: sum(c[k] for c in e["launches"].values()) for k in ("K1", "K1v1", "K2")}
    log(f"[bench] quick: SpMV {e['variant']} {e['spmv_ms']:.4f} ms (all {e['all_variants_ms']}, "
        f"halo ratio {e['spmv_halo_ratio']:.3f}); newton MG {e['newton_ksp_its']} / Jacobi "
        f"{e['newton_jacobi_ksp_its']} KSP its; fe2 {e['fe2_fastpath_ksp_its']} / "
        f"{e['fe2_full_ksp_its']} KSP its; microfe partial n_active "
        f"{e['microfe_partial_n_active']}; launches {totals}; peak GiB "
        + json.dumps({k: round(v, 2) for k, v in e["peak_gib"].items()}))
    check(all(v > 0 for v in totals.values()), f"bench: a kernel never launched: {totals}")
    check(e["microfe_partial_n_active"] == len(range(0, e["microfe_partial_n_gps"], 10)),
          "bench: microfe partial flags other GPs than the driven ones")
    return e["launches"]


# the scripts phase: tune_microfe at the production RVE, the pancake check
# on one grid at three (nu, omega), bisect_newton at the 128^3 main path's
# grid, and the scaling sweep's grid on 1 and 2 ranks sharing the card
TUNE_GPS = 256
PANCAKE_SHAPE = (33, 3, 33)
PANCAKE_RUNS = [((1,), (0.6,)), ((2,), (0.6, 1.0))]
# the card's PCG its against the CPU's, each within this many: K1 sums a
# node's 27 block products in another order than the plain version, and
# PCG to rtol 1e-5 on these systems turns that f64 roundoff into an
# iteration either way (33x3x33 Jacobi: 285 on the card, 284 on the CPU)
PANCAKE_ITS = 1
# each card solution (Jacobi and each MG run) against the CPU's at the same
# (nu, omega), in the 2-norm relative to the CPU's: a few times the solves'
# rtol, so one iteration more or less passes and a wrong fine operator or
# matvec does not (the coarse levels' kernels are held to their plain
# versions at these shapes in the k1 and k2 phases)
PANCAKE_XTOL = 3.0
BISECT_N = 128
SCALING_GRID = 48


def phase_scripts(dev):
    """The port's scripts (scripts/*_torch.py) through the functions their
    mains run, on the card: tune_microfe's six configurations (stresses
    within its gate); the pancake check, whose f64 iteration counts must
    be the CPU's within PANCAKE_ITS and each solution the CPU's within
    PANCAKE_XTOL rtol; bisect_newton's four assembly forms at 127^3
    (within TOLS of the plain form) and the 128^3 MG step (9 KSP its); the
    scaling sweep's grid on 1 and 2 ranks (KSP its within 2 or 2%).  K1
    and K2 must have launched in the pancake, bisect and scaling runs.
    Returns the launches per script run."""
    from macroc_tpu_torch.utils.profiling import load_script
    from macroc_tpu_torch.ops.assembly import assemble_stencil_soa_kernel as k2
    from macroc_tpu_torch.ops.stencil_spmv import stencil_matvec as k1
    from macroc_tpu_torch.utils.profiling import Timings

    t = Timings(dev, reps=1)
    launches = {}

    def counted(name, fn):
        k1.launches = k2.launches = 0
        out = fn()
        launches[name] = dict(K1=k1.launches, K2=k2.launches)
        return out

    tune = load_script("tune_microfe_torch")
    t0 = time.perf_counter()
    rows, failures = tune.sweep(tune.configurations(False), TUNE_GPS, 10, device=dev, timings=t)
    log(f"[scripts tune_microfe] {TUNE_GPS} GPs, micro_n=10, f32, one sample each: " + "; ".join(
        f"{k} {r['gp_per_s']:.1f} GP/s (capped {r['capped']}, stress dev {r['stress_rel_dev']:.2e})"
        for k, r in rows.items()) + f"; {time.perf_counter() - t0:.1f} s")
    check(not failures and len(rows) == 6, f"scripts tune_microfe: failed {failures}")

    pancake = load_script("_pancake_mg_check_torch")
    t0 = time.perf_counter()
    runs = lambda device: [pancake.check(PANCAKE_SHAPE, nus=nus, omegas=om, device=device)
                           for nus, om in PANCAKE_RUNS]
    counts = lambda rs: [[r["jacobi"]["its"]] + [m["its"] for m in r["mg"]] for r in rs]
    card = counted("scripts_pancake", lambda: runs(dev))
    cpu = runs("cpu")
    solves = lambda rs: [[r["jacobi"]] + r["mg"] for r in rs]
    x_dev = [[float(np.linalg.norm(a["x"] - b["x"]) / np.linalg.norm(b["x"])) for a, b in zip(r, q)]
             for r, q in zip(solves(card), solves(cpu))]
    x_tol = PANCAKE_XTOL * pancake.RTOL
    log(f"[scripts pancake] {PANCAKE_SHAPE} f64, levels {card[0]['levels']}: [Jacobi, MG its] "
        f"per (nu, omegas) {PANCAKE_RUNS}: card {counts(card)}, CPU {counts(cpu)} (bound "
        f"{PANCAKE_ITS} apart); card solutions from the CPU's, rel 2-norm {x_dev} (bound "
        f"{x_tol:g}); MG rel-diff from Jacobi on the card "
        f"{[m['rel_diff'] for r in card for m in r['mg']]}; launches "
        f"{launches['scripts_pancake']}; {time.perf_counter() - t0:.1f} s")
    check(all(abs(a - b) <= PANCAKE_ITS for r, q in zip(counts(card), counts(cpu))
              for a, b in zip(r, q)) and len(sum(counts(card), [])) == len(sum(counts(cpu), [])),
          f"scripts pancake: the card's counts differ from the CPU's by more than {PANCAKE_ITS}")
    check(all(d <= x_tol for r in x_dev for d in r),
          f"scripts pancake: a card solution is {x_dev} from the CPU's (bound {x_tol:g})")

    bisect = load_script("bisect_newton_torch")
    t0 = time.perf_counter()
    forms, step = counted("scripts_bisect", lambda: (
        bisect.standalone_assembly(BISECT_N, device=dev, timings=t),
        bisect.fused_step(True, BISECT_N, device=dev, timings=t)))
    log(f"[scripts bisect] {BISECT_N - 1}^3 elements f32, ms per call (one sample): "
        f"{forms['ms']}; max rel dev from plain {forms['rel_dev']} (bound "
        f"{TOLS[torch.float32]:g}); {BISECT_N}^3 MG step coarse_direct=True "
        f"{step['step_s']:.4f} s, {step['ksp_its']} KSP its; launches "
        f"{launches['scripts_bisect']}; {time.perf_counter() - t0:.1f} s")
    check(all(v < TOLS[torch.float32] for v in forms["rel_dev"].values()),
          "scripts bisect: an assembly form disagrees with the plain one")
    check(step["ksp_its"] == 9, f"scripts bisect: {step['ksp_its']} KSP its, want 9")

    sweep = load_script("scaling_sweep_torch")
    t0 = time.perf_counter()
    scaling = {n: sweep.run_one(n, SCALING_GRID, 1) for n in (1, 2)}
    for n, r in scaling.items():
        launches[f"scripts_scaling_{n}"] = r["launches"]
    a, b = scaling[1]["ksp_its"], scaling[2]["ksp_its"]
    log(f"[scripts scaling] {SCALING_GRID}^3, ranks sharing the card (not a scaling figure): "
        + "; ".join(f"{n} ({r['backend']}, procs {r['procs']}): step {r['step_s'] * 1e3:.1f} ms, "
                    f"{r['ksp_its']} KSP its, |u| {r['u_norm']:.6e}, launches {r['launches']}"
                    for n, r in scaling.items()) + f"; {time.perf_counter() - t0:.1f} s")
    check(abs(a - b) <= max(2, 0.02 * a), f"scripts scaling: KSP its {b} on 2 ranks vs {a}")
    for name in ("scripts_pancake", "scripts_bisect", "scripts_scaling_1", "scripts_scaling_2"):
        check(launches[name]["K1"] > 0 and launches[name]["K2"] > 0,
              f"{name}: K1 or K2 never launched: {launches[name]}")
    return launches


PHASES = ("k1", "k1v1", "k2", "cg", "j2", "goldens", "main", "solvers", "checkpoint", "profile",
          "microfe", "fe2", "dist", "bench", "scripts")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    only = PHASES
    if "--only" in sys.argv:
        only = sys.argv[sys.argv.index("--only") + 1].split(",")
    from macroc_tpu_torch.utils.runtime import setup_runtime

    setup_runtime()
    from macroc_tpu_torch.utils.profiling import device_description

    dev = torch.device("cuda")
    smi = device_description(dev)
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    phase_build()
    path_shapes = path_node_shapes(dev) if {"k1", "k2", "cg"} & set(only) else []
    got = {}
    t_all = time.perf_counter()
    for name in only:
        t0 = time.perf_counter()
        args = (path_shapes,) if name in ("k1", "k2", "cg") else ()
        got[name] = globals()[f"phase_{name}"](dev, *args)
        torch.cuda.empty_cache()
        log(f"[time] phase {name}: {time.perf_counter() - t0:.1f} s")
    log(f"[time] all phases: {time.perf_counter() - t_all:.1f} s")
    if tuple(only) != PHASES:
        log(f"[partial] ran only {','.join(only)}: no result line")
        return 4
    k1, k1_narrow = got["k1"]
    k1v1, v1_launches = got["k1v1"]
    fe2, fe2_asymmetry = got["fe2"]
    dist_launches, dist_k1_ms = got["dist"]
    # ``launches`` is the 128^3 J2 main path's count, as since the first
    # slice; ``launches_by_path`` adds each FE² line's own count and each
    # 2-rank line's (summed over its ranks) and each script run's
    by_path = lambda k: {"j2_128": got["main"][k], **{p: c[k] for p, c in fe2.items()},
                         **{p: c[k] for p, c in dist_launches.items()},
                         **{p: c[k] for p, c in got["scripts"].items()}}
    kernels = [
        dict(name="stencil_spmv (K1)", route="cuda",
             source="macroc_tpu_torch/csrc/stencil_spmv.cu",
             replaces="macroc_tpu/ops/stencil_pallas.py:223",
             launches=got["main"]["K1"], launches_by_path=by_path("K1"),
             halo_rank_block_ms=dist_k1_ms, **k1),
        dict(name="assembly_fused (K2)", route="cuda",
             source="macroc_tpu_torch/csrc/assembly_fused.cu",
             replaces="macroc_tpu/ops/assembly_pallas.py:165",
             launches=got["main"]["K2"], launches_by_path=by_path("K2"),
             **got["k2"]),
        # K1v1 runs on the same 128^3 operator shape as K1: its bound, and
        # the CSR SpMV of the k1 phase (same shape and sparsity, the time
        # does not depend on the values) as its library yardstick
        dict(name="stencil_spmv_v1 (K1v1)", route="cuda",
             source="macroc_tpu_torch/csrc/stencil_spmv_v1.cu",
             replaces="macroc_tpu/ops/stencil_pallas.py:79",
             launches=v1_launches,
             launches_by_path={"spmv_sweep": v1_launches,
                               "bench_spmv": got["bench"]["spmv"]["K1v1"]},
             bound_ms=k1["bound_ms"], bound_by=k1["bound_by"],
             library_ms=k1["library_ms"], **k1v1),
        # K1's bf16-operator entry (the TPU kernel's narrow-A use,
        # stencil_pallas.py:257-265); launches: the 128^3 bf16 MG run's
        dict(name="stencil_spmv bf16 operator (K1 narrow form)", route="cuda",
             source="macroc_tpu_torch/csrc/stencil_spmv.cu",
             replaces="macroc_tpu/ops/stencil_pallas.py:223",
             launches=got["solvers"], **k1_narrow),
    ]
    # the fused PCG iteration's kernels (port-only): ``launches`` is the
    # CLI's Jacobi line's count (the MG main line does not run them)
    cg_kern, cg_launches = got["cg"]
    port_only = ("none: port-only; the JAX package's CG is one lax.while_loop "
                 "(macroc_tpu/solve/cg.py:127) that XLA fuses")
    # the full p.q form runs on the operators not marked symmetric (the
    # micro-FE engine's): ``launches`` is the FE² Jacobi line's count
    cg_kern["K1_dot_sym"]["asymmetry_fe2_full"] = fe2_asymmetry
    for name, key, src, counter, path in (
            ("stencil_spmv p.q form (K1 dot)", "K1_dot", "stencil_spmv.cu", "K1_dot",
             "fe2_full"),
            ("stencil_spmv half-stencil p.q form (K1 dot sym)", "K1_dot_sym",
             "stencil_spmv.cu", "K1_dot_sym", "j2_128_jacobi"),
            ("cg_update_xr", "xr", "cg_fused.cu", "cg_update_xr", "j2_128_jacobi"),
            ("cg_update_p", "p", "cg_fused.cu", "cg_update_p", "j2_128_jacobi")):
        by = {"j2_128_jacobi": cg_launches[counter], "j2_128": got["main"][counter],
              "fe2_full": fe2["fe2_full"][counter]}
        kernels.append(dict(name=name, route="cuda", source=f"macroc_tpu_torch/csrc/{src}",
                            replaces=port_only, launches=by[path], launches_by_path=by,
                            **cg_kern[key]))
    # the J2 return map (port-only): ``launches`` is the 128^3 J2 main path's
    kernels.append(dict(
        name="j2_return", route="cuda", source="macroc_tpu_torch/csrc/j2_return.cu",
        replaces=("none: port-only; the JAX package's J2Engine.homogenize "
                  "(macroc_tpu/constitutive/j2.py:149-210) is jnp code that XLA fuses"),
        launches=got["main"]["j2_return"],
        launches_by_path={"j2_128": got["main"]["j2_return"],
                          "j2_128_jacobi": cg_launches["j2_return"]},
        **got["j2"]))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
