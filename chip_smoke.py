#!/usr/bin/env python3
"""Smoke run of macroc_tpu_torch on one CUDA GPU:  python3 chip_smoke.py

Phases (each prints its lines; any failure raises and the script exits
non-zero without the result line):

  1. build   — compile the CUDA kernels from macroc_tpu_torch/csrc;
  2. K1      — stencil SpMV kernel vs its plain version on numpy-seeded
               random A and x, f32 and f64, with and without the halo
               form, at (64,64,64) and (33,17,45); then timed at the
               128^3 fine-level shape of the main path;
  3. K2      — assembly combine kernel vs its plain versions at (32,32,32)
               and (20,9,27) elements, f32 and f64; then timed at 127^3
               elements;
  4. goldens — the four J2 CG goldens (tests/goldens/*.json) at f64
               through the kernels;
  5. main    — ``macroc_tpu_torch.cli`` on the 128^3 J2 + MG bending case,
               3 time steps in f32, with the kernels' launch counters read
               around it.

The second-to-last line is the per-kernel JSON record, the last line
{"ok": true, "device": {...}}.  Without a CUDA device the script exits 1
before doing anything.
"""

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


def phase_k1(dev):
    from macroc_tpu_torch.ops.stencil_spmv import stencil_matvec, stencil_matvec_soa

    rng = np.random.default_rng(1)
    for shape in [(64, 64, 64), (33, 17, 45)]:
        for dtype, tol in TOLS.items():
            for halo in (False, True):
                A = randn(rng, (27, 3, 3) + shape, dtype, dev)
                xs = tuple(n + 2 for n in shape) if halo else shape
                x = randn(rng, (3,) + xs, dtype, dev)
                err = rel_err(stencil_matvec(A, x, halo=halo),
                              stencil_matvec_soa(A, x, halo=halo))
                log(f"[K1] {shape} {str(dtype)[6:]} halo={halo}: max rel err "
                    f"{err:.3e} (bound {tol:g})")
                check(err < tol, "K1 disagrees with its plain version")
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


def phase_k2(dev):
    from macroc_tpu_torch.fem.element import b_matrix
    from macroc_tpu_torch.fem.kernels import assemble_stencil_soa
    from macroc_tpu_torch.ops import assembly as asm

    rng = np.random.default_rng(2)
    for ne in [(32, 32, 32), (20, 9, 27)]:
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
            check(same and err < tol, "K2 disagrees with its plain versions")
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
    from macroc_tpu_torch import MacroConfig

    # tests/make_goldens.py CONFIGS (the J2 CG entries)
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
    }


def golden_failures(name, got, golden):
    """Mismatches against a golden, with tests/test_torch_golden.py's
    criteria: test_golden.py's tolerances for the two goldens that are
    robust to summation order, the roundoff bounds for the two that pin
    last bits (circle_elastic_9x3x9, bending_plastic_5x3x3)."""
    exact = name in ("bending_elastic_5x3x3", "default_grid_smoke")
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


def phase_main(dev):
    from macroc_tpu_torch import cli
    from macroc_tpu_torch.ops.assembly import assemble_stencil_soa_kernel
    from macroc_tpu_torch.ops.stencil_spmv import stencil_matvec

    log("[main] python -m macroc_tpu_torch " + " ".join(MAIN_FLAGS))
    with tempfile.TemporaryDirectory() as out_dir:
        argv = MAIN_FLAGS + ["-output_dir", out_dir]
        torch.cuda.reset_peak_memory_stats()
        stencil_matvec.launches = 0
        assemble_stencil_soa_kernel.launches = 0
        result = cli.run(argv)
    launches = dict(K1=stencil_matvec.launches, K2=assemble_stencil_soa_kernel.launches)
    peak = torch.cuda.max_memory_allocated()
    maxits = cli.parse_cli(argv).ksp_maxits
    for h in result["history"]:
        log(f"[main] step {h['ts']}: {h['seconds']:.4f} s, {len(h['res_norms'])} "
            f"homogenize / {len(h['ksp_its'])} solves, KSP its {h['ksp_its']}, "
            f"converged {h['converged']}, |RES| {h['res_norms']}")
        check(h["converged"], f"step {h['ts']} did not converge")
        check(all(k < maxits for k in h["ksp_its"]), f"step {h['ts']}: KSP hit maxits")
        check(all(math.isfinite(v) for v in h["res_norms"] + [h["force"], h["f_trial_max"]]),
              f"step {h['ts']}: non-finite diagnostics")
    check(bool(torch.isfinite(result["u"]).all()), "non-finite displacement")
    check(bool(torch.isfinite(result["state"].eps_p).all()), "non-finite plastic strain")
    log(f"[main] launches during the run: K1 {launches['K1']}, K2 {launches['K2']}; "
        f"peak device memory {peak / 2**30:.2f} GiB; phases (s) "
        + json.dumps({k: round(v, 4) for k, v in result["phases"].items()}))
    check(launches["K1"] > 0 and launches["K2"] > 0, "a kernel of the path never launched")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
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
    k1 = phase_k1(dev)
    k2 = phase_k2(dev)
    torch.cuda.empty_cache()
    phase_goldens(dev)
    torch.cuda.empty_cache()
    launches = phase_main(dev)
    kernels = [
        dict(name="stencil_spmv (K1)", route="cuda",
             source="macroc_tpu_torch/csrc/stencil_spmv.cu",
             replaces="macroc_tpu/ops/stencil_pallas.py:223",
             launches=launches["K1"], **k1),
        dict(name="assembly_combine (K2)", route="cuda",
             source="macroc_tpu_torch/csrc/assembly_combine.cu",
             replaces="macroc_tpu/ops/assembly_pallas.py:80",
             launches=launches["K2"], **k2),
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
