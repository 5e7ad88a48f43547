#!/usr/bin/env python3
"""The stencil-assembly forms and the MG coarse solve of the converged n^3
Newton step of macroc_tpu_torch (the counterpart of the JAX package's
scripts/bisect_newton.py):

    python3 scripts/bisect_newton_torch.py [--out FILE]

``standalone_assembly`` times each assembly form the port has on one
materialised elastic tangent field at (n-1)^3 elements, f32 (CUDA events
over many calls, median of 3 samples):

  fused      K2 (csrc/assembly_fused.cu) with B's shape derivatives passed
             once, as the Newton step calls it;
  two_stage  the earlier path: the stage-1 matmul ``element_stiffness_cm``
             and the combine kernel (csrc/assembly_combine.cu);
  slab       the slab form ``fem/kernels.py::assemble_stencil_soa``;
  plain      K2's plain version ``assemble_stencil_soa_plain``.

Every form is held to the plain one (largest deviation relative to its
largest entry: 1e-5 at f32, 1e-12 at f64).  The JAX script's ``conv`` and
``conv2`` forms are TPU layout experiments that the port does not have
(ROADMAP); its ``slab`` is the port's too.  On the CPU (the tests) the
kernels' wrappers run their plain versions and the two-stage path combines
with ``combine_plain``.

``fused_step`` times the converged n^3 bending J2 Newton step
(newton_max_its 1, ksp_rtol 1e-5, pc_type mg) with the MG coarsest level
solved by its dense inverse (``coarse_direct`` True) or by smoother sweeps
(False): step seconds, the median of 3 host-clock samples around a
synchronised call from the same (u, state) and their minimum (the JAX
script's figure), and KSP its.  The JAX script's assembly axis is dropped:
the port assembles with K2 on the card whatever ``-assembly`` says.

It runs on the card (MACROC_PLATFORM=cpu: the CPU).  A part that fails is
printed and the others go on; the script then exits 1.  The full JSON goes
to ``--out`` (default ``build/bisect_newton_torch.json``); the last line
printed is a headline.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from macroc_tpu_torch.utils.profiling import Timings  # noqa: E402

# each form against the plain one, relative to the plain stencil's largest
# entry (the kernels' bounds of chip_smoke.py)
FORM_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
N = 128  # nodes per axis: the JAX flagship's grid


def _device(device):
    from macroc_tpu_torch.cli import device_from_env

    return device_from_env() if device is None else torch.device(device)


def standalone_assembly(n=128, dtype=torch.float32, device=None, timings=None):
    """Each assembly form on the default material's elastic C at every GP
    of (n-1)^3 elements, wg 0.125 (the unit-spacing B): returns
    dict(ms={form: ms per call}, rel_dev={form: deviation from plain}).
    Raises AssertionError when a form deviates more than FORM_RTOL."""
    from bench_torch import elastic_tangents
    from macroc_tpu_torch.fem.element import b_matrix
    from macroc_tpu_torch.fem.kernels import assemble_stencil_soa
    from macroc_tpu_torch.ops import assembly as asm

    device = _device(device)
    t = Timings(device) if timings is None else timings
    shape = (n, n, n)
    B = torch.as_tensor(b_matrix((1.0, 1.0, 1.0)), dtype=dtype, device=device)
    ctan = elastic_tangents((n - 1,) * 3, dtype, device)
    dsh = asm.b_dsh(B)
    # each form with its CUDA-event calls per sample (fewer where Ke is
    # materialised)
    forms = {
        "fused": (lambda: asm.assemble_stencil_soa_kernel(ctan, B, 0.125, shape, dsh=dsh), 10),
        "two_stage": (lambda: (asm.combine_cuda if ctan.is_cuda else asm.combine_plain)(
            asm.element_stiffness_cm(ctan, B, 0.125), shape), 5),
        "slab": (lambda: assemble_stencil_soa(ctan, B, 0.125, shape), 3),
        "plain": (lambda: asm.assemble_stencil_soa_plain(ctan, B, 0.125, shape), 3),
    }
    ref = forms["plain"][0]().reshape(-1)
    scale = float(ref.abs().max())
    rel_dev = {name: float((fn().reshape(-1) - ref).abs().max()) / scale
               for name, (fn, _) in forms.items()}
    del ref
    bad = {k: v for k, v in rel_dev.items() if not v <= FORM_RTOL[dtype]}
    if bad:
        raise AssertionError(f"assembly forms off the plain one: {bad} "
                             f"(bound {FORM_RTOL[dtype]:g})")
    ms = {name: 1e3 * t.loop(fn, calls, label=f"assembly_{name}_{n}")
          for name, (fn, calls) in forms.items()}
    return dict(ms=ms, rel_dev=rel_dev)


def fused_step(coarse_direct, n=128, device=None, timings=None):
    """The converged n^3 bending J2 + MG f32 Newton step (one homogenize,
    assembly, PCG to rtol 1e-5) with ``mg_coarse_direct=coarse_direct``,
    each call from the same (u, state): dict(step_s, step_min_s,
    ksp_its).  Raises AssertionError when the calls' KSP its differ."""
    from macroc_tpu_torch import MacroConfig
    from macroc_tpu_torch.config import BC_BENDING
    from macroc_tpu_torch.problem import MacroProblem

    device = _device(device)
    t = Timings(device) if timings is None else timings
    cfg = MacroConfig(
        nx=n, ny=n, nz=n, lx=4.0, ly=4.0, lz=4.0,
        bc_type=BC_BENDING, dtype="float32", constitutive="j2",
        newton_max_its=1, ksp_maxits=10000, ksp_rtol=1e-5,
        pc_type="mg", mg_coarse_direct=coarse_direct,
    )
    problem = MacroProblem(cfg, device)
    u, state = problem.init_fields()
    its = []

    def go():
        its.append(int(problem.time_step(u, state, -0.01)[2].ksp_its[0]))

    label = f"step_cd{int(coarse_direct)}_{n}"
    step_s = t.dispatch(go, label=label)
    if len(set(its)) != 1:
        raise AssertionError(f"coarse_direct={coarse_direct}: KSP its differ between calls: {its}")
    return dict(step_s=step_s, step_min_s=min(t.spreads[label]["samples"]), ksp_its=its[0])


def main(argv=None) -> int:
    from macroc_tpu_torch.utils.profiling import finish, guarded
    from macroc_tpu_torch.utils.runtime import setup_runtime

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "build", "bisect_newton_torch.json"))
    args = ap.parse_args(argv)
    setup_runtime()
    device = _device(None)
    t = Timings(device)
    print("the port ignores -assembly (K2 on the card): the JAX script's assembly axis is "
          "dropped, and its conv/conv2 forms were not ported", flush=True)
    parts = {"assembly": lambda: standalone_assembly(N, device=device, timings=t)}
    parts.update({f"step_cd{int(cd)}": (lambda cd=cd: fused_step(cd, N, device, t))
                  for cd in (True, False)})
    results, failures = {}, []
    for key, fn in parts.items():
        r = guarded(key, fn, failures)
        if r is not None:
            results[key] = r
            print(f"{key}: {json.dumps(r)}", flush=True)
    steps = [k for k in results if k.startswith("step")]
    headline = dict(assembly_ms=results.get("assembly", {}).get("ms"),
                    step_s={k: results[k]["step_s"] for k in steps},
                    ksp_its={k: results[k]["ksp_its"] for k in steps})
    return finish(args.out, dict(results, n=N, timing_spreads=t.spreads), headline, failures,
                  device)


if __name__ == "__main__":
    sys.exit(main())
