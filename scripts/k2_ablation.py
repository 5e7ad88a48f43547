#!/usr/bin/env python3
"""Where the fused assembly kernel K2 spends its time, on one CUDA GPU.

    python3 scripts/k2_ablation.py

Builds ablated copies of ``macroc_tpu_torch/csrc/assembly_fused.cu`` into
``build/k2_ablation/`` (one nvcc each, all started together) and times each
with CUDA events on the 128^3 main path's 127^3 f32 elements, in turns:

  kernel        the source as it is;
  no_arithmetic each thread's Ke column is read from the staged tangents
                instead of computed: loads, scatter, write-out and barriers;
  no_scatter    the arithmetic without the scatter into the accumulators
                and without the write-out to device memory.

The ablated kernels compute wrong stencils; only the kernel as it is is
held to the plain version.  Prints one line per timing and the card's
name and power limit.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from macroc_tpu_torch.fem.element import b_matrix  # noqa: E402
from macroc_tpu_torch.ops import _build, assembly as asm  # noqa: E402

SRC = os.path.join(REPO, "macroc_tpu_torch", "csrc", "assembly_fused.cu")
OUT = os.path.join(REPO, "build", "k2_ablation")
CALL = ("      if (e == 0) element_column<T, 0>(slot, P, md, ke);\n"
        "      else if (e == 1) element_column<T, 1>(slot, P, md, ke);\n"
        "      else element_column<T, 2>(slot, P, md, ke);")
SCATTER = "for (int d = 0; d < 3; ++d) dst[(o * 9 + d * 3 + e) * G::STR] += ke[a * 3 + d];"
STORE = "if (j < ny && k < nz) A[K * plane + ((long long)n * ny + j) * nz + k] = *src;"
# a value test that keeps the arithmetic alive without storing its result
KEEP = "for (int d = 0; d < 3; ++d) if (ke[a * 3 + d] == T(1234.5)) dst[0] = T(1);"
VARIANTS = {
    "kernel": [],
    "no_arithmetic": [(CALL, "      for (int i = 0; i < 24; ++i) ke[i] = slot[i];")],
    "no_scatter": [(SCATTER, KEEP), (STORE, "if (j < 0) A[0] = *src;")],
}
NE, SHAPE = (127, 127, 127), (128, 128, 128)


def build():
    src = open(SRC).read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
               os.path.join(OUT, f"{name}.so"), cu]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        out = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        fn = ctypes.CDLL(os.path.join(OUT, f"{name}.so")).macroc_assembly_fused_f32
        fn.argtypes = list(_build._SIGNATURES["macroc_assembly_fused_f32"])
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main():
    if not torch.cuda.is_available():
        print("k2_ablation: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    libs = build()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    ct = torch.as_tensor(rng.standard_normal(NE + (8, 6, 6), dtype=np.float32), device=dev)
    B = torch.as_tensor(b_matrix((1.0, 1.0, 1.0)), dtype=torch.float32, device=dev)
    dsh = np.ascontiguousarray(asm.b_dsh(B), dtype=np.float32)
    A = torch.empty((243,) + SHAPE, device=dev)
    st = ct.stride()

    def launch(fn):
        _build.check(fn(ct.data_ptr(), dsh.ctypes.data, A.data_ptr(), 0.1, *SHAPE, st[0], st[1],
                        torch.cuda.current_stream().cuda_stream), "K2 ablation")

    launch(libs["kernel"])
    ref = asm.assemble_stencil_soa_plain(ct, B, 0.1, SHAPE)
    err = float((A - ref).abs().max() / ref.abs().max())
    print(f"kernel vs plain: max rel err {err:.3e}")
    if err > 1e-5:
        return 1
    del ref
    times = {name: [] for name in libs}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(2):
        for name, fn in libs.items():
            launch(fn)
            torch.cuda.synchronize()
            start.record()
            for _ in range(10):
                launch(fn)
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / 10)
    for name, t in times.items():
        print(f"{name}: {' / '.join(f'{v:.4f}' for v in t)} ms (127^3 f32 elements)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
