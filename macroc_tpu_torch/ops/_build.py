"""Build and load the hand-written CUDA kernels (``macroc_tpu_torch/csrc``).

The sources are compiled at first use with ``nvcc``, one process per source,
all started together, and linked into one shared library with a plain C
interface, loaded with ``ctypes``.  The library lands in
``build/kernels/<hash of the sources>/`` at the root of the checkout (listed
in ``.gitignore``), so an edited source is rebuilt and an unchanged one is
reused.  A missing ``nvcc`` or a failed build raises; there is no fallback.

Every C entry point returns ``cudaGetLastError()`` after its launch; the
wrappers raise on a non-zero value through :func:`check`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
SOURCES = ("stencil_spmv.cu", "stencil_spmv_v1.cu", "assembly_fused.cu",
           "assembly_combine.cu", "cg_fused.cu")
#: headers the sources include (hashed with them)
HEADERS = ("cg_state.cuh",)
BUILD_ROOT = PKG_DIR.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double

# C entry points: name -> argument types (all return cudaError_t as int)
_SIGNATURES = {
    # (A, x, y, nx, ny, nz, halo, stream)
    **{
        f"macroc_stencil_spmv_{pair}": (_P, _P, _P, _I, _I, _I, _I, _P)
        for pair in ("f32", "f64", "bf16_f32", "bf16_f64", "f16_f32", "f16_f64",
                     "f32_f64")
    },
    # K1's p.q form: (A, p, q, nx, ny, nz, partials, sc, st, stream)
    "macroc_stencil_spmv_dot_f32": (_P, _P, _P, _I, _I, _I, _P, _P, _P, _P),
    "macroc_stencil_spmv_dot_f64": (_P, _P, _P, _I, _I, _I, _P, _P, _P, _P),
    # its half-stencil form, the same arguments
    "macroc_stencil_spmv_dot_sym_f32": (_P, _P, _P, _I, _I, _I, _P, _P, _P, _P),
    "macroc_stencil_spmv_dot_sym_f64": (_P, _P, _P, _I, _I, _I, _P, _P, _P, _P),
    # (x, p, r, q, inv, N, partials, sc, st, trace, stream)
    "macroc_cg_update_xr_f32": (_P, _P, _P, _P, _P, _L, _P, _P, _P, _P, _P),
    "macroc_cg_update_xr_f64": (_P, _P, _P, _P, _P, _L, _P, _P, _P, _P, _P),
    # (p, r, inv, N, sc, st, stream)
    "macroc_cg_update_p_f32": (_P, _P, _P, _L, _P, _P, _P),
    "macroc_cg_update_p_f64": (_P, _P, _P, _L, _P, _P, _P),
    # (A, x, y, nx, ny, nz, TX, TY, TZ, stream)
    "macroc_stencil_spmv_v1_f32": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "macroc_stencil_spmv_v1_f64": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # (ctan, host dsh, A, wg, nx, ny, nz, sx, sy, stream)
    "macroc_assembly_fused_f32": (_P, _P, _P, _D, _I, _I, _I, _L, _L, _P),
    "macroc_assembly_fused_f64": (_P, _P, _P, _D, _I, _I, _I, _L, _L, _P),
    # (Ke, A, nx, ny, nz, stream)
    "macroc_assembly_combine_f32": (_P, _P, _I, _I, _I, _P),
    "macroc_assembly_combine_f64": (_P, _P, _I, _I, _I, _P),
    # (host int32[243*8] table)
    "macroc_set_combine_map": (_P,),
    # (error code) -> const char*
    "macroc_error_string": (_I,),
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA toolkit is needed to build the macroc_tpu_torch kernels"
    )


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernel library if this source hash has no build yet;
    returns its path.  Raises on a missing nvcc or a failed compile."""
    out_dir = BUILD_ROOT / _source_hash()
    lib_path = out_dir / "libmacroc_kernels.so"
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    # compile to private names, then rename: a concurrent build never
    # exposes a half-written library
    work = Path(tempfile.mkdtemp(dir=out_dir))
    objs = [work / (Path(s).stem + ".o") for s in SOURCES]
    compiles = [
        [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC_DIR / src)]
        for src, obj in zip(SOURCES, objs)
    ]
    tmp = work / "libmacroc_kernels.so"
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
    try:
        procs = [
            subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for cmd in compiles
        ]
        outs = [p.communicate()[0] for p in procs]
        for cmd, p, out in zip(compiles, procs, outs):
            _raise_if_failed(cmd, p.returncode, out)
        proc = subprocess.run(link, capture_output=True, text=True)
        _raise_if_failed(link, proc.returncode, proc.stdout + proc.stderr)
        os.replace(tmp, lib_path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib_path


def _raise_if_failed(cmd, returncode: int, output: str) -> None:
    if returncode != 0:
        raise RuntimeError(
            "nvcc failed building the macroc_tpu_torch kernels:\n"
            + " ".join(cmd) + "\n" + output
        )


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.macroc_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = load().macroc_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
