"""Build and load the hand-written CUDA kernels (``macroc_tpu_torch/csrc``).

The sources are compiled at first use with ``nvcc`` into one shared library
with a plain C interface, loaded with ``ctypes``.  The library lands in
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
SOURCES = ("stencil_spmv.cu", "assembly_combine.cu")
BUILD_ROOT = PKG_DIR.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int

# C entry points: name -> argument types (all return cudaError_t as int)
_SIGNATURES = {
    # (A, x, y, nx, ny, nz, halo, stream)
    "macroc_stencil_spmv_f32": (_P, _P, _P, _I, _I, _I, _I, _P),
    "macroc_stencil_spmv_f64": (_P, _P, _P, _I, _I, _I, _I, _P),
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
    for name in SOURCES:
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
    # compile to a private name, then rename: a concurrent build never
    # exposes a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *(str(CSRC_DIR / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            "nvcc failed building the macroc_tpu_torch kernels:\n"
            + " ".join(cmd) + "\n" + proc.stdout + proc.stderr
        )
    os.replace(tmp, lib_path)
    return lib_path


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
