"""27-point 3x3-block stencil SpMV in SoA layout: kernels K1 and K1v1 and
their plain version (replaces ``macroc_tpu/ops/stencil_pallas.py``).

Layout: A_soa (27,3,3,nx,ny,nz), vectors (3,nx,ny,nz).  nnz accounting for
the SpMV metric: 243 stored coefficients per node.

``stencil_matvec`` launches K1 (``csrc/stencil_spmv.cu``) and
``stencil_matvec_v1`` K1v1 (``csrc/stencil_spmv_v1.cu``, the shared-memory
tile form) for CUDA tensors; both run ``stencil_matvec_soa`` for CPU
tensors.  Nothing falls back from one to the other.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from macroc_tpu_torch.fem.kernels import STENCIL_OFFSETS


def to_soa(A27: torch.Tensor) -> torch.Tensor:
    """(nx,ny,nz,27,3,3) -> (27,3,3,nx,ny,nz) (a view)."""
    return A27.permute(3, 4, 5, 0, 1, 2)


def from_soa(A_soa: torch.Tensor) -> torch.Tensor:
    """(27,3,3,nx,ny,nz) -> (nx,ny,nz,27,3,3) (a view)."""
    return A_soa.permute(3, 4, 5, 0, 1, 2)


def x_to_soa(x: torch.Tensor) -> torch.Tensor:
    """(nx,ny,nz,3) -> (3,nx,ny,nz), contiguous."""
    return x.permute(3, 0, 1, 2).contiguous()


def x_from_soa(xs: torch.Tensor) -> torch.Tensor:
    """(3,nx,ny,nz) -> (nx,ny,nz,3), contiguous."""
    return xs.permute(1, 2, 3, 0).contiguous()


def stencil_matvec_soa(
    A_soa: torch.Tensor, x_soa: torch.Tensor, halo: bool = False
) -> torch.Tensor:
    """Plain PyTorch y = A x: 27 shifted windows of the zero-padded x, each
    contracted with its (3,3) coefficient planes.  ``halo=True``: x_soa is
    (3,nx+2,ny+2,nz+2) and already carries its 1-node halo.  A narrower A
    (bf16 MG levels) is widened exactly in each product; y has x's
    dtype."""
    nx, ny, nz = A_soa.shape[-3:]
    xp = x_soa if halo else F.pad(x_soa, (1, 1, 1, 1, 1, 1))
    y = torch.zeros((3, nx, ny, nz), dtype=x_soa.dtype, device=x_soa.device)
    for o, (di, dj, dk) in enumerate(STENCIL_OFFSETS):
        xw = xp[:, 1 + di:1 + di + nx, 1 + dj:1 + dj + ny, 1 + dk:1 + dk + nz]
        # y[d] += sum_e A[o,d,e] * xw[e]
        for e in range(3):
            y += A_soa[o, :, e] * xw[e]
    return y


def stencil_matvec(
    A_soa: torch.Tensor, x_soa: torch.Tensor, halo: bool = False
) -> torch.Tensor:
    """y_soa = A x through kernel K1 (CUDA tensors) or its plain version
    (CPU tensors).  A may be stored narrower than x (the pairs of
    ``_ENTRY``); y has x's dtype.  Any other pair raises TypeError on a CUDA
    tensor.  Counts kernel launches in ``stencil_matvec.launches``, and
    those with a narrow operator also in ``stencil_matvec.narrow_launches``."""
    if not A_soa.is_cuda:
        return stencil_matvec_soa(A_soa, x_soa, halo=halo)
    from macroc_tpu_torch.ops import _build

    nx, ny, nz = A_soa.shape[-3:]
    h = 1 if halo else 0
    if A_soa.shape != (27, 3, 3, nx, ny, nz):
        raise ValueError(f"A_soa must be (27,3,3,nx,ny,nz), got {tuple(A_soa.shape)}")
    if x_soa.shape != (3, nx + 2 * h, ny + 2 * h, nz + 2 * h):
        raise ValueError(
            f"x_soa shape {tuple(x_soa.shape)} does not fit A {(nx, ny, nz)} "
            f"with halo={halo}"
        )
    entry = _ENTRY.get((A_soa.dtype, x_soa.dtype))
    if entry is None:
        raise TypeError(
            f"stencil_matvec has no kernel for A {A_soa.dtype} with x "
            f"{x_soa.dtype}; it takes (A, x) in "
            + ", ".join(f"({str(a)[6:]}, {str(b)[6:]})" for a, b in _ENTRY)
        )
    _check_device_layout(A_soa, x_soa, "stencil_matvec")
    y = torch.empty((3, nx, ny, nz), dtype=x_soa.dtype, device=x_soa.device)
    lib = _build.load()
    with torch.cuda.device(A_soa.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(
            A_soa.data_ptr(), x_soa.data_ptr(), y.data_ptr(),
            nx, ny, nz, h, stream,
        )
    _build.check(err, "stencil_matvec (K1)")
    stencil_matvec.launches += 1
    if A_soa.dtype != x_soa.dtype:
        stencil_matvec.narrow_launches += 1
    return y


stencil_matvec.launches = 0
# the launches, among ``launches``, of a narrow-operator entry
stencil_matvec.narrow_launches = 0
#: K1's entry point per (A dtype, x dtype): the narrow operator forms take
#: -mg_dtype level operators with solve-dtype vectors
_ENTRY = {
    (torch.float32, torch.float32): "macroc_stencil_spmv_f32",
    (torch.float64, torch.float64): "macroc_stencil_spmv_f64",
    (torch.bfloat16, torch.float32): "macroc_stencil_spmv_bf16_f32",
    (torch.bfloat16, torch.float64): "macroc_stencil_spmv_bf16_f64",
    (torch.float16, torch.float32): "macroc_stencil_spmv_f16_f32",
    (torch.float16, torch.float64): "macroc_stencil_spmv_f16_f64",
    (torch.float32, torch.float64): "macroc_stencil_spmv_f32_f64",
}


def _check_device_layout(A_soa, x_soa, what):
    if x_soa.device != A_soa.device:
        raise ValueError("A_soa and x_soa must be on the same device")
    if not (A_soa.is_contiguous() and x_soa.is_contiguous()):
        raise ValueError(f"{what} needs contiguous A_soa and x_soa")


#: K1v1's default node tile: 512 threads, 14,688 bytes of shared memory in
#: float32 and 29,376 in float64 (csrc/stencil_spmv_v1.cu)
V1_TILE = (4, 4, 32)
_MAX_THREADS = 1024
_MAX_SMEM = 232_448  # bytes of shared memory one block may use on Hopper


def v1_tile_check(tile, itemsize: int):
    """(TX, TY, TZ) as ints; raises ValueError when the tile's thread count
    (one thread per node) or its staged x halo window does not fit a
    block."""
    t = tuple(int(v) for v in tile)
    if len(t) != 3 or min(t) < 1:
        raise ValueError(f"tile must be three positive extents, got {tile!r}")
    threads = t[0] * t[1] * t[2]
    smem = 3 * (t[0] + 2) * (t[1] + 2) * (t[2] + 2) * itemsize
    if threads > _MAX_THREADS:
        raise ValueError(
            f"tile {t} needs {threads} threads, above the block limit {_MAX_THREADS}"
        )
    if smem > _MAX_SMEM:
        raise ValueError(
            f"tile {t} stages {smem} bytes of x, above the {_MAX_SMEM} bytes "
            "of shared memory a block may use"
        )
    return t


def stencil_matvec_v1(
    A_soa: torch.Tensor, x_soa: torch.Tensor, tile=V1_TILE
) -> torch.Tensor:
    """y_soa = A x through kernel K1v1 (CUDA tensors) or the plain version
    (CPU tensors).  ``tile`` is the block's (TX, TY, TZ) node tile; one that
    does not fit a block raises ValueError on either device.  Counts kernel
    launches in ``stencil_matvec_v1.launches``."""
    TX, TY, TZ = v1_tile_check(tile, A_soa.element_size())
    if not A_soa.is_cuda:
        return stencil_matvec_soa(A_soa, x_soa)
    from macroc_tpu_torch.ops import _build

    nx, ny, nz = A_soa.shape[-3:]
    if A_soa.shape != (27, 3, 3, nx, ny, nz):
        raise ValueError(f"A_soa must be (27,3,3,nx,ny,nz), got {tuple(A_soa.shape)}")
    if x_soa.shape != (3, nx, ny, nz):
        raise ValueError(f"x_soa shape {tuple(x_soa.shape)} does not fit A {(nx, ny, nz)}")
    if A_soa.dtype != x_soa.dtype or A_soa.dtype not in _ENTRY_V1:
        raise TypeError(
            f"stencil_matvec_v1 takes float32 or float64 A and x of one dtype, "
            f"got {A_soa.dtype} and {x_soa.dtype}"
        )
    _check_device_layout(A_soa, x_soa, "stencil_matvec_v1")
    y = torch.empty((3, nx, ny, nz), dtype=x_soa.dtype, device=x_soa.device)
    lib = _build.load()
    with torch.cuda.device(A_soa.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, _ENTRY_V1[A_soa.dtype])(
            A_soa.data_ptr(), x_soa.data_ptr(), y.data_ptr(),
            nx, ny, nz, TX, TY, TZ, stream,
        )
    _build.check(err, "stencil_matvec_v1 (K1v1)")
    stencil_matvec_v1.launches += 1
    return y


stencil_matvec_v1.launches = 0
_ENTRY_V1 = {
    torch.float32: "macroc_stencil_spmv_v1_f32",
    torch.float64: "macroc_stencil_spmv_v1_f64",
}
