"""27-point 3x3-block stencil SpMV in SoA layout: kernel K1 and its plain
version (replaces ``macroc_tpu/ops/stencil_pallas.py``).

Layout: A_soa (27,3,3,nx,ny,nz), vectors (3,nx,ny,nz).  nnz accounting for
the SpMV metric: 243 stored coefficients per node.

``stencil_matvec`` launches the CUDA kernel (``csrc/stencil_spmv.cu``) for
CUDA tensors and runs ``stencil_matvec_soa`` for CPU tensors; nothing falls
back from one to the other.
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
    (3,nx+2,ny+2,nz+2) and already carries its 1-node halo."""
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
    (CPU tensors).  Counts kernel launches in ``stencil_matvec.launches``."""
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
    if A_soa.dtype != x_soa.dtype or A_soa.dtype not in _ENTRY:
        raise TypeError(
            f"stencil_matvec takes float32 or float64 A and x of one dtype, "
            f"got {A_soa.dtype} and {x_soa.dtype}"
        )
    if x_soa.device != A_soa.device:
        raise ValueError("A_soa and x_soa must be on the same device")
    if not (A_soa.is_contiguous() and x_soa.is_contiguous()):
        raise ValueError("stencil_matvec needs contiguous A_soa and x_soa")
    y = torch.empty((3, nx, ny, nz), dtype=x_soa.dtype, device=x_soa.device)
    lib = _build.load()
    with torch.cuda.device(A_soa.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, _ENTRY[A_soa.dtype])(
            A_soa.data_ptr(), x_soa.data_ptr(), y.data_ptr(),
            nx, ny, nz, h, stream,
        )
    _build.check(err, "stencil_matvec (K1)")
    stencil_matvec.launches += 1
    return y


stencil_matvec.launches = 0
_ENTRY = {
    torch.float32: "macroc_stencil_spmv_f32",
    torch.float64: "macroc_stencil_spmv_f64",
}
