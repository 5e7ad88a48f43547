"""Stencil assembly: kernel K2 and its plain version (replaces
``macroc_tpu/ops/assembly_pallas.py::assemble_stencil_soa_mxu``).

On a CUDA tensor ``assemble_stencil_soa_kernel`` launches K2
(``csrc/assembly_fused.cu``): one kernel from per-GP tangents to the SoA
stencil that contracts B's sparsity pattern per GP and keeps each element's
stiffness Ke on the chip.  On a CPU tensor it runs the plain version in two
stages:

  1. per-element stiffness as ONE plain matrix product: each element's
     vec(Ke)[(a,d,b,e)] = M[(adbe), (gvw)] @ vec(C_e), M = B^T x B * wg
     constant (576 x 288).  ``torch.matmul(M, C^T)`` writes Ke
     CHANNEL-major, (576, nex, ney, nez);
  2. the node-gather COMBINE: node p sums, over its 8 adjacent elements a,
     the 72 channels (d,b,e) of that element's Ke into stencil entry
     K = o(a,b)*9 + d*3 + e of A (27,3,3,nx,ny,nz) (``combine_plain``).

``combine_cuda`` is the earlier two-stage kernel's combine
(``csrc/assembly_combine.cu``), off the main path; ``chip_smoke.py`` times
it beside K2.

Channel orders:
  Ke : k = a*72 + (d*8 + b)*3 + e
  A  : K = o*9  + d*3 + e,  o = offset_index(off_b - off_a)
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Optional, Tuple

import numpy as np
import torch

from macroc_tpu_torch.fem.element import DIM, NGP, NODE_OFFSETS, NPE, NVOI, b_from_dsh
from macroc_tpu_torch.fem.kernels import N_STENCIL, assemble_stencil_soa, offset_index

N_KE = NPE * DIM * NPE * DIM  # 576 element-stiffness channels
N_A = N_STENCIL * DIM * DIM   # 243 stencil entries per node


def pair_matrix(B: torch.Tensor, wg: float) -> torch.Tensor:
    """M (576, 288): vec(Ke)[a*72 + (d*8+b)*3 + e] = M @ vec(C_e)[(g,v,w)]."""
    M = torch.einsum("gvad,gwbe->adbegvw", B, B) * wg
    return M.reshape(N_KE, NGP * NVOI * NVOI)


def element_stiffness_cm(
    ctan: torch.Tensor, B: torch.Tensor, wg: float
) -> torch.Tensor:
    """Stage 1: channel-major element stiffness Ke (576, nex, ney, nez) from
    per-GP tangents ctan (nex,ney,nez,8,6,6)."""
    ne = tuple(ctan.shape[:3])
    C = ctan.reshape(-1, NGP * NVOI * NVOI)
    return torch.matmul(pair_matrix(B, wg), C.T).reshape((N_KE,) + ne)


def combine_map(a: int) -> List[Tuple[int, int]]:
    """(stencil entry K, channel within the a-block) pairs of element
    offset a: the 72 channels of one Ke a-block and where each lands."""
    oa = NODE_OFFSETS[a]
    pairs = []
    for d in range(DIM):
        for b in range(NPE):
            ob = NODE_OFFSETS[b]
            o = offset_index(ob[0] - oa[0], ob[1] - oa[1], ob[2] - oa[2])
            for e in range(DIM):
                pairs.append((o * 9 + d * 3 + e, (d * 8 + b) * 3 + e))
    return pairs


@lru_cache(maxsize=None)
def combine_table() -> np.ndarray:
    """(243, 8) int32: the Ke channel a*72 + c feeding entry K from element
    offset a, or -1 (the kernel's ``__constant__`` map).  Read-only."""
    table = np.full((N_A, NPE), -1, np.int32)
    for a in range(NPE):
        for K, c in combine_map(a):
            table[K, a] = a * 72 + c
    table.setflags(write=False)
    return table


def combine_plain(Ke: torch.Tensor, grid_shape: Tuple[int, int, int]) -> torch.Tensor:
    """Plain PyTorch stage 2: A (243, nx, ny, nz) from channel-major Ke.

    Node rows [oa, oa+ne) of each axis read element planes [0, ne); the
    entries K of one a-block are distinct, so one indexed slice add per a
    is exact.  Sums run over a = 0..7 in order, as in the kernel."""
    nx, ny, nz = grid_shape
    nex, ney, nez = nx - 1, ny - 1, nz - 1
    A = torch.zeros((N_A, nx, ny, nz), dtype=Ke.dtype, device=Ke.device)
    for a in range(NPE):
        ox, oy, oz = (int(v) for v in NODE_OFFSETS[a])
        K = torch.tensor([k for k, _ in combine_map(a)], device=Ke.device)
        A[K, ox:ox + nex, oy:oy + ney, oz:oz + nez] += Ke[a * 72:(a + 1) * 72]
    return A


def combine_cuda(Ke: torch.Tensor, grid_shape: Tuple[int, int, int]) -> torch.Tensor:
    """Launch kernel K2 on a CUDA tensor Ke (576, nx-1, ny-1, nz-1);
    returns A (243, nx, ny, nz).  Checks shapes, dtype and layout."""
    from macroc_tpu_torch.ops import _build

    nx, ny, nz = grid_shape
    if not Ke.is_cuda:
        raise ValueError("combine_cuda needs a CUDA tensor")
    if tuple(Ke.shape) != (N_KE, nx - 1, ny - 1, nz - 1):
        raise ValueError(
            f"Ke must be (576, nx-1, ny-1, nz-1) for grid {grid_shape}, "
            f"got {tuple(Ke.shape)}"
        )
    if Ke.dtype not in _ENTRY:
        raise TypeError(f"K2 takes float32 or float64, got {Ke.dtype}")
    if not Ke.is_contiguous():
        raise ValueError("K2 needs a contiguous Ke")
    lib = _build.load()
    A = torch.empty((N_A, nx, ny, nz), dtype=Ke.dtype, device=Ke.device)
    with torch.cuda.device(Ke.device):
        dev = torch.cuda.current_device()
        if dev not in _map_loaded:
            _build.check(
                lib.macroc_set_combine_map(combine_table().ctypes.data),
                "K2 combine map upload",
            )
            _map_loaded.add(dev)
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, _ENTRY[Ke.dtype])(
            Ke.data_ptr(), A.data_ptr(), nx, ny, nz, stream
        )
    _build.check(err, "assembly combine (K2)")
    return A


def assemble_stencil_soa_plain(
    ctan: torch.Tensor, B: torch.Tensor, wg: float,
    grid_shape: Tuple[int, int, int],
) -> torch.Tensor:
    """Plain PyTorch K2: A (243, nx, ny, nz) through stage 1 and
    ``combine_plain``."""
    return combine_plain(element_stiffness_cm(ctan, B, wg), grid_shape)


def b_dsh(B: torch.Tensor) -> np.ndarray:
    """The (8, 8, 3) shape derivatives that B (8, 6, 8, 3) holds; raises
    ValueError unless B has exactly ``b_matrix``'s pattern (K2 contracts
    with that pattern, not with B).  It reads B to the host: callers that
    assemble repeatedly take it once and pass it to K2's wrapper."""
    if tuple(B.shape) != (NGP, NVOI, NPE, DIM):
        raise ValueError(f"B must be (8, 6, 8, 3), got {tuple(B.shape)}")
    Bh = B.detach().to("cpu", torch.float64).numpy()
    dsh = np.stack([Bh[:, c, :, c] for c in range(DIM)], axis=-1)
    if not np.array_equal(Bh, b_from_dsh(dsh)):
        raise ValueError("B does not have b_matrix's sparsity pattern: K2 "
                         "takes only strain-displacement tables of that form")
    return dsh


def check_fused_layout(ctan: torch.Tensor) -> None:
    """Raise ValueError unless K2 can read ctan in place: each element's
    288 values contiguous, elements at stride 288 along z (a contiguous
    tensor or a slice of a node-shaped one: the Newton step hands over the
    latter).  A size-1 axis is never stepped along."""
    st = ctan.stride()
    if st[3:] != (36, 6, 1) or (ctan.shape[2] > 1 and st[2] != 288):
        raise ValueError(f"K2 needs each element's 8x6x6 tangents contiguous and "
                         f"elements at stride 288 along z, got strides {st}")


def _fused_cuda(ctan: torch.Tensor, dsh: np.ndarray, wg: float,
                grid_shape: Tuple[int, int, int]) -> torch.Tensor:
    """Launch K2 on a CUDA ctan; returns A (243, nx, ny, nz)."""
    from macroc_tpu_torch.ops import _build

    nx, ny, nz = grid_shape
    if ctan.dtype not in _FUSED_ENTRY:
        raise TypeError(f"K2 takes float32 or float64, got {ctan.dtype}")
    if min(grid_shape) < 2:
        raise ValueError(f"K2 needs at least 2 nodes per axis, got {grid_shape}")
    check_fused_layout(ctan)
    st = ctan.stride()
    lib = _build.load()
    A = torch.empty((N_A, nx, ny, nz), dtype=ctan.dtype, device=ctan.device)
    host = np.ascontiguousarray(dsh, dtype=np.float32 if ctan.dtype == torch.float32
                                else np.float64)
    with torch.cuda.device(ctan.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, _FUSED_ENTRY[ctan.dtype])(
            ctan.data_ptr(), host.ctypes.data, A.data_ptr(), float(wg), nx, ny, nz,
            st[0], st[1], stream,
        )
    _build.check(err, "fused assembly (K2)")
    return A


def assemble_stencil_slab(
    ctan: torch.Tensor, B: torch.Tensor, wg: float,
    grid_shape: Tuple[int, int, int], dsh: Optional[np.ndarray] = None,
) -> torch.Tensor:
    """The plain slab form (``fem/kernels.py::assemble_stencil_soa``) under
    the assemblers' common signature; it reads B itself, so ``dsh`` goes
    unused."""
    return assemble_stencil_soa(ctan, B, wg, grid_shape)


def assemble_stencil_soa_kernel(
    ctan: torch.Tensor, B: torch.Tensor, wg: float,
    grid_shape: Tuple[int, int, int], dsh: Optional[np.ndarray] = None,
) -> torch.Tensor:
    """Stencil assembly A_soa (27,3,3,nx,ny,nz) from per-GP tangents ctan
    (nx-1,ny-1,nz-1,8,6,6): kernel K2 on a CUDA tensor, the plain version
    on a CPU tensor.  B must have ``b_matrix``'s pattern (ValueError).
    ``dsh`` is B's shape derivatives when the caller holds them
    (``b_dsh(B)``, or the ``shape_derivatives`` B was made from); None
    reads them from B and checks its pattern on every call.  Counts kernel
    launches in ``assemble_stencil_soa_kernel.launches``."""
    nx, ny, nz = grid_shape
    if tuple(ctan.shape) != (nx - 1, ny - 1, nz - 1, NGP, NVOI, NVOI):
        raise ValueError(
            f"ctan must be (nx-1,ny-1,nz-1,8,6,6) for grid {grid_shape}, "
            f"got {tuple(ctan.shape)}"
        )
    if dsh is None:
        dsh = b_dsh(B)
    if ctan.is_cuda:
        A = _fused_cuda(ctan, dsh, wg, grid_shape)
        assemble_stencil_soa_kernel.launches += 1
    else:
        A = assemble_stencil_soa_plain(ctan, B, wg, grid_shape)
    return A.reshape(N_STENCIL, DIM, DIM, nx, ny, nz)


assemble_stencil_soa_kernel.launches = 0
_map_loaded = set()  # device indices whose constant bank holds the map
_ENTRY = {
    torch.float32: "macroc_assembly_combine_f32",
    torch.float64: "macroc_assembly_combine_f64",
}
_FUSED_ENTRY = {
    torch.float32: "macroc_assembly_fused_f32",
    torch.float64: "macroc_assembly_fused_f64",
}
