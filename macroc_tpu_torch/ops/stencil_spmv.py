"""27-point 3x3-block stencil SpMV in SoA layout: kernels K1 and K1v1 and
their plain version (replaces ``macroc_tpu/ops/stencil_pallas.py``).

Layout: A_soa (27,3,3,nx,ny,nz), vectors (3,nx,ny,nz).  nnz accounting for
the SpMV metric: 243 stored coefficients per node.

``stencil_matvec`` launches K1 (``csrc/stencil_spmv.cu``) and
``stencil_matvec_v1`` K1v1 (``csrc/stencil_spmv_v1.cu``, the shared-memory
tile form) for CUDA tensors; both run ``stencil_matvec_soa`` for CPU
tensors.  ``stencil_matvec_dot`` launches K1's p·q form and
``stencil_matvec_dot_sym`` its half-stencil form, the operators of
``solve/cg.py``'s fused PCG iteration, which runs on a
:class:`StencilOperator`: the half-stencil form on a symmetric A, which it
reads from blocks 13..26 alone (``stencil_matvec_sym_soa`` is its plain
product), so 528 bytes a node in float32 against the full form's 996.
Nothing falls back from one to the other.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from macroc_tpu_torch.fem.kernels import DIAG_OFFSET, N_STENCIL, STENCIL_OFFSETS
from macroc_tpu_torch.ops.cg_fused import dot64


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


def _window(d: int, n: int) -> slice:
    """The nodes p of an extent-n axis whose neighbour p + d lies in the
    box."""
    return slice(max(0, -d), n - max(0, d))


def stencil_matvec_sym_soa(A_soa: torch.Tensor, x_soa: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch y = A x for a symmetric A from its upper half: blocks
    13..26 forward (the centre in full), and blocks 14..26 mirrored, as
    ``A[26-o, d, e, p] = A[o, e, d, p - off(o)]``.  Blocks 0..12 are never
    read.  No halo; y has x's dtype."""
    nx, ny, nz = A_soa.shape[-3:]
    xp = F.pad(x_soa, (1, 1, 1, 1, 1, 1))
    y = torch.zeros((3, nx, ny, nz), dtype=x_soa.dtype, device=x_soa.device)
    for o in range(DIAG_OFFSET, N_STENCIL):
        di, dj, dk = STENCIL_OFFSETS[o]
        xw = xp[:, 1 + di:1 + di + nx, 1 + dj:1 + dj + ny, 1 + dk:1 + dk + nz]
        for e in range(3):
            y += A_soa[o, :, e] * xw[e]
    for o in range(DIAG_OFFSET + 1, N_STENCIL):
        di, dj, dk = STENCIL_OFFSETS[o]
        # t[d, m] = sum_e A[o,e,d,m] x[e,m] goes to node m + off(o)
        t = sum(A_soa[o, e] * x_soa[e] for e in range(3))
        tp = F.pad(t, (1, 1, 1, 1, 1, 1))
        y += tp[:, 1 - di:1 - di + nx, 1 - dj:1 - dj + ny, 1 - dk:1 - dk + nz]
    return y


def stencil_transpose_soa(A_soa: torch.Tensor) -> torch.Tensor:
    """The stencil of Aᵀ: ``T[o, d, e, p] = A[26-o, e, d, p + off(o)]``,
    0 where p + off(o) leaves the box."""
    T = torch.zeros_like(A_soa)
    nx, ny, nz = A_soa.shape[-3:]
    for o, (di, dj, dk) in enumerate(STENCIL_OFFSETS):
        wi, wj, wk = _window(di, nx), _window(dj, ny), _window(dk, nz)
        src = A_soa[N_STENCIL - 1 - o].transpose(0, 1)
        T[o, :, :, wi, wj, wk] = src[:, :, _shift(wi, di), _shift(wj, dj), _shift(wk, dk)]
    return T


def stencil_asymmetry(A_soa: torch.Tensor) -> float:
    """max |A[o,d,e,p] - A[26-o,e,d,p+off(o)]| over the couplings inside
    the box, over max |A|: 0 for a symmetric operator, roundoff for one
    assembled from symmetric tangents."""
    nx, ny, nz = A_soa.shape[-3:]
    worst = torch.zeros((), dtype=torch.float64, device=A_soa.device)
    for o in range(DIAG_OFFSET, N_STENCIL):
        di, dj, dk = STENCIL_OFFSETS[o]
        wi, wj, wk = _window(di, nx), _window(dj, ny), _window(dk, nz)
        up = A_soa[o][:, :, wi, wj, wk]
        low = A_soa[N_STENCIL - 1 - o].transpose(0, 1)[
            :, :, _shift(wi, di), _shift(wj, dj), _shift(wk, dk)]
        worst = torch.maximum(worst, (up - low).abs().max().double())
    return float(worst / A_soa.abs().max().double())


def _shift(w: slice, d: int) -> slice:
    return slice(w.start + d, w.stop + d)


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


class StencilOperator:
    """y = A x on the stencil ``A_soa`` through ``apply``: K1
    (:func:`stencil_matvec`, the default) or its plain version
    (:func:`stencil_matvec_soa`).  ``solve/cg.py::cg_solve`` runs its fused
    PCG iteration on this type: K1's p·q form with ``apply`` K1, the plain
    versions of the iteration's kernels with ``apply`` the plain one.
    ``symmetric`` (CG's own assumption, the default) lets that iteration
    apply A from its upper half (:func:`stencil_matvec_dot_sym`); an
    operator symmetric only to a solver tolerance, as the micro-FE
    engine's, passes False and keeps the full product."""

    def __init__(self, A_soa: torch.Tensor, apply=stencil_matvec, symmetric: bool = True):
        if apply not in (stencil_matvec, stencil_matvec_soa):
            raise ValueError(f"StencilOperator applies stencil_matvec or "
                             f"stencil_matvec_soa, not {apply!r}")
        self.A_soa = A_soa
        self.apply = apply
        self.symmetric = symmetric

    def __call__(self, x_soa: torch.Tensor) -> torch.Tensor:
        return self.apply(self.A_soa, x_soa)


def stencil_matvec_dot_plain(A_soa, p, q, state) -> None:
    """K1's p·q form, plain: q = A p in place, then p·q (products in p's
    type, summed in float64) and α = rz / p·q into the solve's device
    scalars (``state.set_alpha``); selected on the solve's active flag, so
    a no-op once it is 0."""
    q.copy_(torch.where(state.running(), stencil_matvec_soa(A_soa, p), q))
    state.set_alpha(dot64(p, q))


def stencil_matvec_dot_sym_plain(A_soa, p, q, state) -> None:
    """The half-stencil p·q form, plain: as :func:`stencil_matvec_dot_plain`
    with q = A p taken from A's upper half (:func:`stencil_matvec_sym_soa`)."""
    q.copy_(torch.where(state.running(), stencil_matvec_sym_soa(A_soa, p), q))
    state.set_alpha(dot64(p, q))


def stencil_matvec_dot(A_soa, p, q, state) -> None:
    """K1's p·q form (``stencil_spmv_kernel<T, T, true>``) on CUDA
    tensors, its plain version on CPU tensors: q = A p in place, and p·q
    and α into ``state``.  A, p and q of one dtype, f32 or f64, no halo.
    Counts its launches in ``stencil_matvec.launches`` (it is K1) and in
    ``stencil_matvec_dot.launches``."""
    if not A_soa.is_cuda:
        return stencil_matvec_dot_plain(A_soa, p, q, state)
    _launch_dot(_ENTRY_DOT, "stencil_matvec_dot", A_soa, p, q, state)
    stencil_matvec_dot.launches += 1


def stencil_matvec_dot_sym(A_soa, p, q, state) -> None:
    """The half-stencil p·q form (``stencil_spmv_kernel_sym<T>``) for a
    symmetric A on CUDA tensors, its plain version on CPU tensors: q = A p
    from blocks 13..26 of A alone, and p·q and α into ``state``.  The same
    arguments as :func:`stencil_matvec_dot`.  Counts its launches in
    ``stencil_matvec.launches`` (it is K1) and in
    ``stencil_matvec_dot_sym.launches``."""
    if not A_soa.is_cuda:
        return stencil_matvec_dot_sym_plain(A_soa, p, q, state)
    _launch_dot(_ENTRY_DOT_SYM, "stencil_matvec_dot_sym", A_soa, p, q, state)
    stencil_matvec_dot_sym.launches += 1


def _launch_dot(entries, what, A_soa, p, q, state) -> None:
    """Check the p·q forms' arguments and launch ``entries[A's dtype]``;
    counts the launch in ``stencil_matvec.launches``."""
    from macroc_tpu_torch.ops import _build

    nx, ny, nz = A_soa.shape[-3:]
    if A_soa.shape != (27, 3, 3, nx, ny, nz):
        raise ValueError(f"A_soa must be (27,3,3,nx,ny,nz), got {tuple(A_soa.shape)}")
    if p.shape != (3, nx, ny, nz) or q.shape != p.shape:
        raise ValueError(f"p {tuple(p.shape)} and q {tuple(q.shape)} do not fit A "
                         f"{(nx, ny, nz)}")
    entry = entries.get(A_soa.dtype)
    if entry is None or p.dtype != A_soa.dtype or q.dtype != A_soa.dtype:
        raise TypeError(f"{what} takes A, p and q of one dtype, float32 "
                        f"or float64, got {A_soa.dtype}, {p.dtype}, {q.dtype}")
    _check_device_layout(A_soa, p, what)
    if q.device != A_soa.device or not q.is_contiguous():
        raise ValueError(f"{what} needs a contiguous q on A's device")
    if state.sc.device != A_soa.device or state.partials is None:
        raise ValueError(f"{what}: the CGState is not on A's device")
    lib = _build.load()
    with torch.cuda.device(A_soa.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(
            A_soa.data_ptr(), p.data_ptr(), q.data_ptr(), nx, ny, nz,
            state.partials.data_ptr(), state.sc.data_ptr(), state.st.data_ptr(),
            stream,
        )
    _build.check(err, f"{what} (K1 p·q form)")
    stencil_matvec.launches += 1


stencil_matvec_dot.launches = 0
stencil_matvec_dot_sym.launches = 0
_ENTRY_DOT = {
    torch.float32: "macroc_stencil_spmv_dot_f32",
    torch.float64: "macroc_stencil_spmv_dot_f64",
}
_ENTRY_DOT_SYM = {
    torch.float32: "macroc_stencil_spmv_dot_sym_f32",
    torch.float64: "macroc_stencil_spmv_dot_sym_f64",
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
