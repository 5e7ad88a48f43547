"""The fused PCG iteration's two update kernels (``csrc/cg_fused.cu``), with
their plain versions.  Port-only: the JAX package's CG
(``macroc_tpu/solve/cg.py``) is one ``lax.while_loop`` that XLA fuses;
``solve/cg.py::cg_solve`` runs an iteration as K1's p·q form
(``ops/stencil_spmv.py::stencil_matvec_dot``) and the two kernels here:

  ``cg_update_xr``  x += α p; r −= α q; z = inv_diag r; r·z and the monitored
                    norm's square, and the end of the iteration (β, rnorm,
                    its, reason, the active flag, the trace);
  ``cg_update_p``   p = z + β p, z recomputed from r.

Each wrapper launches its kernel for CUDA tensors and runs its plain
version (``*_plain``) for CPU tensors; nothing falls back from one to the
other.  Every one of them is a no-op while the solve's active flag is 0:
the plain versions select on the flag, so they read nothing back to the
host.  ``state`` is the solve's ``solve/cg_state.py::CGState``.
"""

from __future__ import annotations

import torch

from macroc_tpu_torch.solve.cg_state import SC_ALPHA, SC_BETA


def dot64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·b as the kernels take it: products in the vectors' type, the sum
    in float64."""
    return torch.sum(a * b, dtype=torch.float64)


def _z(r, inv):
    return r if inv is None else inv * r


def cg_update_xr_plain(x, p, r, q, inv, state) -> None:
    """Kernel (a)'s plain version, in place on x and r, then the end of the
    iteration into ``state``."""
    on = state.running()
    alpha = state.sc[SC_ALPHA].to(x.dtype)
    x.copy_(torch.where(on, x + alpha * p, x))
    r.copy_(torch.where(on, r - alpha * q, r))
    z = _z(r, inv)
    state.finish_iteration(dot64(r, z), dot64(z, z) if state.pnorm else dot64(r, r))


def cg_update_p_plain(p, r, inv, state) -> None:
    """Kernel (b)'s plain version, in place on p."""
    beta = state.sc[SC_BETA].to(p.dtype)
    p.copy_(torch.where(state.running(), _z(r, inv) + beta * p, p))


def _check(what, vectors, state):
    """The kernels take contiguous f32 or f64 vectors of one shape, dtype
    and device (inv may be None), and a state on that device."""
    ref = vectors[0]
    for v in vectors:
        if v is None:
            continue
        if v.shape != ref.shape or v.dtype != ref.dtype or v.device != ref.device:
            raise ValueError(f"{what}: vectors differ in shape, dtype or device")
        if not v.is_contiguous() or v.data_ptr() % 16:
            raise ValueError(f"{what} needs contiguous vectors on 16-byte boundaries "
                             "(the kernels load 16 bytes at a time)")
    if ref.dtype not in _SUFFIX:
        raise TypeError(f"{what} takes float32 or float64 vectors, got {ref.dtype}")
    if state.sc.device != ref.device or state.partials is None:
        raise ValueError(f"{what}: the CGState is not on the vectors' device")


_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _ptr(t):
    return None if t is None else t.data_ptr()


def cg_update_xr(x, p, r, q, inv, state) -> None:
    """Kernel (a) (``cg_update_xr_kernel``) on CUDA tensors, its plain
    version on CPU tensors; in place on x and r and the state.  Counts
    launches in ``cg_update_xr.launches``."""
    if not x.is_cuda:
        return cg_update_xr_plain(x, p, r, q, inv, state)
    from macroc_tpu_torch.ops import _build

    _check("cg_update_xr", (x, p, r, q, inv), state)
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, f"macroc_cg_update_xr_{_SUFFIX[x.dtype]}")(
            x.data_ptr(), p.data_ptr(), r.data_ptr(), q.data_ptr(), _ptr(inv),
            x.numel(), state.partials.data_ptr(), state.sc.data_ptr(),
            state.st.data_ptr(), _ptr(state.trace), stream,
        )
    _build.check(err, "cg_update_xr")
    cg_update_xr.launches += 1


def cg_update_p(p, r, inv, state) -> None:
    """Kernel (b) (``cg_update_p_kernel``) on CUDA tensors, its plain
    version on CPU tensors; in place on p.  Counts launches in
    ``cg_update_p.launches``."""
    if not p.is_cuda:
        return cg_update_p_plain(p, r, inv, state)
    from macroc_tpu_torch.ops import _build

    _check("cg_update_p", (p, r, inv), state)
    lib = _build.load()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, f"macroc_cg_update_p_{_SUFFIX[p.dtype]}")(
            p.data_ptr(), r.data_ptr(), _ptr(inv), p.numel(),
            state.sc.data_ptr(), state.st.data_ptr(), stream,
        )
    _build.check(err, "cg_update_p")
    cg_update_p.launches += 1


cg_update_xr.launches = 0
cg_update_p.launches = 0
