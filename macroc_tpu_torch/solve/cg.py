"""Preconditioned conjugate gradients with PETSc KSP semantics (torch form
of ``macroc_tpu/solve/cg.py``).

  - zero initial guess;
  - the *preconditioned* residual norm ||M^{-1} r||_2 is monitored (PETSc
    KSPCG's default norm type);
  - KSPConvergedDefault: converged when rnorm <= max(rtol * rnorm_0,
    abstol); diverged when rnorm >= dtol * rnorm_0 or its >= maxits
    (``solve/cg_state.py``).

Two routes, each the same on the CPU and the card:

  - fused: the operator is a
    :class:`~macroc_tpu_torch.ops.stencil_spmv.StencilOperator` (as
    ``problem.py`` passes it) and the preconditioner a
    :class:`~macroc_tpu_torch.solve.precond.DiagonalPrecond` (Jacobi or
    identity) or none, in one process.  An iteration is three calls, each a
    kernel on CUDA tensors and its plain version on CPU tensors: K1's p·q
    form (``ops/stencil_spmv.py::stencil_matvec_dot``), then
    ``ops/cg_fused.py::cg_update_xr`` and ``cg_update_p``.  An operator
    that applies K1's plain version runs the three plain versions on any
    device.  Inner products are products in the vectors' type summed in
    float64.  The convergence test runs on the device: the loop's scalars
    (rz, alpha, beta, rnorm, its, the reason, an ``active`` flag and the
    ``-ksp_monitor`` trace) live in a
    :class:`~macroc_tpu_torch.solve.cg_state.CGState`, and the host reads
    the flag every ``CHECK_EVERY`` iterations and the result at the end.
    Every call of an iteration is a no-op while the flag is 0, so the
    iterations queued after convergence change nothing: its, x, rnorm,
    reason and the trace are those of a test after every iteration.
  - any other operator or preconditioner (MG, block-Jacobi, matrix-free,
    a rank's halo matvec, a lambda): its own calls, the dots (summed in
    the vectors' type) and updates in torch operations, and the test on
    the host after every iteration.  Its calls cannot be made no-ops, so
    its scalars stay host-side.

``allreduce`` makes the solve distributed (always the second route): each
rank holds its block of the vectors, and every inner product is a local
sum all-reduced over the ranks (the only collectives of the loop; matvec
and precond do their own halo work).  The two dots after each update go in
one 2-element all-reduce.  Every branch reads all-reduced values only, so
all ranks take it alike.

``cg_solve_batched`` solves a batch of independent systems with the
semantics of ``jax.vmap(cg_solve)``: every member has its own dots, rnorm_0,
tolerance, reason and count, and a member that has stopped keeps its
iterate frozen while the others go on.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from macroc_tpu_torch.ops.cg_fused import (
    cg_update_p,
    cg_update_p_plain,
    cg_update_xr,
    cg_update_xr_plain,
    dot64,
)
from macroc_tpu_torch.ops.stencil_spmv import (
    StencilOperator,
    stencil_matvec,
    stencil_matvec_dot,
    stencil_matvec_dot_plain,
    stencil_matvec_soa,
)
from macroc_tpu_torch.solve.cg_state import (
    KSP_CONVERGED_ATOL,
    KSP_CONVERGED_RTOL,
    KSP_DIVERGED_DTOL,
    KSP_DIVERGED_ITS,
    CGState,
    reason as _reason,
    reason_t as _reason_t,
)
from macroc_tpu_torch.solve.precond import DiagonalPrecond

#: KSPConvergedReason value -> PETSc enum name (for -ksp_converged_reason)
KSP_REASON_NAMES = {
    KSP_CONVERGED_RTOL: "CONVERGED_RTOL",
    KSP_CONVERGED_ATOL: "CONVERGED_ATOL",
    KSP_DIVERGED_ITS: "DIVERGED_ITS",
    KSP_DIVERGED_DTOL: "DIVERGED_DTOL",
}

#: iterations between two host reads of the fused route's active flag
CHECK_EVERY = 16

#: the fused route's three calls, by the operator's ``apply``
_FUSED_STEPS = {
    stencil_matvec: (stencil_matvec_dot, cg_update_xr, cg_update_p),
    stencil_matvec_soa: (stencil_matvec_dot_plain, cg_update_xr_plain, cg_update_p_plain),
}


class KSPResult(NamedTuple):
    x: torch.Tensor
    its: int          # iteration count
    rnorm: float      # final monitored residual norm
    reason: int       # KSPConvergedReason
    # monitored residual norm per iteration (index 0 = rnorm0), only when
    # requested (-ksp_monitor)
    trace: Optional[list] = None


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b)


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


def _fused_operands(matvec, b, precond, allreduce):
    """(A_soa, inv, steps) when the fused route runs this solve (module
    docstring), else None; ``steps`` are its three calls.  The kernels take
    A, b and inv of one dtype, f32 or f64."""
    if (allreduce is not None or not isinstance(matvec, StencilOperator)
            or not (precond is None or isinstance(precond, DiagonalPrecond))):
        return None
    A_soa = matvec.A_soa
    inv = None if precond is None else precond.inv
    if (b.dtype not in (torch.float32, torch.float64) or A_soa.dtype != b.dtype
            or b.shape != (3,) + tuple(A_soa.shape[-3:])
            or (inv is not None and (inv.shape != b.shape or inv.dtype != b.dtype))):
        return None
    return A_soa, inv, _FUSED_STEPS[matvec.apply]


def cg_solve(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    precond: Callable[[torch.Tensor], torch.Tensor] | None = None,
    *,
    rtol: float = 1.0e-5,
    abstol: float = 1.0e-50,
    dtol: float = 1.0e4,
    maxits: int = 10000,
    norm_type: str = "preconditioned",
    record_trace: bool = False,
    allreduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> KSPResult:
    """Solve A x = b by PCG; matvec/precond map like-shaped tensors.
    ``allreduce`` sums a tensor of per-rank partial sums over the ranks
    (None: one process)."""
    fused = _fused_operands(matvec, b, precond, allreduce)
    if precond is None:
        precond = _identity
    reduce = allreduce or _identity
    use_pnorm = norm_type == "preconditioned"
    dot = _dot if fused is None else dot64  # as the kernels sum

    def dots(r, z):
        """(r.z, monitored norm squared), all-reduced together."""
        return reduce(torch.stack([dot(r, z), dot(z, z) if use_pnorm else dot(r, r)]))

    r = b.clone()  # x0 = 0
    z = precond(r)
    rz, nn = dots(r, z)
    rnorm0 = math.sqrt(float(nn))
    x = torch.zeros_like(b)

    tol = max(rtol * rnorm0, abstol)
    div = dtol * rnorm0
    # converged already at iteration 0 (e.g. b == 0)?
    reason = _reason(rnorm0, tol, abstol, math.inf)
    if fused is None:
        p = z
        rnorm = rnorm0
        trace = [rnorm0] if record_trace else None
        its = 0
        while reason == 0 and its < maxits:
            q = matvec(p)
            alpha = rz / reduce(_dot(p, q))
            x += alpha * p
            # not in place: the identity preconditioner returns r itself, so
            # z and p may alias it
            r = r - alpha * q
            z = precond(r)
            rz_new, nn = dots(r, z)
            p = z + (rz_new / rz) * p
            rz = rz_new
            rnorm = math.sqrt(float(nn))
            its += 1
            reason = _reason(rnorm, tol, abstol, div)
            if trace is not None:
                trace.append(rnorm)
    else:
        A_soa, inv, (spmv_dot, update_xr, update_p) = fused
        state = CGState(b.device, rz=rz, rnorm0=rnorm0, tol=tol, div=div, abstol=abstol,
                        maxits=maxits, reason0=reason, pnorm=use_pnorm,
                        nodes=b[0].numel(), record_trace=record_trace)
        # the kernels update r and p in place: p must not alias r
        p = z.clone() if z is r else z
        q = torch.empty_like(b)
        queued = 0
        while queued < maxits and (queued % CHECK_EVERY or state.active()):
            spmv_dot(A_soa, p, q, state)
            update_xr(x, p, r, q, inv, state)
            update_p(p, r, inv, state)
            queued += 1
        its, rnorm, reason, trace = state.result()
    if reason == 0 and its >= maxits:
        reason = KSP_DIVERGED_ITS
    return KSPResult(x=x, its=its, rnorm=rnorm, reason=reason, trace=trace)


class BatchedKSPResult(NamedTuple):
    x: torch.Tensor       # (g, ...) solutions
    its: torch.Tensor     # (g,) int32 iteration counts
    rnorm: torch.Tensor   # (g,) final monitored residual norms
    reason: torch.Tensor  # (g,) int32 KSPConvergedReason


def cg_solve_batched(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    precond: Callable[[torch.Tensor], torch.Tensor] | None = None,
    *,
    rtol: float = 1.0e-5,
    abstol: float = 1.0e-50,
    dtol: float = 1.0e4,
    maxits: int = 10000,
    syncs: Optional[list] = None,
) -> BatchedKSPResult:
    """PCG on g independent systems at once: b (g, ...), matvec and precond
    map (g, ...) batches member by member.  Preconditioned norm, as
    cg_solve.

    One host sync per iteration decides whether any member is still
    running; stopped members are frozen by selection, never by arithmetic,
    so the 0/0 step of a member that converged at iteration 0 (b = 0)
    cannot reach its result.  ``syncs`` (a one-element list) counts those
    host syncs."""
    if precond is None:
        precond = lambda r: r
    g = b.shape[0]

    def dot(u, v):
        return (u * v).reshape(g, -1).sum(dim=1)

    def col(v):  # (g,) -> broadcastable against (g, ...)
        return v.reshape((g,) + (1,) * (b.ndim - 1))

    r = b.clone()  # x0 = 0
    z = precond(r)
    rz = dot(r, z)
    rnorm0 = torch.sqrt(dot(z, z))
    x = torch.zeros_like(b)
    p = z
    tol = torch.clamp_min(rtol * rnorm0, abstol)
    div = dtol * rnorm0
    # converged already at iteration 0 (e.g. b == 0)?
    reason = _reason_t(rnorm0, tol, abstol, torch.full_like(rnorm0, math.inf))
    rnorm = rnorm0
    its = torch.zeros(g, dtype=torch.int32, device=b.device)
    while True:
        active = (reason == 0) & (its < maxits)
        if syncs is not None:
            syncs[0] += 1
        if not bool(active.any()):
            break
        q = matvec(p)
        keep = col(active)
        alpha = col(rz / dot(p, q))
        x = torch.where(keep, x + alpha * p, x)
        r = torch.where(keep, r - alpha * q, r)
        z = precond(r)
        rz_new = dot(r, z)
        p = torch.where(keep, z + col(rz_new / rz) * p, p)
        rz = torch.where(active, rz_new, rz)
        rn = torch.sqrt(dot(z, z))
        rnorm = torch.where(active, rn, rnorm)
        reason = torch.where(active, _reason_t(rn, tol, abstol, div), reason)
        its = its + active.to(torch.int32)
    reason = torch.where((reason == 0) & (its >= maxits), KSP_DIVERGED_ITS, reason)
    return BatchedKSPResult(x=x, its=its, rnorm=rnorm, reason=reason.to(torch.int32))
