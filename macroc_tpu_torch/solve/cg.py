"""Preconditioned conjugate gradients with PETSc KSP semantics (torch form
of ``macroc_tpu/solve/cg.py``).

  - zero initial guess;
  - the *preconditioned* residual norm ||M^{-1} r||_2 is monitored (PETSc
    KSPCG's default norm type);
  - KSPConvergedDefault: converged when rnorm <= max(rtol * rnorm_0,
    abstol); diverged when rnorm >= dtol * rnorm_0 or its >= maxits.

The convergence test runs on the host every iteration (one device sync per
iteration), so iteration counts are exact.

``allreduce`` makes the solve distributed: each rank holds its block of the
vectors, and every inner product is a local sum all-reduced over the ranks
(the only collectives of the loop; matvec and precond do their own halo
work).  The two dots after each update go in one 2-element all-reduce.
Every branch reads all-reduced values only, so all ranks take it alike.

``cg_solve_batched`` solves a batch of independent systems with the
semantics of ``jax.vmap(cg_solve)``: every member has its own dots, rnorm_0,
tolerance, reason and count, and a member that has stopped keeps its
iterate frozen while the others go on.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

# PETSc KSPConvergedReason values (for log parity)
KSP_CONVERGED_RTOL = 2
KSP_CONVERGED_ATOL = 3
KSP_DIVERGED_ITS = -3
KSP_DIVERGED_DTOL = -4

#: KSPConvergedReason value -> PETSc enum name (for -ksp_converged_reason)
KSP_REASON_NAMES = {
    2: "CONVERGED_RTOL",
    3: "CONVERGED_ATOL",
    -3: "DIVERGED_ITS",
    -4: "DIVERGED_DTOL",
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


def _reason_t(rnorm, tol, abstol: float, div):
    """_reason on per-member tensors."""
    conv = torch.where(rnorm <= abstol, KSP_CONVERGED_ATOL, KSP_CONVERGED_RTOL)
    return torch.where(
        rnorm <= tol, conv, torch.where(rnorm >= div, KSP_DIVERGED_DTOL, 0)
    ).to(torch.int32)


def _reason(rnorm: float, tol: float, abstol: float, div: float) -> int:
    if rnorm <= tol:
        return KSP_CONVERGED_ATOL if rnorm <= abstol else KSP_CONVERGED_RTOL
    return KSP_DIVERGED_DTOL if rnorm >= div else 0


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
    if precond is None:
        precond = lambda r: r
    reduce = allreduce or _identity
    use_pnorm = norm_type == "preconditioned"

    def dots(r, z):
        """(r.z, monitored norm squared), all-reduced together."""
        return reduce(torch.stack([_dot(r, z), _dot(z, z) if use_pnorm else _dot(r, r)]))

    r = b.clone()  # x0 = 0
    z = precond(r)
    rz, nn = dots(r, z)
    rnorm0 = math.sqrt(float(nn))
    x = torch.zeros_like(b)
    p = z

    tol = max(rtol * rnorm0, abstol)
    div = dtol * rnorm0
    # converged already at iteration 0 (e.g. b == 0)?
    reason = _reason(rnorm0, tol, abstol, math.inf)
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
