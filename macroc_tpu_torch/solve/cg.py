"""Preconditioned conjugate gradients with PETSc KSP semantics (torch form
of ``macroc_tpu/solve/cg.py``).

  - zero initial guess;
  - the *preconditioned* residual norm ||M^{-1} r||_2 is monitored (PETSc
    KSPCG's default norm type);
  - KSPConvergedDefault: converged when rnorm <= max(rtol * rnorm_0,
    abstol); diverged when rnorm >= dtol * rnorm_0 or its >= maxits.

The convergence test runs on the host every iteration (one device sync per
iteration), so iteration counts are exact.
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
) -> KSPResult:
    """Solve A x = b by PCG; matvec/precond map like-shaped tensors."""
    if precond is None:
        precond = lambda r: r
    use_pnorm = norm_type == "preconditioned"

    r = b.clone()  # x0 = 0
    z = precond(r)
    rz = _dot(r, z)
    rnorm0 = math.sqrt(float(_dot(z, z) if use_pnorm else _dot(r, r)))
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
        alpha = rz / _dot(p, q)
        x += alpha * p
        r -= alpha * q
        z = precond(r)
        rz_new = _dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        rnorm = math.sqrt(float(_dot(z, z) if use_pnorm else _dot(r, r)))
        its += 1
        reason = _reason(rnorm, tol, abstol, div)
        if trace is not None:
            trace.append(rnorm)
    if reason == 0 and its >= maxits:
        reason = KSP_DIVERGED_ITS
    return KSPResult(x=x, its=its, rnorm=rnorm, reason=reason, trace=trace)
