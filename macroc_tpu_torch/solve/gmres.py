"""Restarted GMRES with PETSc KSP semantics, left preconditioning (torch
form of ``macroc_tpu/solve/gmres.py``).

Same convergence rules as ``solve/cg.py``: the monitored norm is the
preconditioned residual norm, tol = max(rtol * ||M b||, abstol), diverged
at dtol * ||M b||.  Each restart cycle starts from the true preconditioned
residual M (b - A x) and runs up to ``restart`` Arnoldi steps: CGS2
orthogonalisation against the (restart+1, N) basis, then Givens rotations
that keep the residual-norm estimate |g[j+1]|.

The small Hessenberg work (rotations, the residual estimate, the
back-substitution) runs on the host in the vectors' dtype, so each Arnoldi
step makes one host read of its new Hessenberg column, which is also the
per-iteration convergence test.  The JAX code runs all ``restart`` steps of
a cycle and masks those after convergence; masked steps change nothing, so
a cycle here stops at the step that set a reason.  A reason, DIVERGED_ITS
included, is set inside a cycle, at the step where ``its + 1 >= maxits``.

``allreduce``, as in ``cg_solve``, makes the solve distributed: the CGS2
projections and the norms are local sums all-reduced over the ranks.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from macroc_tpu_torch.solve.cg import (
    KSP_CONVERGED_ATOL,
    KSP_CONVERGED_RTOL,
    KSP_DIVERGED_DTOL,
    KSP_DIVERGED_ITS,
    KSPResult,
)

#: guard below which a norm counts as zero (macroc_tpu/solve/gmres.py:70)
TINY = 1e-30


def _back_substitute(H: np.ndarray, g: np.ndarray) -> np.ndarray:
    """y from the upper-triangular H[:m,:m] y = g[:m], where a column with a
    zero diagonal counts as not run: its diagonal becomes 1 and its right
    hand side 0 (macroc_tpu/solve/gmres.py:158-163)."""
    m = H.shape[1]
    y = np.zeros(m, H.dtype)
    for i in range(m - 1, -1, -1):
        ran = abs(H[i, i]) > 0
        rhs = g[i] if ran else H.dtype.type(0)
        rhs = rhs - H[i, i + 1:m] @ y[i + 1:]
        y[i] = rhs / H[i, i] if ran else rhs
    return y


def gmres_solve(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    precond: Callable[[torch.Tensor], torch.Tensor] | None = None,
    *,
    rtol: float = 1.0e-5,
    abstol: float = 1.0e-50,
    dtol: float = 1.0e4,
    maxits: int = 10000,
    restart: int = 30,
    record_trace: int = 0,
    allreduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> KSPResult:
    """Solve A x = b by left-preconditioned restarted GMRES(restart).

    ``record_trace`` > 0 returns KSPResult.trace as a list of that length,
    nan-padded: entry 0 is ||M b||, entry min(its, record_trace-1) the
    estimate after each iteration (the -ksp_monitor data)."""
    if precond is None:
        precond = lambda r: r
    shape, dtype, dev = b.shape, b.dtype, b.device
    npdt = torch.empty((), dtype=dtype).numpy().dtype  # host Hessenberg dtype
    N = b.numel()
    m = restart
    tiny = npdt.type(TINY)

    def M(v):
        return precond(v.reshape(shape)).reshape(-1)

    def A(v):
        return matvec(v.reshape(shape)).reshape(-1)

    reduce = allreduce or (lambda t: t)

    def norm(v):
        if allreduce is None:
            return torch.linalg.vector_norm(v)
        return torch.sqrt(allreduce(torch.sum(v * v)))

    b_flat = b.reshape(-1)
    rnorm0 = npdt.type(norm(M(b_flat)).item())
    tol = max(rtol * rnorm0, abstol)
    div = dtol * rnorm0
    reason = 0
    if rnorm0 <= tol:
        reason = KSP_CONVERGED_ATOL if rnorm0 <= abstol else KSP_CONVERGED_RTOL
    trace = None
    if record_trace:
        trace = [math.nan] * record_trace
        trace[0] = float(rnorm0)

    x = torch.zeros(N, dtype=dtype, device=dev)
    its = 0
    rnorm = rnorm0
    while reason == 0 and its < maxits:
        # a cycle restarts from the true preconditioned residual; rnorm
        # keeps the last estimate until the first step of the cycle
        r = M(b_flat - A(x))
        beta = npdt.type(norm(r).item())
        V = torch.zeros((m + 1, N), dtype=dtype, device=dev)
        if beta > tiny:
            V[0] = r / float(beta)
        del r
        H = np.zeros((m + 1, m), npdt)
        cs = np.zeros(m, npdt)
        sn = np.zeros(m, npdt)
        g = np.zeros(m + 1, npdt)
        g[0] = beta
        for j in range(m):
            w = M(A(V[j]))
            # CGS2: rows > j of V are zero and contribute nothing
            h = reduce(V @ w)
            w = w - V.T @ h
            h2 = reduce(V @ w)
            w = w - V.T @ h2
            h = h + h2
            hnext_t = norm(w)
            hcol = torch.cat([h, hnext_t.reshape(1)]).cpu().numpy()
            hnext = hcol[m + 1]
            hcol = hcol[:m + 1].copy()
            if hnext > tiny:
                V[j + 1] = w / hnext_t
            del w
            hcol[j + 1] = hnext
            # previous rotations on the new column, then the one that
            # annihilates hcol[j+1]
            for i in range(j):
                t = cs[i] * hcol[i] + sn[i] * hcol[i + 1]
                hcol[i + 1] = -sn[i] * hcol[i] + cs[i] * hcol[i + 1]
                hcol[i] = t
            denom = np.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
            if denom > tiny:
                c, s = hcol[j] / denom, hcol[j + 1] / denom
            else:
                c, s = npdt.type(1), npdt.type(0)
            hcol[j] = denom
            hcol[j + 1] = 0
            gj = g[j]
            g[j] = c * gj
            g[j + 1] = -s * gj
            rnorm = abs(g[j + 1])
            if rnorm <= tol:
                reason = KSP_CONVERGED_ATOL if rnorm <= abstol else KSP_CONVERGED_RTOL
            elif rnorm >= div:
                reason = KSP_DIVERGED_DTOL
            elif its + 1 >= maxits:
                reason = KSP_DIVERGED_ITS
            H[:, j] = hcol
            cs[j], sn[j] = c, s
            its += 1
            if trace is not None:
                trace[min(its, record_trace - 1)] = float(rnorm)
            if reason != 0:
                break
        y = _back_substitute(H[:m], g)
        x = x + V[:m].T @ torch.as_tensor(y, device=dev)
        del V
    return KSPResult(x=x.reshape(shape), its=its, rnorm=float(rnorm),
                     reason=reason, trace=trace)
