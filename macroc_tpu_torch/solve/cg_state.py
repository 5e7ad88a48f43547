"""The stopping rules of the port's PCG (PETSc's KSPConvergedDefault) and
the device scalars of ``solve/cg.py``'s fused iteration.

:class:`CGState` holds one solve's scalars on its device: ``sc`` (float64)
and ``st`` (int32), indexed by the ``SC_*``/``ST_*`` constants, which
mirror ``csrc/cg_state.cuh``; the ``-ksp_monitor`` trace (float64,
maxits + 1); and the per-block partial sums the kernels reduce in a fixed
order.  The kernels (``ops/stencil_spmv.py::stencil_matvec_dot``,
``ops/cg_fused.py``) do the scalar steps below in their last block; their
plain versions call :meth:`CGState.set_alpha` and
:meth:`CGState.finish_iteration`.  The rules live here and, for the card,
in ``cg_state.cuh::finish_iteration``.
"""

from __future__ import annotations

import math

import torch

# PETSc KSPConvergedReason values (csrc/cg_state.cuh has the same)
KSP_CONVERGED_RTOL = 2
KSP_CONVERGED_ATOL = 3
KSP_DIVERGED_ITS = -3
KSP_DIVERGED_DTOL = -4

SC_RZ, SC_PQ, SC_ALPHA, SC_BETA, SC_RNORM, SC_TOL, SC_DIV, SC_ABSTOL = range(8)
ST_ITS, ST_REASON, ST_ACTIVE, ST_MAXITS, ST_PNORM, ST_COUNT = range(6)
THREADS = 256          # csrc/cg_state.cuh::THREADS
UPDATE_BLOCKS = 1024   # csrc/cg_fused.cu::UPDATE_BLOCKS


def reason(rnorm: float, tol: float, abstol: float, div: float) -> int:
    """CONVERGED_ATOL or _RTOL when rnorm <= tol, DIVERGED_DTOL when
    rnorm >= div, else 0 (still running)."""
    if rnorm <= tol:
        return KSP_CONVERGED_ATOL if rnorm <= abstol else KSP_CONVERGED_RTOL
    return KSP_DIVERGED_DTOL if rnorm >= div else 0


def reason_t(rnorm, tol, abstol, div) -> torch.Tensor:
    """:func:`reason` on tensors (elementwise), as int32."""
    conv = torch.where(rnorm <= abstol, KSP_CONVERGED_ATOL, KSP_CONVERGED_RTOL)
    return torch.where(
        rnorm <= tol, conv, torch.where(rnorm >= div, KSP_DIVERGED_DTOL, 0)
    ).to(torch.int32)


class CGState:
    """The device scalars of one PCG solve on ``device``, after its
    iteration 0: rz = r·z, rnorm0, tol, div, abstol, maxits, reason0, the
    norm type (``pnorm``: the preconditioned one); ``nodes`` sizes the
    partial sums of the kernels (none on the CPU); ``record_trace`` keeps
    rnorm per iteration.

    The scalar steps are selections on the active flag, never host reads:
    while it is 0 they leave every scalar as it is, as the kernels do."""

    def __init__(self, device, *, rz, rnorm0: float, tol: float, div: float,
                 abstol: float, maxits: int, reason0: int, pnorm: bool,
                 nodes: int = 0, record_trace: bool = False):
        dev = torch.device(device)
        self.pnorm = pnorm
        self.sc = torch.tensor([0.0, 0.0, 0.0, 0.0, rnorm0, tol, div, abstol],
                               dtype=torch.float64, device=dev)
        self.sc[SC_RZ] = rz
        active = int(reason0 == 0 and maxits > 0)
        self.st = torch.tensor([0, reason0, active, maxits, int(pnorm), 0],
                               dtype=torch.int32, device=dev)
        self.trace = None
        if record_trace:
            self.trace = torch.full((maxits + 1,), math.nan, dtype=torch.float64,
                                    device=dev)
            self.trace[0] = rnorm0
        self.partials = None
        if dev.type == "cuda":
            k1_blocks = -(-nodes // THREADS)
            self.partials = torch.empty(max(k1_blocks, 2 * UPDATE_BLOCKS),
                                        dtype=torch.float64, device=dev)

    def active(self) -> bool:
        """Whether the solve is still running (a host read)."""
        return bool(self.st[ST_ACTIVE])

    def running(self) -> torch.Tensor:
        """The active flag as a bool tensor on the state's device (no host
        read)."""
        return self.st[ST_ACTIVE].bool()

    def result(self):
        """(its, rnorm, reason, trace list or None): one host read."""
        st, sc = self.st.tolist(), self.sc.tolist()
        its = st[ST_ITS]
        trace = None if self.trace is None else self.trace[: its + 1].tolist()
        return its, sc[SC_RNORM], st[ST_REASON], trace

    def set_alpha(self, pq: torch.Tensor) -> None:
        """p·q and α = rz / p·q (the end of K1's p·q form)."""
        sc = self.sc
        new = sc.clone()
        new[SC_PQ] = pq
        new[SC_ALPHA] = sc[SC_RZ] / pq
        sc.copy_(torch.where(self.running(), new, sc))

    def finish_iteration(self, rz_new: torch.Tensor, nn: torch.Tensor) -> None:
        """The end of an iteration (``cg_state.cuh::finish_iteration``):
        β = rz_new / rz, rnorm = √nn, its + 1, the reason by
        :func:`reason`'s rules, the active flag and the trace."""
        sc, st, on = self.sc, self.st, self.running()
        rnorm = torch.sqrt(nn.to(torch.float64))
        new_sc, new_st = sc.clone(), st.clone()
        new_sc[SC_BETA] = rz_new.to(torch.float64) / sc[SC_RZ]
        new_sc[SC_RZ] = rz_new
        new_sc[SC_RNORM] = rnorm
        new_st[ST_ITS] = st[ST_ITS] + 1
        new_st[ST_REASON] = reason_t(rnorm, sc[SC_TOL], sc[SC_ABSTOL], sc[SC_DIV])
        new_st[ST_ACTIVE] = (new_st[ST_REASON] == 0) & (new_st[ST_ITS] < st[ST_MAXITS])
        if self.trace is not None:
            # while the flag is 0, trace[its] is written with itself
            i = torch.where(on, new_st[ST_ITS], st[ST_ITS]).long().reshape(1)
            self.trace.index_copy_(
                0, i, torch.where(on, rnorm, self.trace.index_select(0, i)[0]).reshape(1))
        sc.copy_(torch.where(on, new_sc, sc))
        st.copy_(torch.where(on, new_st, st))
