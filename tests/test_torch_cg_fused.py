"""The fused PCG iteration of ``macroc_tpu_torch/solve/cg.py`` (K1's p·q
form and the two update kernels, here their plain versions on the CPU)
against the JAX package's ``cg_solve``, at float64 on a 9^3 cube and a
9x3x9 pancake (``test_torch_modules._operators``).

Tolerances: x within 1e-10 of the largest magnitude (``test_cg_jacobi``'s:
the same roundoff carried through a few dozen iterations); the
``-ksp_monitor`` trace within 1e-12 relative; counts and reasons equal.
The host's check interval must not change the result: 1 and 16 are
bitwise equal, since the iterations queued after convergence are
no-ops."""

from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macroc_tpu.ops.stencil_pallas import stencil_matvec_soa as jmv
from macroc_tpu.solve import cg_solve as jcg, jacobi_precond_soa as jjac
from macroc_tpu_torch.ops import cg_fused
from macroc_tpu_torch.ops.stencil_spmv import (
    StencilOperator,
    stencil_matvec,
    stencil_matvec_dot,
    stencil_matvec_soa,
)
from macroc_tpu_torch.solve import cg as tcg, cg_state
from macroc_tpu_torch.solve.cg import (
    KSP_CONVERGED_ATOL,
    KSP_CONVERGED_RTOL,
    KSP_DIVERGED_DTOL,
    KSP_DIVERGED_ITS,
    cg_solve,
)
from macroc_tpu_torch.solve.precond import identity_precond, jacobi_precond_soa
from test_torch_modules import CASES, _operators, _rel, _t

torch.set_num_threads(1)

PRECONDS = ("jacobi", "none")


def _jax_solve(A_j, b, pc, **kw):
    return jcg(lambda v: jmv(A_j, v), jnp.asarray(b), jjac(A_j) if pc == "jacobi" else None,
               **kw)


def _fused(A_t, b, pc, **kw):
    M = jacobi_precond_soa(A_t) if pc == "jacobi" else identity_precond()
    return cg_solve(StencilOperator(A_t), _t(b), M, **kw)


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    _, _, _, _, A_j, A_t, b = _operators(request.param)
    return A_j, A_t, b


@pytest.mark.parametrize("pc", PRECONDS)
def test_fused_route_matches_jax(case, pc):
    A_j, A_t, b = case
    rj = _jax_solve(A_j, b, pc, record_trace=200)
    rt = _fused(A_t, b, pc, record_trace=True)
    assert tcg._fused_operands(StencilOperator(A_t), _t(b),
                               jacobi_precond_soa(A_t), None) is not None
    assert rt.its == int(rj.its) > 5 and rt.reason == int(rj.reason) == KSP_CONVERGED_RTOL
    assert _rel(rt.x, rj.x) < 1e-10
    trace_j = np.asarray(rj.trace)[: rt.its + 1]
    assert len(rt.trace) == rt.its + 1
    assert np.max(np.abs(np.array(rt.trace) - trace_j) / np.abs(trace_j)) < 1e-12
    assert rt.rnorm == rt.trace[-1]


@pytest.mark.parametrize("pc", PRECONDS)
def test_check_interval_changes_nothing(case, pc, monkeypatch):
    """k = 1 and k = 16 (and one that is not a divisor of the count):
    bitwise-equal x and trace, equal counts."""
    _, A_t, b = case
    runs = []
    for k in (1, 16, 7):
        monkeypatch.setattr(tcg, "CHECK_EVERY", k)
        runs.append(_fused(A_t, b, pc, record_trace=True))
    for r in runs[1:]:
        assert (r.its, r.reason, r.rnorm) == (runs[0].its, runs[0].reason, runs[0].rnorm)
        assert torch.equal(r.x, runs[0].x)
        assert r.trace == runs[0].trace


def test_unpreconditioned_norm_matches_jax(case):
    A_j, A_t, b = case
    rj = _jax_solve(A_j, b, "jacobi", norm_type="unpreconditioned")
    rt = _fused(A_t, b, "jacobi", norm_type="unpreconditioned")
    assert rt.its == int(rj.its) and rt.reason == int(rj.reason)
    assert abs(rt.rnorm - float(rj.rnorm)) <= 1e-12 * float(rj.rnorm)
    assert _rel(rt.x, rj.x) < 1e-10


@pytest.mark.parametrize("stop", ["zero_rhs", "maxits", "dtol"])
def test_stopping_reasons_match_jax(case, stop, monkeypatch):
    """b = 0 (converged at iteration 0), maxits (DIVERGED_ITS) and dtol
    (DIVERGED_DTOL): the JAX package's reason and count, x equal."""
    A_j, A_t, b = case
    kw = {"zero_rhs": {}, "maxits": dict(maxits=5), "dtol": dict(dtol=0.3)}[stop]
    if stop == "zero_rhs":
        b = np.zeros_like(b)
    want = {"zero_rhs": KSP_CONVERGED_ATOL, "maxits": KSP_DIVERGED_ITS,
            "dtol": KSP_DIVERGED_DTOL}[stop]
    rj = _jax_solve(A_j, b, "jacobi", **kw)
    for k in (1, 16):
        monkeypatch.setattr(tcg, "CHECK_EVERY", k)
        rt = _fused(A_t, b, "jacobi", **kw)
        assert rt.reason == int(rj.reason) == want
        assert rt.its == int(rj.its)
        assert _rel(rt.x, rj.x) < 1e-10 if stop != "zero_rhs" else not rt.x.any()


def test_routes_agree(case):
    """The fused route, its plain-operator form and the other route (an
    opaque lambda) take the same iterations to the same x.  The route is
    chosen by the operator's and the preconditioner's types alone."""
    _, A_t, b = case
    M = jacobi_precond_soa(A_t)
    fused = cg_solve(StencilOperator(A_t), _t(b), M, record_trace=True)
    plain = cg_solve(StencilOperator(A_t, stencil_matvec_soa), _t(b), M, record_trace=True)
    opaque = cg_solve(lambda v: stencil_matvec(A_t, v), _t(b), lambda r: M(r),
                      record_trace=True)
    for mv, pc, allreduce in ((lambda v: stencil_matvec(A_t, v), M, None),
                              (partial(stencil_matvec, A_t), M, None),
                              (StencilOperator(A_t), lambda r: M(r), None),
                              (StencilOperator(A_t), M, torch.clone)):
        assert tcg._fused_operands(mv, _t(b), pc, allreduce) is None
    assert torch.equal(plain.x, fused.x) and plain.trace == fused.trace
    assert opaque.its == fused.its and opaque.reason == fused.reason
    assert _rel(opaque.x, fused.x) < 1e-12
    with pytest.raises(ValueError):
        StencilOperator(A_t, lambda A, v: stencil_matvec(A, v))


@pytest.mark.parametrize("k", [1, 5, 16])
def test_host_reads_the_flag_every_k(case, k, monkeypatch):
    """The fused route reads the active flag once per k queued iterations
    and at the start, and no call of an iteration reads it."""
    _, A_t, b = case
    reads = []
    read = cg_state.CGState.active
    monkeypatch.setattr(cg_state.CGState, "active", lambda st: reads.append(1) or read(st))
    monkeypatch.setattr(tcg, "CHECK_EVERY", k)
    r = _fused(A_t, b, "jacobi")
    assert r.reason == KSP_CONVERGED_RTOL and len(reads) == -(-r.its // k) + 1


def _state(b, *, active=True, maxits=100, pnorm=True):
    return cg_state.CGState(b.device, rz=torch.tensor(2.0, dtype=torch.float64),
                            rnorm0=1.0, tol=1e-9, div=1e9, abstol=1e-50, maxits=maxits,
                            reason0=0 if active else KSP_CONVERGED_RTOL, pnorm=pnorm,
                            nodes=b[0].numel(), record_trace=True)


def test_steps_are_noops_when_inactive():
    """Each of the three calls leaves every vector and scalar as it is when
    the active flag is 0."""
    rng = np.random.default_rng(3)
    shape = (5, 4, 6)
    A = _t(rng.normal(size=(27, 3, 3) + shape))
    x, p, r, q, inv = (_t(rng.normal(size=(3,) + shape)) for _ in range(5))
    state = _state(x, active=False)
    before = [t.clone() for t in (x, p, r, q, state.sc, state.st, state.trace)]
    stencil_matvec_dot(A, p, q, state)
    cg_fused.cg_update_xr(x, p, r, q, inv, state)
    cg_fused.cg_update_p(p, r, inv, state)
    after = (x, p, r, q, state.sc, state.st, state.trace)
    # the trace holds NaN past index 0
    assert all(torch.equal(torch.nan_to_num(a), torch.nan_to_num(b_))
               for a, b_ in zip(after, before))


@pytest.mark.parametrize("pnorm", [True, False])
def test_one_iteration_by_hand(pnorm):
    """One active iteration of the three plain steps against the PCG
    update written out: q, alpha, x, r, beta, p, rnorm, its and the
    trace."""
    rng = np.random.default_rng(4)
    shape = (5, 4, 6)
    A = _t(rng.normal(size=(27, 3, 3) + shape))
    x, p, r, inv = (_t(rng.normal(size=(3,) + shape)) for _ in range(4))
    x0, p0, r0 = x.clone(), p.clone(), r.clone()
    q = torch.empty_like(p)
    state = _state(x, pnorm=pnorm)
    stencil_matvec_dot(A, p, q, state)
    q_ref = stencil_matvec_soa(A, p0)
    alpha = 2.0 / float((p0 * q_ref).sum())
    assert torch.equal(q, q_ref)
    assert float(state.sc[cg_state.SC_ALPHA]) == pytest.approx(alpha, rel=1e-14)
    cg_fused.cg_update_xr(x, p, r, q, inv, state)
    cg_fused.cg_update_p(p, r, inv, state)
    r_ref = r0 - alpha * q_ref
    z = inv * r_ref
    rz = float((r_ref * z).sum())
    nn = float((z * z).sum()) if pnorm else float((r_ref * r_ref).sum())
    assert _rel(x, x0 + alpha * p0) < 1e-14 and _rel(r, r_ref) < 1e-14
    assert _rel(p, z + rz / 2.0 * p0) < 1e-14
    assert int(state.st[cg_state.ST_ITS]) == 1 and int(state.st[cg_state.ST_ACTIVE]) == 1
    assert float(state.sc[cg_state.SC_RNORM]) == pytest.approx(nn ** 0.5, rel=1e-14)
    assert float(state.trace[1]) == float(state.sc[cg_state.SC_RNORM])
    assert float(state.sc[cg_state.SC_RZ]) == pytest.approx(rz, rel=1e-14)
