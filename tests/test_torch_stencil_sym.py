"""The half-stencil form of K1's p·q kernel (``stencil_matvec_dot_sym``),
here its plain versions on the CPU: the product from the upper half of a
symmetric A (``stencil_matvec_sym_soa``) against the full product of the
port and of the JAX package, on the BC-eliminated operators of
``test_torch_modules._operators`` (a 9^3 cube and a 9x3x9 pancake).

Tolerances, relative to the largest magnitude: 1e-14 at float64 and 1e-6
at float32 (the same sums in another order, on an operator that is
symmetric to roundoff: 4e-17 at float64, 4e-8 at float32); p·q and α
within 1e-14 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macroc_tpu.ops.stencil_pallas import stencil_matvec_soa as jmv
from macroc_tpu_torch.constitutive import ElasticEngine, J2Engine
from macroc_tpu_torch.constitutive.microfe import MicroFEEngine
from macroc_tpu_torch.ops.stencil_spmv import (
    StencilOperator,
    stencil_asymmetry,
    stencil_matvec,
    stencil_matvec_dot,
    stencil_matvec_dot_plain,
    stencil_matvec_dot_sym,
    stencil_matvec_dot_sym_plain,
    stencil_matvec_soa,
    stencil_matvec_sym_soa,
    stencil_transpose_soa,
)
from macroc_tpu_torch.solve import cg as tcg, cg_state
from macroc_tpu_torch.solve.precond import jacobi_precond_soa
from test_torch_modules import CASES, _operators, _rel, _t

torch.set_num_threads(1)

TOLS = {torch.float64: 1e-14, torch.float32: 1e-6}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    _, _, _, _, A_j, A_t, b = _operators(request.param)
    return A_j, A_t, b


def _x(shape, seed=5):
    return np.random.default_rng(seed).normal(size=(3,) + tuple(shape))


def _state(like):
    return cg_state.CGState(like.device, rz=torch.tensor(2.0, dtype=torch.float64),
                            rnorm0=1.0, tol=1e-9, div=1e9, abstol=1e-50, maxits=100,
                            reason0=0, pnorm=True, nodes=like[0].numel(),
                            record_trace=False)


@pytest.mark.parametrize("dtype", list(TOLS))
def test_sym_product_matches_full(case, dtype):
    """Against the port's full product and the JAX package's, in one dtype."""
    A_j, A_t, _ = case
    x = _x(A_t.shape[-3:])
    A, xt = A_t.to(dtype), _t(x).to(dtype)
    y = stencil_matvec_sym_soa(A, xt)
    assert y.dtype == dtype
    assert _rel(y, stencil_matvec_soa(A, xt)) < TOLS[dtype]
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    y_j = jmv(jnp.asarray(np.asarray(A_j), dtype=jdt), jnp.asarray(x, dtype=jdt))
    assert _rel(y, y_j) < TOLS[dtype]


def test_operators_are_symmetric_to_roundoff(case):
    """The precondition of the half-stencil form, on both packages'
    operators; and the transpose it mirrors against a dense transpose."""
    A_j, A_t, _ = case
    assert stencil_asymmetry(A_t) < 1e-15
    assert stencil_asymmetry(_t(A_j)) < 1e-15
    assert stencil_asymmetry(A_t.float()) < 1e-6
    rng = np.random.default_rng(6)
    R = _t(rng.normal(size=(27, 3, 3, 3, 2, 4)))
    assert stencil_asymmetry(R) > 0.1
    S = R + stencil_transpose_soa(R)  # symmetric, its blocks are not
    assert stencil_asymmetry(S) == 0.0
    x = _t(_x(S.shape[-3:]))
    assert _rel(stencil_matvec_sym_soa(S, x), stencil_matvec_soa(S, x)) < 1e-14

    def dense(A):
        n = 3 * 3 * 2 * 4
        eye = torch.eye(n, dtype=A.dtype).reshape(n, 3, 3, 2, 4)
        return torch.stack([stencil_matvec_soa(A, e).reshape(-1) for e in eye], dim=1)

    assert torch.allclose(dense(stencil_transpose_soa(R)), dense(R).T, rtol=0, atol=1e-14)


def test_sym_product_never_reads_lower_blocks(case):
    """Blocks 0..12 poisoned with NaN: the same product, bit for bit."""
    _, A_t, _ = case
    x = _t(_x(A_t.shape[-3:]))
    poisoned = A_t.clone()
    poisoned[:13] = float("nan")
    assert torch.equal(stencil_matvec_sym_soa(poisoned, x), stencil_matvec_sym_soa(A_t, x))
    q = torch.zeros_like(x)
    stencil_matvec_dot_sym(poisoned, x, q, _state(x))
    assert torch.equal(q, stencil_matvec_sym_soa(A_t, x))


def test_sym_product_sees_a_nonsymmetric_operator(case):
    """A lower half that is not the upper half's mirror changes the full
    product and not the half-stencil one, so the comparison above can
    fail."""
    _, A_t, _ = case
    x = _t(_x(A_t.shape[-3:]))
    skew = A_t.clone()
    skew[:13] *= 1.01
    assert _rel(stencil_matvec_soa(skew, x), stencil_matvec_sym_soa(skew, x)) > 1e-4
    assert torch.equal(stencil_matvec_sym_soa(skew, x), stencil_matvec_sym_soa(A_t, x))


def test_dot_sym_plain_sets_pq_and_alpha(case):
    """``stencil_matvec_dot_sym_plain`` against ``stencil_matvec_dot_plain``:
    q, p·q and α within 1e-14; a no-op once the flag is 0."""
    _, A_t, _ = case
    p = _t(_x(A_t.shape[-3:]))
    out = {}
    for name, step in (("full", stencil_matvec_dot_plain), ("sym", stencil_matvec_dot_sym_plain)):
        q, st = torch.zeros_like(p), _state(p)
        step(A_t, p, q, st)
        out[name] = (q, st.sc.clone())
    (qf, scf), (qs, scs) = out["full"], out["sym"]
    assert _rel(qs, qf) < 1e-14
    for i in (cg_state.SC_PQ, cg_state.SC_ALPHA):
        assert abs(float(scs[i] / scf[i]) - 1.0) < 1e-14
    st = _state(p)
    st.st[cg_state.ST_ACTIVE] = 0
    q = torch.full_like(p, 7.0)
    stencil_matvec_dot_sym_plain(A_t, p, q, st)
    assert bool((q == 7.0).all()) and float(st.sc[cg_state.SC_ALPHA]) == 0.0


def test_fused_route_picks_the_form_by_symmetry(case):
    """A ``StencilOperator`` is symmetric unless it says not: the fused
    route applies the half-stencil form, K1's or its plain one; an
    operator marked not symmetric keeps the full p·q form.  The engines
    say which their tangents are."""
    _, A_t, b = case
    M = jacobi_precond_soa(A_t)
    steps = lambda *op: tcg._fused_operands(StencilOperator(A_t, *op), _t(b), M, None)[2][0]
    assert steps() is stencil_matvec_dot_sym
    assert steps(stencil_matvec_soa) is stencil_matvec_dot_sym_plain
    assert steps(stencil_matvec, False) is stencil_matvec_dot
    assert steps(stencil_matvec_soa, False) is stencil_matvec_dot_plain
    assert J2Engine.symmetric_tangent and ElasticEngine.symmetric_tangent
    assert not MicroFEEngine.symmetric_tangent
    full = tcg.cg_solve(StencilOperator(A_t, symmetric=False), _t(b), M)
    half = tcg.cg_solve(StencilOperator(A_t), _t(b), M)
    assert half.its == full.its and half.reason == full.reason
    assert _rel(half.x, full.x) < 1e-12
