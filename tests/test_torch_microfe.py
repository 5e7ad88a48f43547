"""The micro-FE (FE²) engine of the torch port against the JAX package.

Every comparison runs both packages at float64 on the CPU, on inputs made
with numpy, at micro_n 2-4.  Tolerances, relative to the largest magnitude
of the JAX value:
  - 1e-12 for single passes (radial return, assembly, matvec, elimination,
    Jacobi) — the same sums in another order;
  - 1e-10 for CG solutions and everything downstream of a micro solve,
    whose iterates carry the roundoff of another summation order
    (iteration counts, reasons, yield flags and costs must be equal);
  - the closed-form oracles of tests/test_microfe.py keep that file's
    tolerances.
The JAX engine runs under ``jax.jit`` (its ``homogenize`` is pure), so each
engine configuration compiles once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macroc_tpu.config import MIC_HOMOGENEOUS, MIC_LAYER_Y, MIC_SPHERE, MaterialParams
from macroc_tpu.bc import BCData as JaxBC
from macroc_tpu.bc import apply_bc_stencil_flat as jax_bc_flat
from macroc_tpu.constitutive.elastic import elastic_matrix
from macroc_tpu.constitutive.j2 import j2_radial_return as jax_j2
from macroc_tpu.constitutive.microfe import MicroFEEngine as JaxMicroFE
from macroc_tpu.fem.element import b_matrix
from macroc_tpu.fem.kernels import assemble_stencil_flat as jax_assemble_flat
from macroc_tpu.ops.stencil import stencil_matvec_flat as jax_matvec_flat
from macroc_tpu.solve.cg import cg_solve as jax_cg
from macroc_tpu.solve.precond import jacobi_precond_flat as jax_jacobi_flat
from macroc_tpu_torch.bc import BCData, apply_bc_stencil_flat
from macroc_tpu_torch.constitutive import J2Engine
from macroc_tpu_torch.ops.j2_return import j2_radial_return
from macroc_tpu_torch.constitutive.microfe import MicroFEEngine, MicroState
from macroc_tpu_torch.fem.kernels import assemble_stencil_flat
from macroc_tpu_torch.ops.stencil import stencil_matvec_flat
from macroc_tpu_torch.solve.cg import cg_solve_batched
from macroc_tpu_torch.solve.precond import jacobi_precond_flat

torch.set_num_threads(1)

MAT = MaterialParams()
SOFT = MaterialParams(E=1e6, nu=0.3, Sy=1e4, Ka=1e7)
T64 = torch.float64


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300))


def _fields(rng, n):
    """Heterogeneous per-element material fields (n,n,n,1), as numpy."""
    lam = rng.uniform(0.5e6, 2e6, size=(n, n, n, 1))
    mu = rng.uniform(0.3e6, 1e6, size=(n, n, n, 1))
    Sy = rng.uniform(1e3, 5e3, size=(n, n, n, 1))
    Ka = rng.uniform(1e5, 1e7, size=(n, n, n, 1))
    return lam, mu, Sy, Ka


# --------------------------------------------------------------------- #
def test_j2_radial_return_heterogeneous_fields():
    rng = np.random.default_rng(0)
    n = 3
    eps = rng.normal(size=(4, n, n, n, 8, 6)) * 5e-3
    eps_p = rng.normal(size=eps.shape) * 1e-4
    alpha = rng.uniform(0, 1e-3, size=eps.shape[:-1])
    fields = _fields(rng, n)
    want = jax_j2(*(jnp.asarray(a) for a in (eps, eps_p, alpha) + fields))
    got = j2_radial_return(*(_t(a) for a in (eps, eps_p, alpha) + fields))
    plastic = np.asarray(want[5])
    assert 0 < plastic.sum() < plastic.size  # both branches exercised
    np.testing.assert_array_equal(got[5].numpy(), plastic)
    for k, name in enumerate(("stress", "ctan", "eps_p", "alpha", "f_trial")):
        assert _rel(got[k], want[k]) < 1e-12, name


def test_j2_engine_is_the_shared_return_map():
    """J2Engine runs j2_radial_return with its elastic matrix: equal to the
    field route at scalar materials within roundoff."""
    rng = np.random.default_rng(1)
    eps = _t(rng.normal(size=(5, 8, 6)) * rng.uniform(0, 2e-3, size=(5, 8, 1)))
    eng = J2Engine(MAT, dtype=T64, device="cpu")
    r = eng.homogenize(eps, eng.init_state((5, 8)))
    f = j2_radial_return(eps, torch.zeros_like(eps), torch.zeros(5, 8, dtype=T64),
                         MAT.lam, MAT.mu, MAT.Sy, MAT.Ka)
    assert r.non_linear.any() and not r.non_linear.all()
    assert _rel(r.stress, f[0]) < 1e-12 and _rel(r.ctan, f[1]) < 1e-12


# --------------------------------------------------------------------- #
def _micro_operator(rng, g, n):
    B = b_matrix((1.0 / n,) * 3)
    ctan = rng.normal(size=(g, n, n, n, 8, 6, 6))
    ctan = ctan + np.swapaxes(ctan, -1, -2)  # symmetric per-GP tangents
    return B, ctan, (1.0 / n) ** 3 / 8.0, (n + 1,) * 3


def _boundary_mask(n):
    m = n + 1
    bnd = np.zeros((m, m, m, 3), bool)
    bnd[0] = bnd[-1] = bnd[:, 0] = bnd[:, -1] = bnd[:, :, 0] = bnd[:, :, -1] = True
    return bnd


def test_flat_assembly_matvec_bc_jacobi_match_jax():
    """assemble_stencil_flat, stencil_matvec_flat, apply_bc_stencil_flat and
    jacobi_precond_flat on a batch of 3 RVEs against the JAX functions on
    each member."""
    rng = np.random.default_rng(2)
    g, n = 3, 3
    B, ctan, wg, mshape = _micro_operator(rng, g, n)
    x = rng.normal(size=(g,) + mshape + (3,))
    bnd = _boundary_mask(n)
    Af = assemble_stencil_flat(_t(ctan), _t(B), wg, mshape)
    y = stencil_matvec_flat(Af, _t(x))
    bc = BCData(mask=_t(bnd), val_unit=torch.zeros(mshape + (3,), dtype=T64))
    Ae = apply_bc_stencil_flat(Af.clone(), bc)
    ye = stencil_matvec_flat(Ae, _t(x))
    z = jacobi_precond_flat(Ae)(_t(x))
    jbc = JaxBC(mask=jnp.asarray(bnd), val_unit=jnp.zeros(mshape + (3,)))
    for k in range(g):
        A_j = jax_assemble_flat(jnp.asarray(ctan[k]), jnp.asarray(B), wg, mshape)
        assert _rel(Af[k], A_j) < 1e-12
        assert _rel(y[k], jax_matvec_flat(A_j, jnp.asarray(x[k]))) < 1e-12
        Ae_j = jax_bc_flat(A_j, jbc)
        assert _rel(Ae[k], Ae_j) < 1e-12
        assert _rel(ye[k], jax_matvec_flat(Ae_j, jnp.asarray(x[k]))) < 1e-12
        assert _rel(z[k], jax_jacobi_flat(Ae_j)(jnp.asarray(x[k]))) < 1e-12
    # a shared operator broadcasts over a batch of vectors
    assert _rel(stencil_matvec_flat(Af[1], _t(x)),
                np.stack([jax_matvec_flat(jax_assemble_flat(
                    jnp.asarray(ctan[1]), jnp.asarray(B), wg, mshape),
                    jnp.asarray(xk)) for xk in x])) < 1e-12


def test_batched_cg_matches_vmapped_jax_cg():
    """Members of different conditioning converge at different counts, one
    has b = 0 (converged at iteration 0: its 0/0 step must not reach x),
    one stops at maxits.  Counts and reasons equal, x to 1e-10."""
    rng = np.random.default_rng(3)
    g, F = 5, 40
    As = []
    # k distinct eigenvalues: CG stops after about k iterations
    for k, cond in ((4, 10.0), (8, 1e3), (12, 1e4), (2, 1e2), (F, 30.0)):
        Q, _ = np.linalg.qr(rng.normal(size=(F, F)))
        lam = np.geomspace(1.0, cond, k)[rng.integers(0, k, F)]
        lam[:k] = np.geomspace(1.0, cond, k)
        As.append(Q @ np.diag(lam) @ Q.T)
    As = np.stack(As)
    b = rng.normal(size=(g, F))
    b[3] = 0.0
    kw = dict(rtol=1e-10, maxits=20)

    def solve(A, rhs):
        return jax_cg(lambda v: A @ v, rhs, lambda r: 0.5 * r, **kw)

    want = jax.vmap(solve)(jnp.asarray(As), jnp.asarray(b))
    At = _t(As)
    got = cg_solve_batched(lambda v: torch.bmm(At, v[:, :, None])[:, :, 0], _t(b),
                           lambda r: 0.5 * r, **kw)
    its = np.asarray(want.its)
    assert len(set(its.tolist())) >= 4  # members stop at different counts
    np.testing.assert_array_equal(got.its.numpy(), its)
    np.testing.assert_array_equal(got.reason.numpy(), np.asarray(want.reason))
    assert set(np.asarray(want.reason).tolist()) >= {2, 3, -3}
    assert torch.isfinite(got.x).all() and not got.x[3].any()
    assert _rel(got.x, want.x) < 1e-10
    assert _rel(got.rnorm, want.rnorm) < 1e-6


# --------------------------------------------------------------------- #
def _engines(**kw):
    args = dict(n=2, micro_type=MIC_LAYER_Y, mat1=MAT, mat2=SOFT, newton_its=6,
                cg_rtol=1e-12)
    args.update(kw)
    return (JaxMicroFE(dtype=jnp.float64, **args),
            MicroFEEngine(dtype=T64, device="cpu", **args))


def _to_torch_state(s):
    return MicroState(eps_p=_t(s.eps_p), alpha=_t(s.alpha), u=_t(s.u))


def _compare(rt, rj, tol=1e-10):
    for name in ("non_linear", "cost", "unconverged"):
        np.testing.assert_array_equal(getattr(rt, name).numpy(),
                                      np.asarray(getattr(rj, name)), err_msg=name)
    for name in ("stress", "ctan", "f_trial"):
        assert _rel(getattr(rt, name), getattr(rj, name)) < tol, name
    for name in ("eps_p", "alpha", "u"):
        want = np.asarray(getattr(rj.trial_state, name))
        got = getattr(rt.trial_state, name)
        assert got.shape == want.shape, name
        assert _rel(got, want) < tol if np.abs(want).max() > 0 else not got.any(), name


@pytest.mark.parametrize("precond", ["dense_elastic", "jacobi"])
@pytest.mark.parametrize("fastpath", [True, False])
def test_homogenize_matches_jax(fastpath, precond):
    """A pristine batch, a batch with 2 of 20 GPs driven past yield, then
    that committed plastic state unloaded by 5%: every output equal to the
    JAX engine's."""
    je, te = _engines(elastic_fastpath=fastpath, precond=precond, active_chunk=4)
    hom = jax.jit(je.homogenize)
    g = 20
    rng = np.random.default_rng(11)
    small = rng.normal(size=(g, 6)) * 1e-5
    big = small.copy()
    big[[2, 13]] *= 600.0
    sj, st = je.init_state((g,)), te.init_state((g,))

    for eps in (small, big):
        rj = hom(jnp.asarray(eps), sj)
        rt = te.homogenize(_t(eps), st)
        _compare(rt, rj)
    nl = np.asarray(rj.non_linear)
    assert 0 < nl.sum() <= 4
    if fastpath:  # full solves ran on one active_chunk wave only
        assert (rt.cost.numpy() > 0).sum() <= 4
    # commit the plastic step, then unload 5%: elastic everywhere
    sj, st = rj.trial_state, rt.trial_state
    assert st.eps_p.abs().max() > 0
    rj = hom(jnp.asarray(big * 0.95), sj)
    rt = te.homogenize(_t(big * 0.95), st)
    _compare(rt, rj)
    if fastpath:
        assert not rt.cost.any() and not rt.non_linear.any()


def test_chunked_ragged_population_matches_jax_and_unchunked():
    """gp_chunk=3 over 7 GPs: two chunks and a ragged one-GP tail, with a
    driven GP among them; against the JAX engine of the same partition and
    the port's unchunked engine."""
    je, te = _engines(gp_chunk=3, active_chunk=2)
    _, te_all = _engines(active_chunk=2)
    rng = np.random.default_rng(8)
    eps = rng.normal(size=(7, 6)) * 1e-5
    eps[5] *= 800.0
    s = te.init_state((7,))
    rt = te.homogenize(_t(eps), s)
    _compare(rt, jax.jit(je.homogenize)(jnp.asarray(eps), je.init_state((7,))))
    assert rt.non_linear[5] and rt.non_linear.sum() == 1
    _compare(rt, te_all.homogenize(_t(eps), s), tol=1e-12)


def test_state_shapes_and_gp_batch_dims():
    _, te = _engines(n=3)
    s = te.init_state((2, 4))
    assert s.eps_p.shape == (2, 4, 27 * 8 * 6) and s.alpha.shape == (2, 4, 27 * 8)
    assert s.u.shape == (2, 4, 64 * 3)
    r = te.homogenize(torch.zeros(2, 4, 6, dtype=T64), s)
    assert r.stress.shape == (2, 4, 6) and r.ctan.shape == (2, 4, 6, 6)
    assert not r.stress.any() and r.trial_state.u.shape == s.u.shape


# ---- tests/test_microfe.py's oracles on the port --------------------- #
def _port(**kw):
    args = dict(n=2, micro_type=MIC_HOMOGENEOUS, mat1=MAT, mat2=MAT, dtype=T64,
                device="cpu", newton_its=2, cg_rtol=1e-12)
    args.update(kw)
    return MicroFEEngine(**args)


@pytest.mark.parametrize("fastpath", [True, False])
def test_homogeneous_elastic_matches_closed_form(fastpath):
    eng = _port(elastic_fastpath=fastpath)
    eps = torch.tensor([1e-4, -2e-5, 3e-5, 4e-5, -1e-5, 2e-5], dtype=T64)
    r = eng.homogenize(eps, eng.init_state(()))
    C = elastic_matrix(MAT)
    assert np.allclose(r.stress.numpy(), C @ eps.numpy(), rtol=1e-8)
    assert np.allclose(r.ctan.numpy(), C, rtol=1e-4, atol=1e-4 * C.max())
    assert not bool(r.non_linear)


def test_homogeneous_plastic_matches_j2():
    eng = _port(newton_its=4)
    j2 = J2Engine(MAT, dtype=T64, device="cpu")
    eps = torch.tensor([3e-3, 0, 0, 1e-3, 0, 0], dtype=T64)
    rm = eng.homogenize(eps, eng.init_state(()))
    rj = j2.homogenize(eps, j2.init_state(()))
    assert bool(rm.non_linear) and bool(rj.non_linear)
    assert np.allclose(rm.stress.numpy(), rj.stress.numpy(), rtol=1e-5)
    assert np.allclose(rm.ctan.numpy(), rj.ctan.numpy(), rtol=5e-3,
                       atol=1e-3 * float(rj.ctan.abs().max()))
    assert np.allclose(rm.trial_state.alpha.numpy(), float(rj.trial_state.alpha),
                       rtol=1e-5)


def test_update_vars_semantics():
    """homogenize must not mutate state; commit advances it."""
    eng = _port(newton_its=3)
    eps = torch.tensor([3e-3, 0, 0, 0, 0, 0], dtype=T64)
    s0 = eng.init_state(())
    r1 = eng.homogenize(eps, s0)
    r2 = eng.homogenize(eps, s0)
    assert torch.equal(r1.stress, r2.stress) and not s0.eps_p.any()
    s1 = r1.trial_state
    assert float(s1.eps_p.abs().max()) > 0
    r3 = eng.homogenize(eps, s1)
    assert float(r3.f_trial) <= 1e-6 * MAT.Sy


def test_two_phase_bounds():
    eng = _port(n=4, micro_type=MIC_LAYER_Y, mat2=SOFT)
    eps = torch.zeros(6, dtype=T64)
    eps[1] = 1e-5  # loading across layers
    r = eng.homogenize(eps, eng.init_state(()))
    C1, C2 = elastic_matrix(MAT), elastic_matrix(SOFT)
    c_hom = float(r.stress[1] / 1e-5)
    voigt = 0.5 * (C1[1, 1] + C2[1, 1])
    reuss = 1.0 / (0.5 / C1[1, 1] + 0.5 / C2[1, 1])
    assert reuss * 0.8 <= c_hom <= voigt * 1.02
    assert C2[1, 1] < c_hom < C1[1, 1]


def test_newton_cap_sets_unconverged():
    """One micro Newton solve for a strain far past yield cannot reach the
    1e-6 tolerance: the RVE is flagged, as the JAX engine flags it."""
    je, te = _engines(n=3, micro_type=MIC_SPHERE, newton_its=1,
                      elastic_fastpath=False)
    eps = np.array([[2e-2, 0, 0, 5e-3, 0, 0], [1e-6, 0, 0, 0, 0, 0]])
    rt = te.homogenize(_t(eps), te.init_state((2,)))
    rj = jax.jit(je.homogenize)(jnp.asarray(eps), je.init_state((2,)))
    np.testing.assert_array_equal(rt.unconverged.numpy(), [True, False])
    _compare(rt, rj)
