"""The port's restarted GMRES against the JAX package's, at float64 on the
CPU, on the three systems of tests/test_solvers.py (the BC-eliminated
elastic stencil with Jacobi, a nonsymmetric dense system, an
ill-conditioned non-normal one), on a restart that takes several cycles,
on maxits reached inside a cycle and with a clamped -ksp_monitor trace.

Held: the iteration count, the reason and the nan pattern of the trace
exactly; the trace entries and the final residual estimate to 1e-12 of the
initial preconditioned norm (the Hessenberg arithmetic is the same, its
sums are taken in another order); x to 1e-10 of its largest entry, except
on the ill-conditioned system (cond ~2e14), where x is determined only to
cond(A) times the residual and the difference is held through A instead.

The JAX solver runs every Arnoldi step of a cycle and masks those after
convergence; the port leaves the cycle at the step that set a reason.
``test_leaving_the_cycle_changes_nothing`` shows the two agree on a solve
that converges inside a cycle, with fewer operator applications."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macroc_tpu import bc as jbc
from macroc_tpu.config import BC_BENDING, MacroConfig, MaterialParams
from macroc_tpu.constitutive.elastic import elastic_matrix
from macroc_tpu.fem.element import b_matrix
from macroc_tpu.fem.kernels import assemble_stencil
from macroc_tpu.grid import make_grid
from macroc_tpu.ops.stencil import stencil_matvec as jmv27
from macroc_tpu.problem import MacroProblem as JaxProblem
from macroc_tpu.solve import gmres_solve as jgmres, jacobi_precond
from macroc_tpu.solve.cg import KSP_DIVERGED_ITS
from macroc_tpu_torch.ops.stencil_spmv import stencil_matvec_soa
from macroc_tpu_torch.problem import MacroProblem
from macroc_tpu_torch.solve.gmres import gmres_solve
from macroc_tpu_torch.solve.precond import jacobi_precond_soa

torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.array(a))


def _stencil_system():
    """test_solvers.py's system: the 4x3x3 bending elastic stencil, BCs
    eliminated, a random rhs zero at Dirichlet dofs.  Returns the JAX
    (matvec, b, precond) in node layout and the port's in SoA layout."""
    cfg = MacroConfig(nx=4, ny=3, nz=3, lx=3.0, ly=2.0, lz=2.0,
                      bc_type=BC_BENDING, dtype="float64", ref_b_quirk=False)
    grid = make_grid(cfg, 1)
    B = jnp.asarray(b_matrix(grid.spacing))
    shape = (grid.nx, grid.ny, grid.nz)
    ctan = jnp.broadcast_to(jnp.asarray(elastic_matrix(MaterialParams())),
                            tuple(n - 1 for n in shape) + (8, 6, 6))
    bc = jbc.build_bc(grid, cfg, dtype=jnp.float64)
    A27 = jbc.apply_bc_stencil(assemble_stencil(ctan, B, grid.wg, shape), bc)
    b = np.random.default_rng(7).normal(size=shape + (3,))
    b = np.where(np.asarray(bc.mask), 0.0, b)
    A_soa = _t(np.transpose(np.asarray(A27), (3, 4, 5, 0, 1, 2)))
    jax_side = (lambda x: jmv27(A27, x), jnp.asarray(b), jacobi_precond(A27))
    port_side = (lambda x: stencil_matvec_soa(A_soa, x),
                 _t(np.moveaxis(b, -1, 0)), jacobi_precond_soa(A_soa))
    return jax_side, port_side


def _dense_systems():
    rng = np.random.default_rng(3)
    n = 40
    A1 = np.eye(n) * 4.0 + rng.normal(size=(n, n)) * 0.3
    b1 = rng.normal(size=(n,))
    rng = np.random.default_rng(11)
    n = 120
    d = np.logspace(0, 8, n)
    A2 = np.diag(d) + np.triu(rng.normal(size=(n, n)), k=1) * 10.0
    b2 = A2 @ rng.normal(size=n)
    return {"nonsymmetric": (A1, b1, None), "ill_conditioned": (A2, b2, 1.0 / d)}


def _dense_sides(name):
    A, b, dinv = _dense_systems()[name]
    Aj, At = jnp.asarray(A), _t(A)
    jax_side = (lambda v: Aj @ v, jnp.asarray(b),
                None if dinv is None else (lambda r: jnp.asarray(dinv) * r))
    port_side = (lambda v: At @ v, _t(b),
                 None if dinv is None else (lambda r: _t(dinv) * r))
    return jax_side, port_side


# (system, solver options): test_solvers.py's three calls, then restart=5
# on the stencil system (several cycles), maxits reached inside the second
# cycle, and a trace shorter than the iteration count (clamped index)
CASES = {
    "stencil_jacobi": ("stencil", dict(rtol=1e-12, restart=30)),
    "nonsymmetric": ("nonsymmetric", dict(rtol=1e-12, restart=15)),
    "ill_conditioned": ("ill_conditioned", dict(rtol=1e-12, maxits=2000, restart=60)),
    "restart_5": ("stencil", dict(rtol=1e-10, restart=5, record_trace=400)),
    "maxits_mid_cycle": ("nonsymmetric", dict(rtol=1e-12, restart=5, maxits=7,
                                              record_trace=8)),
    "trace_clamped": ("stencil", dict(rtol=1e-12, restart=30, record_trace=6)),
}


def _sides(system):
    return _stencil_system() if system == "stencil" else _dense_sides(system)


@pytest.mark.parametrize("case", list(CASES))
def test_gmres_matches_jax(case):
    system, opts = CASES[case]
    (mj, bj, pj), (mt, bt, pt) = _sides(system)
    rj = jgmres(mj, bj, pj, **opts)
    rt = gmres_solve(mt, bt, pt, **opts)
    assert rt.its == int(rj.its) and rt.reason == int(rj.reason)
    x_j = np.asarray(rj.x)
    x_t = rt.x.numpy()
    if system == "stencil":
        x_t = np.moveaxis(x_t, 0, -1)
    if system == "ill_conditioned":
        # cond(A) ~ 2e14: x is determined only to cond(A) times the
        # residual (the two x differ by 7e-3 of |x|); held by the operator
        # instead, |A (x_t - x_j)| <= 1e-10 |b| (measured 9e-13)
        A, b, _ = _dense_systems()[system]
        assert np.linalg.norm(A @ (x_t - x_j)) <= 1e-10 * np.linalg.norm(b)
    else:
        assert np.max(np.abs(x_t - x_j)) <= 1e-10 * np.max(np.abs(x_j))
    scale = float(np.linalg.norm(np.asarray(pj(bj) if pj else bj)))
    assert abs(rt.rnorm - float(rj.rnorm)) <= 1e-12 * scale
    if "record_trace" in opts:
        tj = np.asarray(rj.trace)
        tt = np.asarray(rt.trace)
        assert tt.shape == tj.shape and np.array_equal(np.isnan(tt), np.isnan(tj))
        ok = ~np.isnan(tj)
        assert np.max(np.abs(tt[ok] - tj[ok])) <= 1e-12 * scale
    if case == "restart_5":
        assert rt.its > 3 * 5 and rt.reason > 0
    if case == "maxits_mid_cycle":
        assert rt.its == 7 and rt.reason == KSP_DIVERGED_ITS
    if case == "trace_clamped":
        assert rt.its > 6 and rt.trace[-1] == rt.rnorm


def test_leaving_the_cycle_changes_nothing():
    """A solve converging inside its first cycle: the port stops there, the
    JAX solver runs the cycle's remaining masked steps; x, its, rnorm and
    reason agree, and the port applied the operator its + 1 times (the
    cycle's true residual, then one per step) against the JAX
    solver's restart + 1."""
    (mj, bj, pj), (mt, bt, pt) = _stencil_system()
    calls = [0]

    def counted(x):
        calls[0] += 1
        return mt(x)

    opts = dict(rtol=1e-6, restart=200)
    rj = jgmres(mj, bj, pj, **opts)
    rt = gmres_solve(counted, bt, pt, **opts)
    assert 0 < rt.its < opts["restart"] and rt.reason > 0
    assert rt.its == int(rj.its) and rt.reason == int(rj.reason)
    assert calls[0] == rt.its + 1
    x_j = np.asarray(rj.x)
    assert np.max(np.abs(np.moveaxis(rt.x.numpy(), 0, -1) - x_j)) <= 1e-10 * np.max(np.abs(x_j))


def test_zero_rhs_converges_at_once():
    (_, _, _), (mt, bt, pt) = _stencil_system()
    r = gmres_solve(mt, torch.zeros_like(bt), pt)
    assert r.its == 0 and r.reason > 0 and float(r.x.abs().max()) == 0.0


def test_mg_gmres_through_problem_matches_jax():
    """test_mg.py's MG-preconditioned GMRES through MacroProblem: the
    17x3x17 pancake (semicoarsened, line-smoothed V-cycle), one Newton
    step at the second load increment; KSP counts equal the JAX run's."""
    cfg = MacroConfig(nx=17, ny=3, nz=17, lx=10.0, ly=1.0, lz=10.0, rad=2.0,
                      dtype="float64", pc_type="mg", ksp_type="gmres")
    U = cfg.displacement(1)
    pj = JaxProblem(cfg, n_devices=1)
    uj, _, dj = pj.time_step_jit(*pj.init_fields(), jnp.asarray(U, pj.dtype))
    pt = MacroProblem(cfg, "cpu")
    ut, _, dt = pt.time_step(*pt.init_fields(), U)
    assert dt.converged and bool(dj.converged) and dt.n_solves == int(dj.n_solves)
    np.testing.assert_array_equal(dt.ksp_its[:dt.n_solves],
                                  np.asarray(dj.ksp_its)[:dt.n_solves])
    assert np.array_equal(dt.ksp_reasons[:dt.n_solves],
                          np.asarray(dj.ksp_reasons)[:dt.n_solves])
    u_j = np.asarray(uj)
    assert np.max(np.abs(ut.numpy() - u_j)) <= 1e-8 * np.max(np.abs(u_j))
