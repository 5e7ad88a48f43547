"""Module-by-module parity of the torch port with the JAX package, at
float64 on the CPU, on a cube (point-smoothed MG) and a pancake (ny=3,
line-smoothed semicoarsened MG).  Inputs are made with numpy and fed to
both.  Tolerances are relative to the largest magnitude: 1e-12 for
straight-line arithmetic (sums taken in another order), 1e-10 for
iterative solves and the V-cycle (the same roundoff carried through a few
dozen CG iterations or a dense coarse inverse)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macroc_tpu import bc as jbc
from macroc_tpu.config import MacroConfig, MaterialParams
from macroc_tpu.constitutive.elastic import ElasticEngine as JElastic
from macroc_tpu.constitutive.j2 import J2Engine as JJ2, J2State as JState
from macroc_tpu.fem import element as jel
from macroc_tpu.fem import kernels as jk
from macroc_tpu.grid import make_grid
from macroc_tpu.problem import resolve_solver_plan
from macroc_tpu.ops.stencil_pallas import stencil_matvec_soa as jmv
from macroc_tpu.solve import cg_solve as jcg, jacobi_precond_soa as jjac
from macroc_tpu.solve import mg as jmg
from macroc_tpu_torch import bc as tbc
from macroc_tpu_torch.constitutive import ElasticEngine, J2Engine, J2State
from macroc_tpu_torch.constitutive.elastic import elastic_matrix
from macroc_tpu_torch.fem import element as tel
from macroc_tpu_torch.fem import kernels as tk
from macroc_tpu_torch.ops.stencil_spmv import stencil_matvec
from macroc_tpu_torch.problem import resolve_solver_plan_torch
from macroc_tpu_torch.solve import mg as tmg
from macroc_tpu_torch.solve.cg import cg_solve
from macroc_tpu_torch.solve.precond import (
    block_jacobi_precond_soa,
    jacobi_precond_soa,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")
CASES = {
    "cube": MacroConfig(nx=9, ny=9, nz=9, lx=2.0, ly=2.0, lz=2.0,
                        bc_type=0, dtype="float64"),
    "pancake": MacroConfig(nx=9, ny=3, nz=9, lx=10.0, ly=1.0, lz=10.0,
                           bc_type=1, rad=2.0, dtype="float64"),
}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _t(a):
    return torch.as_tensor(np.array(a))


def _setup(name):
    cfg = CASES[name]
    grid = make_grid(cfg, 1)
    shape = (grid.nx, grid.ny, grid.nz)
    B = jel.b_for(grid.spacing, cfg.ref_b_quirk)
    rng = np.random.default_rng(sum(map(ord, name)))
    # elastic tangent scaled per element: an SPD, heterogeneous operator
    C = elastic_matrix(MaterialParams())
    ne = tuple(n - 1 for n in shape)
    ctan = C * (1.0 + 0.5 * rng.random(ne + (8, 1, 1)))
    return cfg, grid, shape, B, ctan, rng


def _operators(name):
    """(JAX bc, BC-eliminated A_soa from each package, rhs b_soa)."""
    cfg, grid, shape, B, ctan, rng = _setup(name)
    bc_j = jbc.build_bc(grid, cfg, jnp.float64)
    A_j = jbc.apply_bc_stencil_soa(
        jk.assemble_stencil_soa(jnp.asarray(ctan), jnp.asarray(B), grid.wg, shape), bc_j
    )
    bc_t = tbc.build_bc(grid, cfg, torch.float64, CPU)
    A_t = tbc.apply_bc_stencil_soa(
        tk.assemble_stencil_soa(_t(ctan), _t(B), grid.wg, shape), bc_t
    )
    mask = np.moveaxis(np.asarray(bc_j.mask), -1, 0)
    b = np.where(mask, 0.0, rng.normal(size=(3,) + shape))
    return cfg, grid, ctan, bc_j, A_j, A_t, b


def test_element_tables_match():
    for sp in [(1.0, 1.0, 1.0), (0.5, 1.5, 2.0)]:
        assert np.array_equal(tel.b_matrix(sp), jel.b_matrix(sp))
        for quirk in (True, False):
            assert np.array_equal(tel.b_for(sp, quirk), jel.b_for(sp, quirk))
    assert np.array_equal(tel.gauss_points(), jel.gauss_points())
    assert np.array_equal(tk.STENCIL_OFFSETS, jk.STENCIL_OFFSETS)


@pytest.mark.parametrize("name", list(CASES))
def test_strains_and_residual(name):
    cfg, grid, shape, B, ctan, rng = _setup(name)
    u = rng.normal(size=shape + (3,))
    eps_j = jk.compute_strains(jnp.asarray(u), jnp.asarray(B))
    eps_t = tk.compute_strains(_t(u), _t(B))
    assert _rel(eps_t, eps_j) < 1e-12
    stress = rng.normal(size=tuple(n - 1 for n in shape) + (8, 6))
    f_j = jk.assemble_residual(jnp.asarray(stress), jnp.asarray(B), grid.wg, shape)
    f_t = tk.assemble_residual(_t(stress), _t(B), grid.wg, shape)
    assert _rel(f_t, f_j) < 1e-12


@pytest.mark.parametrize("name", list(CASES))
def test_bc_elimination(name):
    cfg, grid, shape, B, ctan, rng = _setup(name)
    bc_j = jbc.build_bc(grid, cfg, jnp.float64)
    bc_t = tbc.build_bc(grid, cfg, torch.float64, CPU)
    assert np.array_equal(bc_t.mask.numpy(), np.asarray(bc_j.mask))
    assert np.array_equal(bc_t.val_unit.numpy(), np.asarray(bc_j.val_unit))
    u = rng.normal(size=shape + (3,))
    assert np.array_equal(
        tbc.apply_bc_on_u(-0.3, _t(u), bc_t).numpy(),
        np.asarray(jbc.apply_bc_on_u(-0.3, jnp.asarray(u), bc_j)),
    )
    assert np.array_equal(
        tbc.apply_bc_on_res(_t(u), bc_t).numpy(),
        np.asarray(jbc.apply_bc_on_res(jnp.asarray(u), bc_j)),
    )
    A = rng.normal(size=(27, 3, 3) + shape)
    assert np.array_equal(
        tbc.apply_bc_stencil_soa(_t(A).clone(), bc_t).numpy(),
        np.asarray(jbc.apply_bc_stencil_soa(jnp.asarray(A), bc_j)),
    )


@pytest.mark.parametrize("name", list(CASES))
def test_constitutive_return_and_tangent(name):
    """Elastic and J2 engines on strains of the case's grid, scaled so
    that some GPs yield and some stay elastic, from a state that already
    carries plastic strain."""
    cfg, grid, shape, B, ctan, rng = _setup(name)
    u = rng.normal(size=shape + (3,))
    eps = np.asarray(jk.compute_strains(jnp.asarray(u), jnp.asarray(B)))
    # per-GP strain magnitudes spread around first yield (~Sy/E = 1e-3)
    eps = eps / np.sqrt(np.mean(eps**2)) * 1e-3 * rng.random(eps.shape[:-1] + (1,))
    ep = rng.normal(size=eps.shape) * 1e-4
    al = np.abs(rng.normal(size=eps.shape[:-1])) * 1e-4
    mat = MaterialParams()
    hj = JJ2(mat, jnp.float64).homogenize(jnp.asarray(eps), JState(jnp.asarray(ep), jnp.asarray(al)))
    ht = J2Engine(mat, torch.float64, CPU).homogenize(_t(eps), J2State(_t(ep), _t(al)))
    plastic = np.asarray(hj.non_linear)
    assert 0.05 < plastic.mean() < 0.95, plastic.mean()
    assert np.array_equal(ht.non_linear.numpy(), plastic)
    for k in ("stress", "ctan", "f_trial", "cost"):
        assert _rel(getattr(ht, k), getattr(hj, k)) < 1e-12, k
    assert _rel(ht.trial_state.eps_p, hj.trial_state.eps_p) < 1e-12
    assert _rel(ht.trial_state.alpha, hj.trial_state.alpha) < 1e-12
    ej = JElastic(mat, jnp.float64).homogenize(jnp.asarray(eps), ())
    et = ElasticEngine(mat, torch.float64, CPU).homogenize(_t(eps), ())
    assert _rel(et.stress, ej.stress) < 1e-12
    assert _rel(et.ctan, ej.ctan) < 1e-12


@pytest.mark.parametrize("name", list(CASES))
def test_cg_jacobi(name):
    cfg, grid, ctan, bc_j, A_j, A_t, b = _operators(name)
    assert _rel(A_t, A_j) < 1e-12
    rj = jcg(lambda v: jmv(A_j, v), jnp.asarray(b), jjac(A_j))
    rt = cg_solve(lambda v: stencil_matvec(A_t, v), _t(b), jacobi_precond_soa(A_t))
    assert rt.its == int(rj.its) and rt.reason == int(rj.reason)
    assert _rel(rt.x, rj.x) < 1e-10
    # block-Jacobi converges to the same solution
    rb = cg_solve(lambda v: stencil_matvec(A_t, v), _t(b),
                  block_jacobi_precond_soa(A_t), rtol=1e-10)
    rr = cg_solve(lambda v: stencil_matvec(A_t, v), _t(b),
                  jacobi_precond_soa(A_t), rtol=1e-10)
    assert _rel(rb.x, rr.x) < 1e-7


@pytest.mark.parametrize("name", list(CASES))
def test_mg_hierarchy_and_vcycle(name):
    cfg, grid, ctan, bc_j, A_j, A_t, b = _operators(name)
    mask_j = jnp.moveaxis(bc_j.mask, -1, 0)
    lv_j = jmg.build_hierarchy(jnp.asarray(ctan), mask_j, grid.spacing,
                               cfg.ref_b_quirk, A0_soa=A_j)
    lv_t = tmg.build_hierarchy(_t(ctan), _t(mask_j), grid.spacing,
                               cfg.ref_b_quirk, A0_soa=A_t)
    assert len(lv_t) == len(lv_j) >= 3
    assert lv_t[0].line_dim == lv_j[0].line_dim == (1 if name == "pancake" else -1)
    for a, c in zip(lv_t, lv_j):
        assert tuple(a.A_soa.shape) == tuple(c.A_soa.shape)
        assert _rel(a.A_soa, c.A_soa) < 1e-12
        assert np.array_equal(a.bc_mask.numpy(), np.asarray(c.bc_mask))
    Mj = jax.jit(jmg.make_mg_preconditioner(lv_j, nu=1, coarse_sweeps=10))
    Mt = tmg.make_mg_preconditioner(lv_t, nu=1, coarse_sweeps=10)
    assert _rel(Mt(_t(b)), Mj(jnp.asarray(b))) < 1e-10
    rj = jcg(lambda v: jmv(A_j, v), jnp.asarray(b), Mj)
    rt = cg_solve(lambda v: stencil_matvec(A_t, v), _t(b), Mt)
    assert rt.its == int(rj.its)
    assert _rel(rt.x, rj.x) < 1e-10


def test_transfer_adjointness():
    """restrict is the exact transpose of prolong (linear and cubic,
    full and semicoarsened), and matches the JAX transfers."""
    rng = np.random.default_rng(0)
    for fine, coarse, order in [((9, 6, 5), (5, 4, 3), 1), ((9, 6, 5), (5, 4, 3), 3),
                                ((17, 3, 9), (9, 3, 5), 3)]:
        u_c = rng.normal(size=(3,) + coarse)
        v_f = rng.normal(size=(3,) + fine)
        P = tmg.prolong(_t(u_c), fine, order)
        R = tmg.restrict(_t(v_f), coarse, order)
        assert np.isclose(float((P * _t(v_f)).sum()), float((_t(u_c) * R).sum()), rtol=1e-12)
        assert _rel(P, jmg.prolong(jnp.asarray(u_c), fine, order)) < 1e-12
        assert _rel(R, jmg.restrict(jnp.asarray(v_f), coarse, order)) < 1e-12


@pytest.mark.parametrize("shape", [(9, 9, 9), (9, 3, 9), (40, 3, 40), (128, 128, 128), (17, 17, 5)])
def test_solver_plan(shape):
    cfg = MacroConfig(nx=shape[0], ny=shape[1], nz=shape[2])
    plan_j = resolve_solver_plan(cfg, shape, (1, 1, 1), "cpu")
    cpu = resolve_solver_plan_torch(cfg, shape, "cpu")
    cuda = resolve_solver_plan_torch(cfg, shape, "cuda")
    assert cpu["pc_type"] == cuda["pc_type"] == plan_j["pc_type"]
    assert (cpu["operator"], cpu["assembly"]) == ("stencil", "slab")
    assert (cuda["operator"], cuda["assembly"]) == ("stencil_cuda", "cuda")
