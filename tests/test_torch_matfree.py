"""The matrix-free operator of the port against the JAX package, at
float64 on the CPU: element_stiffness, assemble_diagonal, matfree_matvec
and bc_operator on numpy-seeded tangents and fields (1e-12 of the largest
magnitude: the same sums in another order), and the matfree Newton run of
tests/test_problem.py, which must match the stencil run (its own bound,
rtol 1e-6 / atol 1e-10) and the JAX matfree run's KSP counts exactly.

The JAX package runs any pc_type other than jacobi/bjacobi unpreconditioned
under matfree, mg included (macroc_tpu/problem.py:545-553; ROADMAP.md
queue 3, R7); the port reproduces it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macroc_tpu import bc as jbc
from macroc_tpu.config import BC_BENDING, MacroConfig, MaterialParams
from macroc_tpu.fem import element as jel
from macroc_tpu.fem import kernels as jk
from macroc_tpu.grid import make_grid
from macroc_tpu.problem import MacroProblem as JaxProblem, resolve_solver_plan
from macroc_tpu_torch import bc as tbc
from macroc_tpu_torch.config import MacroConfig as PortConfig
from macroc_tpu_torch.constitutive.elastic import elastic_matrix
from macroc_tpu_torch.fem import kernels as tk
from macroc_tpu_torch.problem import MacroProblem, resolve_solver_plan_torch

torch.set_num_threads(1)

# tests/test_problem.py's BASE config
BASE = dict(nx=5, ny=3, nz=3, lx=4.0, ly=2.0, lz=2.0, bc_type=BC_BENDING,
            dtype="float64", ts=3, dt=0.001, u_max=-1.0)


def _t(a):
    return torch.as_tensor(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.fixture(scope="module", params=["cube", "pancake"])
def case(request):
    cfg = {
        "cube": MacroConfig(nx=6, ny=5, nz=4, lx=2.0, ly=2.0, lz=2.0,
                            bc_type=0, dtype="float64"),
        "pancake": MacroConfig(nx=9, ny=3, nz=9, lx=10.0, ly=1.0, lz=10.0,
                               bc_type=1, rad=2.0, dtype="float64"),
    }[request.param]
    grid = make_grid(cfg, 1)
    shape = (grid.nx, grid.ny, grid.nz)
    rng = np.random.default_rng(sum(map(ord, request.param)))
    B = jel.b_for(grid.spacing, cfg.ref_b_quirk)
    ne = tuple(n - 1 for n in shape)
    ctan = elastic_matrix(MaterialParams()) * (1.0 + 0.5 * rng.random(ne + (8, 1, 1)))
    x = rng.normal(size=shape + (3,))
    return cfg, grid, shape, B, ctan, x


def test_element_stiffness_and_diagonal(case):
    cfg, grid, shape, B, ctan, x = case
    Ke_j = jk.element_stiffness(jnp.asarray(ctan), jnp.asarray(B), grid.wg)
    Ke_t = tk.element_stiffness(_t(ctan), _t(B), grid.wg)
    assert Ke_t.shape == Ke_j.shape and _rel(Ke_t, Ke_j) < 1e-12
    d_j = jk.assemble_diagonal(jnp.asarray(ctan), jnp.asarray(B), grid.wg, shape)
    d_t = tk.assemble_diagonal(_t(ctan), _t(B), grid.wg, shape)
    assert _rel(d_t, d_j) < 1e-12
    # the diagonal is the assembled stencil's
    A = tk.assemble_stencil_soa(_t(ctan), _t(B), grid.wg, shape)
    assert _rel(d_t, A[tk.DIAG_OFFSET].diagonal(dim1=0, dim2=1)) < 1e-12


def test_matfree_matvec_and_bc_operator(case):
    cfg, grid, shape, B, ctan, x = case
    mv_j = jk.matfree_matvec(jnp.asarray(ctan), jnp.asarray(B), grid.wg, shape)
    mv_t = tk.matfree_matvec(_t(ctan), _t(B), grid.wg, shape)
    assert _rel(mv_t(_t(x)), mv_j(jnp.asarray(x))) < 1e-12
    bc_j = jbc.build_bc(grid, cfg, jnp.float64)
    bc_t = tbc.build_bc(grid, cfg, torch.float64, "cpu")
    y_j = jbc.bc_operator(mv_j, bc_j)(jnp.asarray(x))
    y_t = tbc.bc_operator(mv_t, bc_t)(_t(x))
    assert _rel(y_t, y_j) < 1e-12
    # constrained dofs pass through; the rest is the eliminated stencil's
    mask = bc_t.mask.numpy()
    assert np.array_equal(y_t.numpy()[mask], x[mask])
    A = tbc.apply_bc_stencil_soa(tk.assemble_stencil_soa(_t(ctan), _t(B), grid.wg, shape), bc_t)
    from macroc_tpu_torch.ops.stencil_spmv import stencil_matvec_soa, x_from_soa, x_to_soa

    y_s = x_from_soa(stencil_matvec_soa(A, x_to_soa(_t(x))))
    assert _rel(y_t, y_s) < 1e-12


def _run_port(cfg, steps):
    p = MacroProblem(cfg, "cpu")
    u, state = p.init_fields()
    diags = []
    for ts in range(steps):
        u, state, d = p.time_step(u, state, cfg.displacement(ts))
        diags.append(d)
    return u.numpy(), diags


def _run_jax(cfg, steps):
    p = JaxProblem(cfg, n_devices=1)
    u, state = p.init_fields()
    diags = []
    for ts in range(steps):
        u, state, d = p.time_step_jit(u, state, jnp.asarray(cfg.displacement(ts), p.dtype))
        diags.append(d)
    return np.asarray(u), diags


def _ksp_its(d):
    n = int(d.n_solves)
    return [int(v) for v in np.asarray(d.ksp_its)[:n]]


@pytest.mark.parametrize("pc_type", ["auto", "jacobi", "bjacobi", "none"])
def test_matfree_run_matches_stencil_and_jax(pc_type):
    """Matfree against the stencil operator under the same point
    preconditioner (bjacobi is point Jacobi under matfree, as in JAX), and
    against the JAX matfree run.  pc_type none also holds the port's
    stencil CG to the JAX counts: an in-place residual update once let the
    identity preconditioner's aliasing change them (ROADMAP.md queue 3)."""
    cfg = MacroConfig(**BASE, operator="matfree", pc_type=pc_type)
    u_t, d_t = _run_port(cfg, 2)
    stencil = MacroConfig(**BASE, pc_type="jacobi" if pc_type == "bjacobi" else pc_type)
    u_s, d_s = _run_port(stencil, 2)
    assert np.allclose(u_t, u_s, rtol=1e-6, atol=1e-10)
    u_j, d_j = _run_jax(cfg, 2)
    assert [_ksp_its(d) for d in d_t] == [_ksp_its(d) for d in d_j]
    assert _rel(u_t, u_j) < 1e-10
    _, d_sj = _run_jax(stencil, 2)
    assert [_ksp_its(d) for d in d_s] == [_ksp_its(d) for d in d_sj]


def test_matfree_mg_is_the_identity():
    """-operator matfree -pc_type mg: the port, like the JAX package, runs
    it unpreconditioned: the same KSP counts as pc_type none and as the JAX
    run, and the same iterates as pc_type none."""
    cfg = MacroConfig(**BASE, operator="matfree", pc_type="mg")
    u_mg, d_mg = _run_port(cfg, 2)
    u_none, d_none = _run_port(PortConfig(**BASE, operator="matfree", pc_type="none"), 2)
    _, d_j = _run_jax(cfg, 2)
    its = [_ksp_its(d) for d in d_mg]
    assert its == [_ksp_its(d) for d in d_none] == [_ksp_its(d) for d in d_j]
    assert np.array_equal(u_mg, u_none)


@pytest.mark.parametrize("shape", [(5, 3, 3), (17, 17, 17), (50, 3, 50)])
def test_matfree_plan_picks_jacobi(shape):
    cfg = MacroConfig(nx=shape[0], ny=shape[1], nz=shape[2], operator="matfree")
    plan_j = resolve_solver_plan(cfg, shape, (1, 1, 1), "cpu")
    for dev in ("cpu", "cuda"):
        plan = resolve_solver_plan_torch(cfg, shape, dev)
        assert plan["operator"] == "matfree"
        assert plan["pc_type"] == plan_j["pc_type"] == "jacobi"
