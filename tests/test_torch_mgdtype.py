"""V-cycle level operators stored narrower than the vectors (-mg_dtype
bfloat16), on the CPU against the JAX package.

  - The port's plain SpMV with a bf16 operator and f32 (f64) vectors
    against the JAX Pallas kernel in interpret mode on the same operands
    (as tests/test_pallas.py runs it): both widen each bf16 coefficient
    exactly and sum in the vector dtype, in another order, so they agree
    to 1e-5 (1e-12) of the largest entry.
  - One V-cycle on the same bf16 levels (the JAX hierarchy, cast as
    macroc_tpu/problem.py:472-486 casts it, handed to both): at f64 vectors
    1e-12 with smoother sweeps on the coarsest level, and 1e-7 with its
    dense inverse, which both packages take in f32 by different LAPACK
    routes before rounding it to bf16, so an entry can land one bf16 ulp
    apart (measured 1e-8 on the pancake); at f32 vectors 1e-5.
  - A -mg_dtype bfloat16 float32 J2 MG Newton step on a 17^3 cube against
    the JAX CPU run: equal KSP counts and yielded GPs, the first |RES| to
    1e-6 and the rest to 1e-3 (f32 PCG on a plastic tangent carries
    roundoff of another summation order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macroc_tpu.config import MacroConfig
from macroc_tpu.ops.stencil_pallas import stencil_matvec_pallas
from macroc_tpu.problem import MacroProblem as JaxProblem
from macroc_tpu.solve import mg as jmg
from macroc_tpu_torch import problem as tproblem
from macroc_tpu_torch.ops.stencil_spmv import stencil_matvec, stencil_matvec_soa
from macroc_tpu_torch.config import MacroConfig as PortConfig
from macroc_tpu_torch.problem import MacroProblem
from macroc_tpu_torch.solve import mg as tmg
from test_torch_modules import _operators, _rel

torch.set_num_threads(1)

VEC = {"float32": (torch.float32, jnp.float32, 1e-5),
       "float64": (torch.float64, jnp.float64, 1e-12)}


@pytest.mark.parametrize("vec", list(VEC))
@pytest.mark.parametrize("halo", [False, True])
@pytest.mark.parametrize("shape", [(6, 6, 6), (5, 9, 4)])
def test_plain_spmv_bf16_operator_matches_pallas(shape, halo, vec):
    tdt, jdt, tol = VEC[vec]
    rng = np.random.default_rng(sum(shape) + 2 * halo)
    A32 = rng.normal(size=(27, 3, 3) + shape).astype(np.float32)
    xs = tuple(n + 2 for n in shape) if halo else shape
    x = rng.normal(size=(3,) + xs)
    A_j = jnp.asarray(A32).astype(jnp.bfloat16)
    y_j = stencil_matvec_pallas(A_j, jnp.asarray(x, jdt), tile=(4, 8, 128),
                                interpret=True, halo=halo)
    A_t = torch.as_tensor(A32).to(torch.bfloat16)
    assert np.array_equal(A_t.float().numpy(), np.asarray(A_j.astype(jnp.float32)))
    x_t = torch.as_tensor(x, dtype=tdt)
    y_t = stencil_matvec_soa(A_t, x_t, halo=halo)
    assert y_t.dtype == tdt and y_j.dtype == jdt
    assert _rel(y_t, y_j) < tol
    # on a CPU tensor the K1 wrapper is the plain version
    assert torch.equal(stencil_matvec(A_t, x_t, halo=halo), y_t)


def _bf16_levels(name):
    """The case's JAX hierarchy at f64, level operators cast to bf16, and
    the same levels as port MGLevels."""
    cfg, grid, ctan, bc_j, A_j, A_t, b = _operators(name)
    mask_j = jnp.moveaxis(bc_j.mask, -1, 0)
    lv_j = jmg.build_hierarchy(jnp.asarray(ctan), mask_j, grid.spacing,
                               cfg.ref_b_quirk, A0_soa=A_j)
    lv_j = [dataclasses.replace(lv, A_soa=lv.A_soa.astype(jnp.bfloat16),
                                inv_diag=lv.inv_diag.astype(jnp.bfloat16))
            for lv in lv_j]

    def bf16(a):  # bf16 -> f32 is exact, f32 -> bf16 keeps the value
        return torch.as_tensor(np.array(a.astype(jnp.float32))).to(torch.bfloat16)

    lv_t = [tmg.MGLevel(A_soa=bf16(lv.A_soa), inv_diag=bf16(lv.inv_diag),
                        bc_mask=torch.as_tensor(np.array(lv.bc_mask)),
                        line_inv=None if lv.line_inv is None
                        else torch.as_tensor(np.array(lv.line_inv)),
                        line_dim=lv.line_dim)
            for lv in lv_j]
    return lv_j, lv_t, b


@pytest.mark.parametrize("vec", list(VEC))
@pytest.mark.parametrize("coarse_direct", [True, False])
@pytest.mark.parametrize("name", ["cube", "pancake"])
def test_vcycle_bf16_levels_matches_jax(name, coarse_direct, vec):
    tdt, jdt, tol = VEC[vec]
    if coarse_direct and vec == "float64":
        tol = 1e-7
    lv_j, lv_t, b = _bf16_levels(name)
    # line_inv keeps the solve dtype
    lv_j = [dataclasses.replace(lv, line_inv=None if lv.line_inv is None
                                else lv.line_inv.astype(jdt)) for lv in lv_j]
    lv_t = [dataclasses.replace(lv, line_inv=None if lv.line_inv is None
                                else lv.line_inv.to(tdt)) for lv in lv_t]
    kw = dict(nu=1, coarse_sweeps=10, coarse_direct=coarse_direct)
    Mj = jax.jit(jmg.make_mg_preconditioner(lv_j, **kw))
    Mt = tmg.make_mg_preconditioner(lv_t, dtype=tdt, **kw)
    z_t = Mt(torch.as_tensor(b, dtype=tdt))
    z_j = Mj(jnp.asarray(b, jdt))
    assert z_t.dtype == tdt and z_j.dtype == jdt
    assert _rel(z_t, z_j) < tol


def test_bf16_mg_step_matches_jax(monkeypatch):
    cfg = MacroConfig(nx=17, ny=17, nz=17, lx=2.0, ly=2.0, lz=2.0, bc_type=0,
                      dtype="float32", pc_type="mg", constitutive="j2",
                      mg_dtype="bfloat16", dt=0.05)
    seen = []
    make = tproblem.make_mg_preconditioner

    def spy(levels, **kw):
        seen.append(([lv.A_soa.dtype for lv in levels], kw["dtype"]))
        return make(levels, **kw)

    monkeypatch.setattr(tproblem, "make_mg_preconditioner", spy)
    U = cfg.displacement(1)
    pj = JaxProblem(cfg, n_devices=1)
    _, _, dj = pj.time_step_jit(*pj.init_fields(), jnp.asarray(U, pj.dtype))
    pt = MacroProblem(cfg, "cpu")
    _, _, dt = pt.time_step(*pt.init_fields(), U)
    assert seen and all(set(d) == {torch.bfloat16} and v == torch.float32 for d, v in seen)
    n = dt.n_solves
    assert dt.converged and bool(dj.converged) and n == int(dj.n_solves) >= 2
    assert list(dt.ksp_its[:n]) == [int(v) for v in np.asarray(dj.ksp_its)[:n]]
    assert int(dt.non_linear.sum()) == int(np.asarray(dj.non_linear).sum()) > 0
    res_j = np.asarray(dj.res_norms)[:dt.n_homogenize].astype(np.float64)
    assert np.isclose(dt.res_norms[0], res_j[0], rtol=1e-6)
    assert np.allclose(dt.res_norms[:dt.n_homogenize], res_j, rtol=1e-3)


def test_mg_dtype_names():
    for name, want in [("", torch.float32), ("float32", torch.float32),
                       ("bfloat16", torch.bfloat16), ("float16", torch.float16)]:
        cfg = PortConfig(nx=5, ny=3, nz=3, dtype="float32", mg_dtype=name)
        assert MacroProblem(cfg, "cpu")._mg_dtype() == want
    with pytest.raises(ValueError, match="mg_dtype"):
        MacroProblem(PortConfig(nx=5, ny=3, nz=3, mg_dtype="int8"), "cpu")._mg_dtype()
