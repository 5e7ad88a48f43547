"""The CUDA kernels of the torch port against their plain PyTorch versions,
on the card.  Every test here is marked ``gpu`` and skips without a CUDA
device.  The file imports no jax, so it runs where jax is not installed:

    python -m pytest --noconftest -o addopts="" tests/test_torch_gpu.py -q

Tolerances (max abs difference over max abs value): 1e-5 in float32 and
1e-12 in float64 — the kernels sum in another order than the plain
versions; the earlier two-stage K2's combine adds in the plain version's
order, so it is held bitwise.  The micro-FE homogenize on the card is held against the CPU at
float64 to 1e-9: its micro CG iterates carry the roundoff of another
summation order, stopped at the 1e-8 CG tolerance."""

import math

import numpy as np
import pytest
import torch

from macroc_tpu_torch import MacroConfig, MaterialParams
from macroc_tpu_torch import bc as tbc
from macroc_tpu_torch.constitutive.elastic import elastic_matrix
from macroc_tpu_torch.fem.element import b_matrix
from macroc_tpu_torch.fem.kernels import assemble_stencil_soa
from macroc_tpu_torch.grid import make_grid
from macroc_tpu_torch.ops import assembly as asm
from macroc_tpu_torch.constitutive.microfe import MicroFEEngine
from macroc_tpu_torch.ops import cg_fused
from macroc_tpu_torch.ops.stencil_spmv import (
    StencilOperator,
    stencil_matvec,
    stencil_matvec_dot,
    stencil_matvec_dot_plain,
    stencil_matvec_dot_sym,
    stencil_matvec_dot_sym_plain,
    stencil_matvec_soa,
    stencil_matvec_v1,
    stencil_transpose_soa,
)
from macroc_tpu_torch.problem import MacroProblem
from macroc_tpu_torch.solve import cg as cg_mod, cg_state
from macroc_tpu_torch.solve.gmres import gmres_solve
from macroc_tpu_torch.solve.precond import jacobi_precond_soa

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu

TOLS = [(torch.float32, 1e-5), (torch.float64, 1e-12)]


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("shape", [(33, 17, 45), (64, 64, 64)])
def test_k1_kernel_matches_plain(cuda, shape, dtype, tol):
    rng = np.random.default_rng(4)
    A = torch.as_tensor(rng.normal(size=(27, 3, 3) + shape), dtype=dtype, device=cuda)
    x = torch.as_tensor(rng.normal(size=(3,) + shape), dtype=dtype, device=cuda)
    xh = torch.as_tensor(
        rng.normal(size=(3,) + tuple(n + 2 for n in shape)), dtype=dtype, device=cuda
    )
    before = stencil_matvec.launches
    assert _rel(stencil_matvec(A, x), stencil_matvec_soa(A, x)) < tol
    assert _rel(stencil_matvec(A, xh, halo=True), stencil_matvec_soa(A, xh, halo=True)) < tol
    assert stencil_matvec.launches == before + 2


NARROW = [(torch.bfloat16, torch.float32), (torch.bfloat16, torch.float64),
          (torch.float16, torch.float32), (torch.float16, torch.float64),
          (torch.float32, torch.float64)]


@pytest.mark.parametrize("a_dtype,dtype", NARROW)
@pytest.mark.parametrize("shape", [(33, 17, 45), (64, 64, 64)])
def test_k1_narrow_operator_matches_plain(cuda, shape, a_dtype, dtype):
    """K1 with the operator stored narrower than the vectors (-mg_dtype):
    each coefficient widens exactly, so it agrees with the plain version
    to the vector dtype's bound, as the same-type kernel does."""
    tol = dict(TOLS)[dtype]
    rng = np.random.default_rng(8)
    A = torch.as_tensor(rng.normal(size=(27, 3, 3) + shape), device=cuda).to(a_dtype)
    x = torch.as_tensor(rng.normal(size=(3,) + shape), dtype=dtype, device=cuda)
    xh = torch.as_tensor(
        rng.normal(size=(3,) + tuple(n + 2 for n in shape)), dtype=dtype, device=cuda
    )
    before = stencil_matvec.launches
    y = stencil_matvec(A, x)
    assert y.dtype == dtype
    assert _rel(y, stencil_matvec_soa(A, x)) < tol
    assert _rel(stencil_matvec(A, xh, halo=True), stencil_matvec_soa(A, xh, halo=True)) < tol
    assert stencil_matvec.launches == before + 2


def test_k1_refuses_other_dtype_pairs(cuda):
    A = torch.zeros((27, 3, 3, 4, 4, 4), device=cuda)
    for a, x in [(torch.bfloat16, torch.bfloat16), (torch.float64, torch.float32),
                 (torch.bfloat16, torch.float16)]:
        with pytest.raises(TypeError, match="no kernel for A"):
            stencil_matvec(A.to(a), torch.zeros((3, 4, 4, 4), device=cuda, dtype=x))


def test_gmres_on_gpu_matches_cpu(cuda):
    """Jacobi-GMRES(10) on a BC-eliminated 9x3x9 circle stencil at float64,
    through K1 on the card against the plain version on the CPU: the same
    iteration count and reason, x to 1e-10."""
    cfg = MacroConfig(nx=9, ny=3, nz=9, lx=10.0, ly=1.0, lz=10.0, bc_type=1,
                      rad=2.0, dtype="float64")
    grid = make_grid(cfg, 1)
    shape = (grid.nx, grid.ny, grid.nz)
    rng = np.random.default_rng(9)
    C = elastic_matrix(MaterialParams())
    ct = C * (1.0 + 0.5 * rng.random(tuple(n - 1 for n in shape) + (8, 1, 1)))
    b = rng.normal(size=(3,) + shape)
    out = {}
    for dev in ("cpu", cuda):
        bc = tbc.build_bc(grid, cfg, torch.float64, dev)
        B = torch.as_tensor(b_matrix(grid.spacing), dtype=torch.float64, device=dev)
        A = tbc.apply_bc_stencil_soa(
            assemble_stencil_soa(torch.as_tensor(ct, device=dev), B, grid.wg, shape), bc
        )
        rhs = torch.as_tensor(b, device=dev).masked_fill(bc.mask.permute(3, 0, 1, 2), 0.0)
        before = stencil_matvec.launches
        r = gmres_solve(lambda v: stencil_matvec(A, v), rhs, jacobi_precond_soa(A),
                        rtol=1e-10, restart=10)
        out[str(dev)] = r
        if dev != "cpu":
            # one launch per Arnoldi step and one per cycle's true residual
            assert stencil_matvec.launches - before == r.its + math.ceil(r.its / 10)
    c, g = out["cpu"], out[str(cuda)]
    assert g.its == c.its and g.reason == c.reason > 0 and c.its > 10
    assert _rel(g.x.cpu(), c.x) < 1e-10


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("ne", [(20, 9, 27), (32, 32, 32), (9, 2, 9)])
def test_k2_kernel_matches_plain(cuda, ne, dtype, tol):
    """The fused K2 against its plain version (stage 1 + combine_plain) and
    the slab form, on a contiguous ctan and on a slice of a node-shaped
    field (the Newton step's layout); two launches are bitwise equal."""
    rng = np.random.default_rng(5)
    shape = tuple(n + 1 for n in ne)
    B = torch.as_tensor(b_matrix((1.0, 1.1, 0.9)), dtype=dtype, device=cuda)
    ct = torch.as_tensor(rng.normal(size=ne + (8, 6, 6)), dtype=dtype, device=cuda)
    Ke = asm.element_stiffness_cm(ct, B, 0.1)
    assert torch.equal(asm.combine_cuda(Ke, shape), asm.combine_plain(Ke, shape))
    del Ke
    plain = asm.assemble_stencil_soa_plain(ct, B, 0.1, shape).reshape(27, 3, 3, *shape)
    before = asm.assemble_stencil_soa_kernel.launches
    A = asm.assemble_stencil_soa_kernel(ct, B, 0.1, shape)
    assert asm.assemble_stencil_soa_kernel.launches == before + 1
    assert _rel(A, plain) < tol
    assert _rel(A, assemble_stencil_soa(ct, B, 0.1, shape)) < tol
    assert torch.equal(asm.assemble_stencil_soa_kernel(ct, B, 0.1, shape), A)
    padded = torch.zeros(shape + (8, 6, 6), dtype=dtype, device=cuda)
    padded[:-1, :-1, :-1] = ct
    sliced = padded[:-1, :-1, :-1]
    assert not sliced.is_contiguous()
    assert torch.equal(asm.assemble_stencil_soa_kernel(sliced, B, 0.1, shape), A)


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("tile", [(4, 4, 32), (3, 5, 16), (1, 1, 1024)])
@pytest.mark.parametrize("shape", [(33, 17, 45), (64, 64, 64)])
def test_k1v1_kernel_matches_plain(cuda, shape, tile, dtype, tol):
    rng = np.random.default_rng(6)
    A = torch.as_tensor(rng.normal(size=(27, 3, 3) + shape), dtype=dtype, device=cuda)
    x = torch.as_tensor(rng.normal(size=(3,) + shape), dtype=dtype, device=cuda)
    before = stencil_matvec_v1.launches
    assert _rel(stencil_matvec_v1(A, x, tile=tile), stencil_matvec_soa(A, x)) < tol
    assert stencil_matvec_v1.launches == before + 1


def _cg_state(like, active=True):
    return cg_state.CGState(like.device, rz=2.0, rnorm0=1.0, tol=1e-30, div=1e30,
                            abstol=1e-50, maxits=40, reason0=0 if active else 2,
                            pnorm=True, nodes=like[0].numel(), record_trace=True)


def _cg_iteration(steps, A, x, p, r, inv, active=True):
    """One iteration of the three fused steps on copies; returns the
    vectors and the state's scalars, flags and trace (NaN as 0)."""
    x, p, r = x.clone(), p.clone(), r.clone()
    q = torch.zeros_like(p)
    st = _cg_state(p, active)
    dot, xr, up = steps
    dot(A, p, q, st)
    xr(x, p, r, q, inv, st)
    up(p, r, inv, st)
    return dict(q=q, x=x, r=r, p=p, sc=st.sc, st=st.st, trace=st.trace.nan_to_num())


_KERNELS = (stencil_matvec_dot, cg_fused.cg_update_xr, cg_fused.cg_update_p)
_PLAIN = (stencil_matvec_dot_plain, cg_fused.cg_update_xr_plain, cg_fused.cg_update_p_plain)


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("shape", [(33, 17, 45), (64, 64, 64), (5, 3, 5)])
def test_cg_fused_kernels_match_plain(cuda, shape, dtype, tol):
    """K1's p.q form and the two update kernels against their plain
    versions; two launches bitwise equal; no-ops when the flag is 0."""
    rng = np.random.default_rng(8)
    # a dominant positive diagonal keeps p.Ap, and so alpha, away from
    # cancellation, as on a solve's SPD operator
    A = 0.1 * rng.normal(size=(27, 3, 3) + shape)
    A[13, [0, 1, 2], [0, 1, 2]] += 3.0
    A = torch.as_tensor(A, dtype=dtype, device=cuda)
    x, p, r = (torch.as_tensor(rng.normal(size=(3,) + shape), dtype=dtype, device=cuda)
               for _ in range(3))
    inv = torch.as_tensor(rng.random(size=(3,) + shape) + 0.5, dtype=dtype, device=cuda)
    before = (stencil_matvec.launches, stencil_matvec_dot.launches,
              cg_fused.cg_update_xr.launches, cg_fused.cg_update_p.launches)
    k = _cg_iteration(_KERNELS, A, x, p, r, inv)
    assert (stencil_matvec.launches, stencil_matvec_dot.launches,
            cg_fused.cg_update_xr.launches, cg_fused.cg_update_p.launches) == tuple(
                n + 1 for n in before)
    k2 = _cg_iteration(_KERNELS, A, x, p, r, inv)
    assert all(torch.equal(k[f], k2[f]) for f in k)
    pl = _cg_iteration(_PLAIN, A, x, p, r, inv)
    for f in ("q", "x", "r", "p"):
        assert _rel(k[f], pl[f]) < tol, f
    assert torch.equal(k["st"], pl["st"]) and int(k["st"][cg_state.ST_ITS]) == 1
    # alpha through p.q (cancelling terms: against the sum of |p_i q_i|),
    # then rz, beta, rnorm and the trace (sums of positive terms)
    scale = float((p * pl["q"]).abs().sum(dtype=torch.float64))
    assert abs(float(k["sc"][1] - pl["sc"][1])) < tol * scale
    for i in (0, 2, 3, 4):
        assert abs(float(k["sc"][i] / pl["sc"][i]) - 1.0) < tol, i
    assert _rel(k["trace"], pl["trace"]) < tol
    idle = _cg_iteration(_KERNELS, A, x, p, r, inv, active=False)
    assert torch.equal(idle["x"], x) and torch.equal(idle["r"], r)
    assert torch.equal(idle["p"], p) and not idle["q"].any()


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("shape", [(33, 17, 45), (10, 3, 10), (5, 3, 5)])
def test_cg_sym_kernel_matches_plain(cuda, shape, dtype, tol):
    """The half-stencil p.q form on a symmetric A against its plain version
    (q, p.q, alpha); two launches bitwise equal; blocks 0..12 poisoned
    with NaN give the same q; a no-op when the flag is 0."""
    rng = np.random.default_rng(9)
    A = 0.1 * rng.normal(size=(27, 3, 3) + shape)
    A[13, [0, 1, 2], [0, 1, 2]] += 3.0
    A = torch.as_tensor(A, dtype=dtype, device=cuda)
    A = 0.5 * (A + stencil_transpose_soa(A))
    p = torch.as_tensor(rng.normal(size=(3,) + shape), dtype=dtype, device=cuda)
    runs = []
    for _ in range(2):
        before = (stencil_matvec.launches, stencil_matvec_dot_sym.launches)
        q, st = torch.zeros_like(p), _cg_state(p)
        stencil_matvec_dot_sym(A, p, q, st)
        assert (stencil_matvec.launches, stencil_matvec_dot_sym.launches) == tuple(
            n + 1 for n in before)
        runs.append((q, st.sc.clone()))
    (q, sc), (q2, sc2) = runs
    assert torch.equal(q, q2) and torch.equal(sc, sc2)
    qp, stp = torch.zeros_like(p), _cg_state(p)
    stencil_matvec_dot_sym_plain(A, p, qp, stp)
    assert _rel(q, qp) < tol
    assert _rel(q, stencil_matvec_soa(A, p)) < tol
    scale = float((p * qp).abs().sum(dtype=torch.float64))
    assert abs(float(sc[cg_state.SC_PQ] - stp.sc[cg_state.SC_PQ])) < tol * scale
    assert abs(float(sc[cg_state.SC_ALPHA] / stp.sc[cg_state.SC_ALPHA]) - 1.0) < tol
    A[:13] = float("nan")
    qn, stn = torch.zeros_like(p), _cg_state(p)
    stencil_matvec_dot_sym(A, p, qn, stn)
    assert torch.equal(qn, q) and torch.equal(stn.sc, sc)
    idle = _cg_state(p, active=False)
    sc0 = idle.sc.clone()
    qi = torch.full_like(p, 7.0)
    stencil_matvec_dot_sym(A, p, qi, idle)
    assert bool((qi == 7.0).all()) and torch.equal(idle.sc, sc0)


def test_cg_fused_solve_on_gpu_matches_cpu(cuda, monkeypatch):
    """Jacobi PCG on a BC-eliminated 17x5x17 circle stencil at float64 to
    rtol 1e-10: the fused loop's kernels on the card against its plain
    versions on the CPU, with check intervals 1 and 16 on the card
    (bitwise equal): counts within 1, the same reason, x to 1e-10.  At
    rtol 1e-5 this thin plate's x moves by 4e-6 under a 1e-16 relative
    perturbation of A (the two devices assemble it in other orders); at
    1e-10 by 3e-12."""
    cfg = MacroConfig(nx=17, ny=5, nz=17, lx=10.0, ly=1.0, lz=10.0, bc_type=1,
                      rad=2.0, dtype="float64")
    grid = make_grid(cfg, 1)
    shape = (grid.nx, grid.ny, grid.nz)
    rng = np.random.default_rng(10)
    C = elastic_matrix(MaterialParams())
    ct = C * (1.0 + 0.5 * rng.random(tuple(n - 1 for n in shape) + (8, 1, 1)))
    b = rng.normal(size=(3,) + shape)
    out = {}
    for dev, k in (("cpu", 16), (cuda, 1), (cuda, 16)):
        bc = tbc.build_bc(grid, cfg, torch.float64, dev)
        B = torch.as_tensor(b_matrix(grid.spacing), dtype=torch.float64, device=dev)
        A = tbc.apply_bc_stencil_soa(
            assemble_stencil_soa(torch.as_tensor(ct, device=dev), B, grid.wg, shape), bc
        )
        rhs = torch.as_tensor(b, device=dev).masked_fill(bc.mask.permute(3, 0, 1, 2), 0.0)
        before = stencil_matvec_dot_sym.launches
        monkeypatch.setattr(cg_mod, "CHECK_EVERY", k)
        r = cg_mod.cg_solve(StencilOperator(A), rhs, jacobi_precond_soa(A),
                            rtol=1e-10, record_trace=True)
        out[(str(dev), k)] = r
        if dev != "cpu":
            # every queued iteration launches, the no-ops after convergence too
            assert r.its <= stencil_matvec_dot_sym.launches - before < r.its + k
    c, g1, g16 = out[("cpu", 16)], out[(str(cuda), 1)], out[(str(cuda), 16)]
    assert abs(g1.its - c.its) <= 1 and g1.reason == c.reason > 0 and c.its > 300
    assert _rel(g1.x.cpu(), c.x) < 1e-10
    assert (g16.its, g16.reason, g16.trace) == (g1.its, g1.reason, g1.trace)
    assert torch.equal(g16.x, g1.x)


def test_microfe_homogenize_on_gpu_matches_cpu(cuda):
    """A two-phase micro_n=4 engine, 24 GPs with 3 driven past yield, fast
    path on: the batched micro solves on the card against the CPU."""
    rng = np.random.default_rng(7)
    eps = rng.normal(size=(24, 6)) * 1e-4
    eps[::8] *= 600.0
    out = {}
    for dev in ("cpu", cuda):
        eng = MicroFEEngine(n=4, micro_type=1, mat1=MaterialParams(),
                            mat2=MaterialParams(E=1e6, nu=0.3, Sy=1e4, Ka=1e7),
                            dtype=torch.float64, device=dev, active_chunk=8)
        out[str(dev)] = eng.homogenize(torch.as_tensor(eps, device=dev),
                                       eng.init_state((24,)))
    c, g = out["cpu"], out[str(cuda)]
    assert torch.equal(g.non_linear.cpu(), c.non_linear) and int(c.non_linear.sum()) == 3
    for name in ("stress", "ctan", "f_trial"):
        assert _rel(getattr(g, name).cpu(), getattr(c, name)) < 1e-9, name
    for name in ("eps_p", "alpha", "u"):
        assert _rel(getattr(g.trial_state, name).cpu(), getattr(c.trial_state, name)) < 1e-9


def test_wrappers_reject_bad_input(cuda):
    A = torch.zeros((27, 3, 3, 4, 4, 4), device=cuda)
    with pytest.raises(ValueError):
        stencil_matvec(A, torch.zeros((3, 4, 4, 5), device=cuda))
    with pytest.raises(TypeError):
        stencil_matvec(A.half(), torch.zeros((3, 4, 4, 4), device=cuda).half())
    with pytest.raises(ValueError):
        asm.combine_cuda(torch.zeros((576, 3, 3, 3), device=cuda), (4, 4, 5))
    B = torch.as_tensor(b_matrix((1.0, 1.0, 1.0)), dtype=torch.float32, device=cuda)
    ct = torch.zeros((3, 3, 3, 8, 6, 6), device=cuda)
    before = asm.assemble_stencil_soa_kernel.launches
    with pytest.raises(TypeError):
        asm.assemble_stencil_soa_kernel(ct.half(), B.half(), 0.1, (4, 4, 4))
    with pytest.raises(ValueError, match="pattern"):
        asm.assemble_stencil_soa_kernel(ct, torch.rand_like(B), 0.1, (4, 4, 4))
    with pytest.raises(ValueError, match="stride"):
        asm.assemble_stencil_soa_kernel(ct.transpose(4, 5), B, 0.1, (4, 4, 4))
    with pytest.raises(ValueError):
        asm.assemble_stencil_soa_kernel(ct, B, 0.1, (4, 4, 5))
    assert asm.assemble_stencil_soa_kernel.launches == before
    with pytest.raises(ValueError):
        stencil_matvec_v1(A, torch.zeros((3, 4, 4, 4), device=cuda), tile=(8, 8, 32))
    with pytest.raises(TypeError):
        stencil_matvec_v1(A, torch.zeros((3, 4, 4, 4), device=cuda).double())
    v = torch.zeros((3, 4, 4, 4), device=cuda)
    st = _cg_state(v)
    with pytest.raises(TypeError):
        stencil_matvec_dot(A.half(), v.half(), v.half(), st)
    with pytest.raises(ValueError):
        stencil_matvec_dot(A, v, torch.zeros((3, 4, 4, 5), device=cuda), st)
    before = stencil_matvec_dot_sym.launches
    with pytest.raises(TypeError):
        stencil_matvec_dot_sym(A.double(), v, v, st)
    with pytest.raises(ValueError):
        stencil_matvec_dot_sym(A, v, v, _cg_state(v.cpu()))
    assert stencil_matvec_dot_sym.launches == before
    with pytest.raises(ValueError):
        cg_fused.cg_update_xr(v, v, v, v.double(), None, st)
    with pytest.raises(ValueError):
        cg_fused.cg_update_p(v, v, None, _cg_state(v.cpu()))


def test_newton_step_on_gpu_matches_cpu(cuda):
    """One J2 + MG Newton step on a 17^3 cube: the kernels' path on the
    card against the plain path on the CPU, at float64.  The CG iterates
    carry roundoff of another summation order: u to 1e-8."""
    cfg = MacroConfig(nx=17, ny=17, nz=17, lx=2.0, ly=2.0, lz=2.0, bc_type=0,
                      dtype="float64", pc_type="mg", dt=0.05)
    out = {}
    for dev in ("cpu", cuda):
        p = MacroProblem(cfg, dev)
        u, state = p.init_fields()
        u, state, d = p.time_step(u, state, cfg.displacement(1))
        out[str(dev)] = (u.cpu(), d)
    (u_c, d_c), (u_g, d_g) = out["cpu"], out[str(cuda)]
    assert d_g.converged and d_g.n_solves == d_c.n_solves
    assert np.isclose(d_g.res_norms[0], d_c.res_norms[0], rtol=1e-12)
    assert _rel(u_g, u_c) < 1e-8
