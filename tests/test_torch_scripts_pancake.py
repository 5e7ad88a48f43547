"""scripts/_pancake_mg_check_torch.py against the body of the JAX
package's scripts/_pancake_mg_check.py, on the CPU at float64:
``check((17,3,17), nus=(1,2), omegas=(0.6,1.0))`` gives the JAX body's
level shapes and its Jacobi and MG PCG iteration counts and stop reasons
exactly, and its solutions within 1e-8 relative (the CG tolerance is
1e-5: another summation order moves the iterates far less than that;
both sides draw the right-hand side from the same numpy generator).  And
the script's exit code: 1 when a grid fails, 0 otherwise."""

import json

import pytest
import torch

import _torch_scripts_common as common

torch.set_num_threads(1)

pancake = common.load_script("_pancake_mg_check_torch")

SHAPE, NUS, OMEGAS = (17, 3, 17), (1, 2), (0.6, 1.0)
# the JAX script's body for one grid, its prints replaced by a record
JAX_PROGRAM = f"SHAPE = {SHAPE!r}\n" + r"""
from macroc_tpu import bc as bc_mod
from macroc_tpu.config import MacroConfig, MaterialParams
from macroc_tpu.constitutive.elastic import elastic_matrix
from macroc_tpu.fem.element import b_for
from macroc_tpu.fem.kernels import assemble_stencil_soa
from macroc_tpu.grid import make_grid
from macroc_tpu.ops.stencil_pallas import stencil_matvec_soa, x_to_soa
from macroc_tpu.solve import cg_solve, jacobi_precond_soa
from macroc_tpu.solve.mg import build_hierarchy, make_mg_preconditioner

nx, ny, nz = SHAPE
cfg = MacroConfig(nx=nx, ny=ny, nz=nz, lx=50.0, ly=1.0, lz=50.0, dtype="float64",
                  ref_b_quirk=True)
grid = make_grid(cfg, 1)
shape = (nx, ny, nz)
B = jnp.asarray(b_for(grid.spacing, True))
C = elastic_matrix(MaterialParams())
ctan = jnp.broadcast_to(jnp.asarray(C), (nx - 1, ny - 1, nz - 1, 8, 6, 6))
bc = bc_mod.build_bc(grid, cfg, jnp.float64)
A_soa = bc_mod.apply_bc_stencil_soa(assemble_stencil_soa(ctan, B, grid.wg, shape), bc)
bc_soa = jnp.moveaxis(bc.mask, -1, 0)
rng = np.random.default_rng(3)
b = x_to_soa(jnp.asarray(np.where(np.asarray(bc.mask), 0.0, rng.normal(size=shape + (3,)))))
mv = lambda x: stencil_matvec_soa(A_soa, x)
r_j = jax.jit(lambda bb: cg_solve(mv, bb, jacobi_precond_soa(A_soa), rtol=1e-5))(b)
levels = build_hierarchy(ctan, bc_soa, grid.spacing, ref_quirk=True, A0_soa=A_soa)
rec = lambda r: dict(its=int(r.its), reason=int(r.reason), x=np.asarray(r.x).tolist())
out = dict(levels=[list(l.A_soa.shape[-3:]) for l in levels], jacobi=rec(r_j))
nu, omega = json.loads(sys.argv[1])
M = make_mg_preconditioner(levels, nu=nu, omega=omega, coarse_sweeps=10)
r_m = jax.jit(lambda bb: cg_solve(mv, bb, M, rtol=1e-5))(b)
err = float(jnp.linalg.norm(r_m.x - r_j.x) / jnp.linalg.norm(r_j.x))
out[f"mg_{nu}_{omega}"] = dict(rec(r_m), nu=nu, omega=omega, rel_diff=err)
print("JAX " + json.dumps(out), flush=True)
"""


@pytest.fixture(scope="module", autouse=True)
def jax_side():
    # one process per (nu, omega), each with the Jacobi solve and the
    # hierarchy
    runs = common.JaxRuns(JAX_PROGRAM, [json.dumps([nu, om]) for nu in NUS for om in OMEGAS])
    yield runs.get
    runs.close()


@pytest.fixture(scope="module")
def port():
    return pancake.check(SHAPE, nus=NUS, omegas=OMEGAS, device="cpu")


def test_levels_match(jax_side, port):
    assert port["levels"] == jax_side("levels") == [[17, 3, 17], [9, 3, 9], [5, 3, 5], [3, 3, 3]]
    assert port["line_dim"] == 1


def test_jacobi_matches(jax_side, port):
    want = jax_side("jacobi")
    assert (port["jacobi"]["its"], port["jacobi"]["reason"]) == (want["its"], want["reason"])
    assert common.rel(port["jacobi"]["x"], want["x"]) < 1e-8


@pytest.mark.parametrize("k", range(len(NUS) * len(OMEGAS)))
def test_mg_matches(jax_side, port, k):
    got = port["mg"][k]
    want = jax_side(f"mg_{got['nu']}_{got['omega']}")
    assert (got["its"], got["reason"]) == (want["its"], want["reason"])
    assert common.rel(got["x"], want["x"]) < 1e-8
    assert got["rel_diff"] == pytest.approx(want["rel_diff"], rel=1e-6)


@pytest.mark.parametrize("fail", [False, True])
def test_main_exits_non_zero_on_a_failed_grid(monkeypatch, tmp_path, capsys, fail):
    check = pancake.check

    def small(shape, **kw):
        if fail and shape == (9, 3, 9):
            raise RuntimeError("made to fail")
        return check(shape, nus=(1,), omegas=(0.6,), **kw)

    monkeypatch.setattr(pancake, "check", small)
    monkeypatch.setattr(pancake, "SHAPES", [(9, 3, 9), (9, 3, 7)])
    monkeypatch.setenv("MACROC_PLATFORM", "cpu")
    out = tmp_path / "pancake.json"
    code = pancake.main(["--out", str(out)])
    printed = capsys.readouterr().out
    result = json.loads(out.read_text())
    assert code == int(fail)
    assert result["failures"] == (["9x3x9"] if fail else [])
    want = [[9, 3, 7]] if fail else [[9, 3, 9], [9, 3, 7]]
    assert [r["shape"] for r in result["results"]] == want
    assert "x" not in result["results"][0]["jacobi"]
    assert ("9x3x9: FAILED" in printed) == fail
