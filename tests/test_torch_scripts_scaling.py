"""scripts/scaling_sweep_torch.py on the CPU: ``run_one(n, grid=9,
steps=1)`` as 1 and 2 gloo ranks (MACROC_PLATFORM=cpu) against the JAX
package's scripts/scaling_sweep.py step, its program run with the same
settings on 1 and 2 of the conftest's virtual devices, at float64 (the
JAX script's f32 is the one setting changed, so that
tests/test_torch_dist.py's decomposition bounds apply: KSP its equal,
the global |u| within 1e-8 relative).  And the script's exit code: 1 when
a count fails, 0 otherwise."""

import json

import numpy as np
import pytest
import torch

import _torch_scripts_common as common

torch.set_num_threads(1)

sweep = common.load_script("scaling_sweep_torch")

GRID = 9
# the body of scripts/scaling_sweep.py's run_one program, dtype float64,
# returning the KSP its and |u| of the step it times
JAX_PROGRAM = f"grid = {GRID}\n" + r"""
from macroc_tpu.config import MacroConfig, BC_BENDING
from macroc_tpu.grid import decide_processor_grid
from macroc_tpu.problem import MacroProblem
from macroc_tpu.parallel import make_grid_mesh, shard_problem_fields

out = {}
for n in (1, 2):
    px, py, pz = decide_processor_grid(n, grid, grid, grid)
    cfg = MacroConfig(nx=grid, ny=grid, nz=grid, lx=4.0, ly=4.0, lz=4.0,
                      bc_type=BC_BENDING, dtype="float64",
                      procs_x=px, procs_y=py, procs_z=pz,
                      newton_max_its=1, ksp_maxits=50)
    p = MacroProblem(cfg, n_devices=n)
    mesh = make_grid_mesh(p.grid, jax.devices()[:n])
    u, state = p.init_fields()
    u, state = shard_problem_fields(mesh, u, state)
    step = jax.jit(p.time_step)
    U = jnp.asarray(-0.01, p.dtype)
    u2, s2, d = step(u, state, U)
    out[str(n)] = dict(procs=[px, py, pz], ksp_its=int(d.ksp_its[0]),
                       u_norm=float(np.linalg.norm(np.asarray(p.unpad_u(u2)))))
print("JAX " + json.dumps(out), flush=True)
"""


@pytest.fixture(scope="module", autouse=True)
def jax_side():
    runs = common.JaxRuns(JAX_PROGRAM, ["both"])
    yield runs.get
    runs.close()


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setenv("MACROC_PLATFORM", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.mark.parametrize("n", [1, 2])
def test_run_one_matches_the_jax_step(jax_side, on_cpu, n):
    r = sweep.run_one(n, GRID, 1, dtype="float64")
    want = jax_side(str(n))
    assert r["procs"] == want["procs"]
    assert r["backend"] == (None if n == 1 else "gloo")
    assert r["ksp_its"] == want["ksp_its"] < 50
    assert r["u_norm"] == pytest.approx(want["u_norm"], rel=1e-8)
    assert r["step_s"] > 0 and r["spread_frac"] >= 0
    # the CPU runs the plain versions: no kernel launch
    assert r["launches"] == dict(K1=0, K2=0)


@pytest.mark.parametrize("fail", [False, True])
def test_main_exits_non_zero_on_a_failed_count(monkeypatch, on_cpu, tmp_path, capsys, fail):
    run_one = sweep.run_one

    def one(n, grid, steps):
        if fail and n == 2:
            raise RuntimeError("made to fail")
        return run_one(n, grid, steps)

    monkeypatch.setattr(sweep, "run_one", one)
    out = tmp_path / "scaling.json"
    code = sweep.main(["--grid", "5", "--steps", "1", "--devices", "1,2", "--out", str(out)])
    printed = capsys.readouterr().out
    result = json.loads(out.read_text())
    assert code == int(fail)
    assert result["failures"] == (["devices=2"] if fail else [])
    assert sorted(result["results"]) == (["1"] if fail else ["1", "2"])
    assert result["results"]["1"]["speedup"] == 1.0
    assert ("devices=2: FAILED" in printed) == fail
    assert np.isclose(result["results"]["1"]["efficiency"], 1.0)
