"""The port's bench entry points (bench_torch.py, scripts/profile_newton_torch.py)
against the JAX package's bench.py, on the CPU at tiny sizes and float64.

Each bench function of both runs on the same shapes and settings; their
outputs that are not times must agree: KSP counts of the Newton and FE²
steps, ``n_active`` of the partial micro-FE population (the GPs driven 600x
past the random draw, every 10th), the keys of every returned dict, and
the SpMV variants' correctness gate.  The JAX functions (~10-20 s of XLA
compiles each) run in three subprocesses started when the module starts,
so they overlap the port's side; the inputs are each side's own seeded
draws, which the compared counts do not depend on.  For ``n_active`` the
JAX side runs the function ``bench_microfe_partial`` times (a jitted
``MicroFEEngine.homogenize`` on the bench's inputs), since the bench
function adds an eager homogenize of ~20 s on the CPU for its count.
"""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import bench_torch  # noqa: E402
from macroc_tpu_torch.utils.profiling import Timings, load_script  # noqa: E402

# the JAX bench functions, each with the tiny shapes the port runs too
JAX_PROGRAM = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
from macroc_tpu.utils.cache import setup_runtime
setup_runtime()
jax.config.update("jax_enable_compilation_cache", False)
import jax.numpy as jnp
import numpy as np
import bench


def partial_n_active():
    # the function bench_microfe_partial times, on its inputs: the bench
    # itself adds an eager homogenize (~20 s) for its n_active
    from macroc_tpu.config import MIC_LAYER_Y, MaterialParams
    from macroc_tpu.constitutive.microfe import MicroFEEngine

    eng = MicroFEEngine(n=2, micro_type=MIC_LAYER_Y, mat1=MaterialParams(),
                        mat2=MaterialParams(E=1.0e6, nu=0.3, Sy=1.0e4, Ka=1.0e7),
                        dtype=jnp.float64, elastic_fastpath=True)
    eps = jax.random.normal(jax.random.PRNGKey(3), (64, 6), jnp.float64) * 1e-4
    eps = eps.at[np.arange(0, 64, 10)].mul(600.0)
    r = jax.jit(eng.homogenize)(eps, eng.init_state((64,)))
    return dict(n_active=int(jnp.sum(r.non_linear)))


calls = {
    "newton_mg": lambda: bench.bench_newton_step(n=9, dtype="float64", pc_type="mg"),
    "newton_jacobi": lambda: bench.bench_newton_step(n=9, dtype="float64", pc_type="jacobi"),
    "partial": partial_n_active,
    "fe2_fast": lambda: bench.bench_fe2_step(nx=5, ny=3, nz=5, micro_n=2, dtype="float64",
                                             fastpath=True),
    "fe2_full": lambda: bench.bench_fe2_step(nx=5, ny=3, nz=5, micro_n=2, dtype="float64",
                                             fastpath=False),
}
print("JAX " + json.dumps({k: calls[k]() for k in sys.argv[1].split(",")}), flush=True)
"""
JAX_GROUPS = ("newton_mg,newton_jacobi", "partial,fe2_fast", "fe2_full")
JAX_TIMEOUT_S = 300

PORT_CALLS = {
    "bench_spmv": lambda t: bench_torch.bench_spmv(
        n=9, dtype=torch.float64, device="cpu", timings=t),
    "bench_newton_step": lambda t: {
        pc: bench_torch.bench_newton_step(n=9, dtype="float64", pc_type=pc, device="cpu",
                                          timings=t) for pc in ("mg", "jacobi")},
    "bench_microfe": lambda t: {
        fp: bench_torch.bench_microfe(n_gps=16, micro_n=2, dtype=torch.float64, fastpath=fp,
                                      device="cpu", timings=t) for fp in (False, True)},
    "bench_microfe_partial": lambda t: bench_torch.bench_microfe_partial(
        n_gps=64, micro_n=2, dtype=torch.float64, device="cpu", timings=t),
    "bench_assembly_shmap": lambda t: bench_torch.bench_assembly_shmap(
        dtype=torch.float64, device="cpu", timings=t, shard=(4, 3, 5), n=6),
    "bench_fe2_step": lambda t: {
        fp: bench_torch.bench_fe2_step(nx=5, ny=3, nz=5, micro_n=2, dtype="float64",
                                       fastpath=fp, device="cpu", timings=t)
        for fp in (True, False)},
}


@pytest.fixture(scope="module", autouse=True)
def jax_bench():
    """The JAX bench results by name; the subprocesses start with the
    module and are read at the first call."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, "-c", JAX_PROGRAM, g], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)
             for g in JAX_GROUPS]
    results = {}

    def get(name):
        if not results:
            for g, p in zip(JAX_GROUPS, procs):
                out = p.communicate(timeout=JAX_TIMEOUT_S)[0]
                lines = [l for l in out.splitlines() if l.startswith("JAX ")]
                assert p.returncode == 0 and lines, f"JAX bench {g} failed:\n{out[-4000:]}"
                results.update(json.loads(lines[-1][4:]))
        return results[name]

    try:
        yield get
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def port():
    """Every port bench function at the tiny shapes, one sample per timing."""
    t = Timings("cpu", reps=1)
    return {name: call(t) for name, call in PORT_CALLS.items()}


def jax_keys(fn_name):
    """The keys of the dict that bench.py's ``fn_name`` returns, read from
    its source: ``return dict(...)`` keywords and ``out["..."] =``
    assignments."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == fn_name)
    keys = set()
    for node in ast.walk(fn):
        if (isinstance(node, ast.Return) and isinstance(node.value, ast.Call)
                and getattr(node.value.func, "id", None) == "dict"):
            keys |= {k.arg for k in node.value.keywords}
        if isinstance(node, ast.Assign):
            keys |= {t.slice.value for t in node.targets
                     if isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name)
                     and t.value.id == "out" and isinstance(t.slice, ast.Constant)}
    return keys


@pytest.mark.parametrize("name", sorted(PORT_CALLS))
def test_bench_function_returns_the_jax_keys(port, name):
    results = port[name]
    for r in results.values() if name in ("bench_newton_step", "bench_microfe",
                                          "bench_fe2_step") else [results]:
        want = jax_keys(name)
        assert want and want <= set(r), sorted(want - set(r))


def test_spmv_variants_pass_the_gate(port):
    r = port["bench_spmv"]
    assert set(r["all_variants"]) == {"plain_soa", "k1", "k1v1_4x4x32", "k1_halo_1x1x1"}
    assert r["variant"] != "k1_halo_1x1x1" and r["variant"] in r["all_variants"]
    assert set(r["library_ms"]) == {"csr_torch_sparse"}
    # 27 couplings per interior node, fewer at the faces: 9^3 nodes, 3x3 blocks
    assert r["library_nnz"] == 9 * (3 * 9 - 2) ** 3
    assert r["halo_ratio"] > 0 and r["nnz_per_s"] == 243 * 9 ** 3 / r["spmv_s"]


def test_spmv_gate_refuses_a_wrong_variant(monkeypatch):
    from macroc_tpu_torch.ops import stencil_spmv

    plain = stencil_spmv.stencil_matvec_soa
    monkeypatch.setattr(stencil_spmv, "stencil_matvec_v1",
                        lambda A, x: plain(A, x) * (1.0 + 1e-4))
    with pytest.raises(AssertionError, match="k1v1_4x4x32 mismatch"):
        bench_torch.bench_spmv(n=5, dtype=torch.float64, device="cpu",
                               timings=Timings("cpu", reps=1))


@pytest.mark.parametrize("pc", ["mg", "jacobi"])
def test_newton_ksp_its_match_jax(port, jax_bench, pc):
    got, want = port["bench_newton_step"][pc], jax_bench(f"newton_{pc}")
    assert set(want) == jax_keys("bench_newton_step")
    assert got["ksp_its"] == want["ksp_its"] and got["n"] == want["n"] == 9


def test_microfe_partial_n_active_matches_jax(port, jax_bench):
    got, want = port["bench_microfe_partial"], jax_bench("partial")
    # the driven GPs, every 10th of 64, and no GP of the random draw
    assert got["n_active"] == want["n_active"] == len(range(0, 64, 10))


@pytest.mark.parametrize("fastpath", [True, False], ids=["fast", "full"])
def test_fe2_ksp_its_match_jax(port, jax_bench, fastpath):
    got = port["bench_fe2_step"][fastpath]
    want = jax_bench("fe2_fast" if fastpath else "fe2_full")
    assert set(want) == jax_keys("bench_fe2_step")
    assert got["ksp_its"] == want["ksp_its"]
    assert (got["n_gps"], list(got["grid"])) == (want["n_gps"], want["grid"]) == (256, [5, 3, 5])


def test_microfe_rates(port):
    for fastpath, r in port["bench_microfe"].items():
        assert r["fastpath"] is fastpath and r["n_gps"] == 16 and r["gp_per_s"] > 0


def test_profile_newton_returns_every_phase():
    prof = load_script("profile_newton_torch")
    res = prof.main(n=9, device="cpu", timings=Timings("cpu", reps=1))
    assert set(res) == set(prof.PHASES) | {"sum(hom+linsolve)"}
    assert all(v > 0 for v in res.values())
    assert res["sum(hom+linsolve)"] == res["homogenize+residual"] + res["linear_solve(total)"]


def test_timings_record_median_spread_and_samples():
    t = Timings("cpu", reps=3)
    assert t.med("x", [1.0, 4.0, 2.0]) == 2.0
    assert t.spreads["x"] == dict(median=2.0, spread_frac=1.5, samples=[1.0, 4.0, 2.0])
    calls = []
    t.dispatch(lambda: calls.append(1), label="d", calls=2)
    assert len(calls) == 1 + 3 * 2 and len(t.spreads["d"]["samples"]) == 3
    calls.clear()
    t.loop(lambda: calls.append(1), 4, label="l")
    assert len(calls) == 1 + 3 * 4 and len(t.spreads["l"]["samples"]) == 3


def test_bench_does_not_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench_torch.main([])
