"""The domain-decomposed J2 Newton step of macroc_tpu_torch on N gloo ranks
(CPU, float64) against the port's one-process run and the JAX package's
``MacroProblem(cfg, n_devices=N)`` on N of the conftest's virtual devices.

Configurations:
  - circle_5x3x3: tests/test_multiprocess.py's grid and flags at 2 ranks
    (no node of the y=LY face lies inside its r=2 circle, so it checks the
    unloaded step: |RES| 0, no solve);
  - bending_9x5x5: tests/test_dist.py's bending grid at ranks (2,2,1);
  - degenerate_5x3x3: the bending_elastic_5x3x3 golden's grid at ranks
    (1,2,2), where DMDA gives a rank one node plane in y and z;
  - gmres_9x5x5: the bending grid at 2 ranks with GMRES;
  - plastic_5x3x3: the bending_plastic_5x3x3 golden's flags at 2 ranks,
    whose GPs yield from step 1 on;
  - circle_9x3x9: the circle_elastic_9x3x9 golden's flags at ranks
    (2,1,2): the loaded circle patch cut by both splits (its GPs yield).

Bounds.  Elastic steps: solves and KSP its equal, |RES| trace and force
within 1e-8 relative (tests/test_multiprocess.py's bound), u within 1e-8
of its largest entry: N-rank dots sum in another order, which moves only
the last bits of a well-conditioned elastic solve.  Yielding steps: the
golden roundoff bounds of tests/test_torch_golden.py
(``_assert_roundoff_bound``: solves, converged flags and yielded-GP counts
exact, KSP its within 6, first |RES| 1e-7, force and f_trial_max 1e-5),
because both goldens pin roundoff: PCG on their plastic (or weakly
constrained) systems turns last-bit differences into a few KSP
iterations (ROADMAP R5).

Plus a 2-rank CLI run: rank 0 alone narrates and writes info.dat and
gauss_evolution.dat, whose columns are the JAX per-rank counts.
"""

import json
import os

import numpy as np
import pytest
import torch

from test_torch_halo import launch_ranks

torch.set_num_threads(1)

BENDING = dict(nx=9, ny=5, nz=5, lx=4.0, ly=2.0, lz=2.0, bc_type=0, dtype="float64",
               dt=0.001, u_max=-1.0, newton_max_its=3, ts=2)
BENDING_5 = dict(nx=5, ny=3, nz=3, lx=4.0, ly=2.0, lz=2.0, bc_type=0, dtype="float64")
CONFIGS = {
    "circle_5x3x3": (2, dict(nx=5, ny=3, nz=3, lx=10.0, ly=1.0, lz=10.0, bc_type=1, rad=2.0,
                             dtype="float64", ts=2, dt=0.002, newton_max_its=3,
                             constitutive="j2")),
    "bending_9x5x5": (4, dict(BENDING, procs_x=2, procs_y=2, procs_z=1)),
    "degenerate_5x3x3": (4, dict(BENDING_5, ts=3, procs_x=1, procs_y=2, procs_z=2)),
    "gmres_9x5x5": (2, dict(BENDING, ksp_type="gmres")),
    "plastic_5x3x3": (2, dict(BENDING_5, ts=4, dt=0.15, newton_max_its=10)),
    "circle_9x3x9": (4, dict(nx=9, ny=3, nz=9, lx=10.0, ly=1.0, lz=10.0, bc_type=1, rad=2.0,
                             dtype="float64", ts=4, dt=0.05, procs_x=2, procs_y=1, procs_z=2)),
}
YIELDING = ["plastic_5x3x3", "circle_9x3x9"]
ELASTIC = ["circle_5x3x3", "bending_9x5x5", "degenerate_5x3x3", "gmres_9x5x5"]


def _steps_torch(p, cfg):
    """Run cfg.ts steps of a port MacroProblem; per-step records and the
    final (u, state) as global numpy arrays (a collective on a rank)."""
    from macroc_tpu_torch.problem import fields_to_numpy

    u, state = p.init_fields()
    steps = []
    for ts in range(cfg.ts):
        u, state, d = p.time_step(u, state, cfg.displacement(ts))
        counts = p.nonlinear_counts(d.non_linear)
        steps.append(dict(res_norms=[float(v) for v in d.res_norms[:d.n_homogenize]],
                          ksp_its=[int(v) for v in d.ksp_its[:d.n_solves]],
                          force=d.force, f_trial_max=d.f_trial_max,
                          nl_gps=int(counts.sum()), per_rank=counts.tolist(),
                          converged=bool(d.converged)))
    u_g, eps_p, alpha = fields_to_numpy(u, state, p.mesh)
    return steps, p.unpad_u(u_g), eps_p


def _rank_main(name, out_dir):
    """One rank of the N-rank run of CONFIGS[name]; rank 0 saves it."""
    torch.set_num_threads(1)
    from macroc_tpu_torch.config import MacroConfig
    from macroc_tpu_torch.parallel import distributed
    from macroc_tpu_torch.problem import MacroProblem

    assert distributed.maybe_initialize()
    cfg = MacroConfig(**CONFIGS[name][1])
    p = MacroProblem(cfg, "cpu")
    steps, u, eps_p = _steps_torch(p, cfg)
    if distributed.is_primary():
        np.savez(os.path.join(out_dir, "fields.npz"), u=u, eps_p=eps_p)
        with open(os.path.join(out_dir, "steps.json"), "w") as f:
            json.dump(dict(steps=steps, procs=list(p.grid.procs), node_shape=p.node_shape), f)
    distributed.shutdown()


def _steps_jax(name):
    """The JAX package's N-device run of CONFIGS[name] (test_dist.py's
    pattern): per-step records, the unpadded u and the padded eps_p."""
    import jax
    import jax.numpy as jnp
    from macroc_tpu.config import MacroConfig
    from macroc_tpu.forces import per_rank_nonlinear_counts
    from macroc_tpu.parallel import make_grid_mesh, shard_problem_fields
    from macroc_tpu.problem import MacroProblem

    n, flags = CONFIGS[name]
    cfg = MacroConfig(**flags)
    p = MacroProblem(cfg, n_devices=n)
    u, state = shard_problem_fields(make_grid_mesh(p.grid), *p.init_fields())
    step = jax.jit(p.time_step)
    steps = []
    for ts in range(cfg.ts):
        u, state, d = step(u, state, jnp.asarray(cfg.displacement(ts), p.dtype))
        res = np.asarray(d.res_norms)
        nsol = int(d.n_solves)
        counts = per_rank_nonlinear_counts(np.asarray(d.non_linear), p.grid)
        steps.append(dict(res_norms=res[~np.isnan(res)].tolist(),
                          ksp_its=np.asarray(d.ksp_its)[:nsol].tolist(),
                          force=float(d.force), f_trial_max=float(d.f_trial_max),
                          nl_gps=int(counts.sum()), per_rank=counts.tolist(),
                          converged=bool(d.converged)))
    return dict(steps=steps, procs=list(p.grid.procs)), np.asarray(p.unpad_u(u)), \
        np.asarray(state.eps_p)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: (ranks, one_process, jax)}, each a (record, u, eps_p) triple,
    computed on first use."""
    from macroc_tpu_torch.config import MacroConfig
    from macroc_tpu_torch.problem import MacroProblem

    cache = {}

    def get(name):
        if name not in cache:
            n, flags = CONFIGS[name]
            out = tmp_path_factory.mktemp(name)
            launch_ranks(n, f"import test_torch_dist as t; t._rank_main({name!r}, {str(out)!r})")
            with open(out / "steps.json") as f:
                rec = json.load(f)
            f = np.load(out / "fields.npz")
            ranks = (rec, f["u"], f["eps_p"])
            cfg1 = MacroConfig(**{k: v for k, v in flags.items() if not k.startswith("procs")})
            steps1, u1, e1 = _steps_torch(MacroProblem(cfg1, "cpu"), cfg1)
            cache[name] = (ranks, (dict(steps=steps1), u1, e1), _steps_jax(name))
        return cache[name]

    return get


def _assert_exact(got, want):
    """Elastic steps: test_multiprocess.py's decomposition bounds."""
    assert len(got["steps"]) == len(want["steps"])
    for gs, ws in zip(got["steps"], want["steps"]):
        assert gs["ksp_its"] == ws["ksp_its"]
        assert gs["converged"] == ws["converged"] and gs["nl_gps"] == ws["nl_gps"] == 0
        assert np.allclose(gs["res_norms"], ws["res_norms"], rtol=1e-8, atol=1e-12)
        assert np.isclose(gs["force"], ws["force"], rtol=1e-8, atol=1e-12)


def _assert_roundoff(got, want):
    """Yielding steps: tests/test_torch_golden.py's roundoff bounds."""
    assert len(got["steps"]) == len(want["steps"])
    for gs, ws in zip(got["steps"], want["steps"]):
        assert len(gs["ksp_its"]) == len(ws["ksp_its"])
        assert gs["converged"] == ws["converged"] and gs["nl_gps"] == ws["nl_gps"]
        assert np.isclose(gs["res_norms"][0], ws["res_norms"][0], rtol=1e-7, atol=1e-12)
        assert all(abs(a - b) <= 6 for a, b in zip(gs["ksp_its"], ws["ksp_its"]))
        assert np.isclose(gs["force"], ws["force"], rtol=1e-5, atol=1e-12)
        assert np.isclose(gs["f_trial_max"], ws["f_trial_max"], rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("against", ["one_process", "jax"])
@pytest.mark.parametrize("name", ELASTIC)
def test_ranks_match_on_elastic_steps(runs, name, against):
    (rec, u, eps_p), one, jx = runs(name)
    ref_rec, ref_u, _ = one if against == "one_process" else jx
    assert rec["procs"] != [1, 1, 1]
    if name == "degenerate_5x3x3":
        assert rec["procs"] == [1, 2, 2]
    if name != "circle_5x3x3":
        assert sum(len(s["ksp_its"]) for s in rec["steps"]) >= 1, "no solve to compare"
    _assert_exact(rec, ref_rec)
    assert np.allclose(u, ref_u, rtol=0, atol=1e-8 * max(np.abs(ref_u).max(), 1e-300))
    if against == "jax":
        # the same decomposition, so the same padded state layout
        np.testing.assert_allclose(eps_p, jx[2], rtol=0, atol=1e-12)


@pytest.mark.parametrize("against", ["one_process", "jax"])
@pytest.mark.parametrize("name", YIELDING)
def test_ranks_match_on_yielding_steps(runs, name, against):
    (rec, u, _), one, jx = runs(name)
    ref_rec, ref_u, _ = one if against == "one_process" else jx
    assert all(s["nl_gps"] > 0 for s in ref_rec["steps"][1:]), "no GP yielded"
    _assert_roundoff(rec, ref_rec)
    assert np.allclose(u, ref_u, rtol=0, atol=1e-6 * np.abs(ref_u).max())
    assert [s["per_rank"] for s in rec["steps"]] == [s["per_rank"] for s in jx[0]["steps"]]


def test_one_rank_block_is_the_padded_box(runs):
    """The 5x3x3 grid on ranks (1,2,2) pads y and z to 4 nodes: the JAX
    package's padded layout, two node planes per rank."""
    rec = runs("degenerate_5x3x3")[0][0]
    assert rec["node_shape"] == [5, 4, 4]


def test_two_rank_cli_writes_once_from_rank_zero(runs, tmp_path):
    """``python -m macroc_tpu_torch`` as 2 ranks, each in its own working
    directory with the same relative -output_dir: rank 0 narrates and
    writes; rank 1 prints nothing and writes nothing; gauss_evolution.dat
    carries the JAX package's per-rank counts for the decomposition."""
    flags = ["-da_grid_x", "5", "-da_grid_y", "3", "-da_grid_z", "3", "-lx", "4", "-ly", "2",
             "-lz", "2", "-bc_type", "0", "-dtype", "float64", "-ts", "4", "-dt", "0.15",
             "-newton_max_its", "10", "-output_dir", "out"]
    dirs = [tmp_path / f"rank{r}" for r in range(2)]
    for d in dirs:
        d.mkdir()
    code = ("import sys; from macroc_tpu_torch import cli; "
            f"sys.exit(cli.main({flags!r}))")
    outs = launch_ranks(2, code, cwd=[str(d) for d in dirs])
    assert "STARTING CALCULATION" in outs[0] and "Number of CPUs     : 2" in outs[0]
    assert "NP_X : 2\tNP_Y : 1\tNP_Z : 1" in outs[0]
    assert "STARTING CALCULATION" not in outs[1] and "|RES|" not in outs[1]
    assert not (dirs[1] / "out").exists()
    rows = np.loadtxt(dirs[0] / "out" / "info.dat", ndmin=2)
    gauss = np.loadtxt(dirs[0] / "out" / "gauss_evolution.dat", ndmin=2)
    jx = runs("plastic_5x3x3")[2][0]
    assert rows.shape == (4, 6) and gauss.shape == (4, 3)
    np.testing.assert_array_equal(gauss[:, 1:], [s["per_rank"] for s in jx["steps"]])
    assert gauss[1:, 1:].min() > 0
    np.testing.assert_array_equal(rows[:, 5], [s["nl_gps"] for s in jx["steps"]])
    np.testing.assert_allclose(rows[:, 3], [s["force"] for s in jx["steps"]], rtol=1e-5)


def test_backend_rule(monkeypatch):
    """gloo on the CPU; NCCL when every rank has a card; gloo when ranks
    share cards; no card under MACROC_PLATFORM=cuda raises."""
    from macroc_tpu_torch.parallel import distributed

    assert distributed.backend_for("cpu", 4) == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.backend_for("cuda", 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert distributed.backend_for("cuda", 2) == "nccl"
    assert distributed.backend_for("cuda", 3) == "gloo"


def test_one_process_needs_no_environment(monkeypatch):
    """No MACROC_* variable: no process group, one rank, an identity Comm;
    a partial environment raises rather than running alone."""
    from macroc_tpu_torch.parallel import distributed

    for k in ("MACROC_COORDINATOR", "MACROC_NUM_PROCESSES", "MACROC_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.maybe_initialize() is False
    assert (distributed.world(), distributed.rank(), distributed.is_primary()) == (1, 0, True)
    comm = distributed.Comm("cpu")
    t = torch.tensor([1.5, -2.0])
    assert comm.sum(t) is t and comm.max(t) is t
    assert comm.shift(t, t, None, None)[0].abs().sum() == 0
    monkeypatch.setenv("MACROC_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="MACROC_COORDINATOR"):
        distributed.maybe_initialize()
