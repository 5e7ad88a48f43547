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

import numpy as np
import pytest
import torch

import _torch_dist_common as common
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: (ranks, one_process, jax)}, each a (record, u, eps_p) triple,
    computed on first use (tests/_torch_dist_common.py)."""
    return common.runner(__name__, tmp_path_factory)


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
    common.assert_exact(rec, ref_rec)
    common.assert_exact_u(u, ref_u)
    if against == "jax":
        # the same decomposition, so the same padded state layout
        np.testing.assert_allclose(eps_p, jx[2], rtol=0, atol=1e-12)


@pytest.mark.parametrize("against", ["one_process", "jax"])
@pytest.mark.parametrize("name", YIELDING)
def test_ranks_match_on_yielding_steps(runs, name, against):
    (rec, u, _), one, jx = runs(name)
    ref_rec, ref_u, _ = one if against == "one_process" else jx
    assert all(s["nl_gps"] > 0 for s in ref_rec["steps"][1:]), "no GP yielded"
    common.assert_roundoff(rec, ref_rec)
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
