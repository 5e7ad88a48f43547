"""End-to-end CLI of the torch port: ``python -m macroc_tpu_torch`` on the
CPU (MACROC_PLATFORM=cpu) against ``python -m macroc_tpu`` at float64 on
one CTest grid, with CG, GMRES and the matrix-free operator, and on the FE²
golden's launch line (tests/test_cli.py is the model); the flags the port
accepts, on one process and under more than one rank."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from macroc_tpu_torch import cli

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FLAGS = [
    "-da_grid_x", "5", "-da_grid_y", "3", "-da_grid_z", "3",
    "-dt", "0.002", "-dtype", "float64", "-bc_type", "0", "-ts", "3",
    "-vtu_freq", "2",
]


# the hetero_micro_fe2_3x2x2 golden (tests/make_goldens.py): -micro_mat_2
# differs from mat_1 on a layered RVE, so "auto" routes to micro-FE
FE2_FLAGS = [
    "-da_grid_x", "3", "-da_grid_y", "2", "-da_grid_z", "2", "-lx", "2",
    "-ly", "1", "-lz", "1", "-bc_type", "0", "-ts", "2", "-dt", "0.1",
    "-newton_max_its", "5", "-micro_n", "4", "-micro_type", "1",
    "-micro_mat_2", "1e6,0.3,5e3,2e6", "-dtype", "float64",
]


def _run(package, outdir, extra=(), check=True, flags=FLAGS):
    env = dict(os.environ, MACROC_PLATFORM="cpu", XLA_FLAGS="",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, "-m", package, *flags, "-output_dir", str(outdir), *extra],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=600,
    )
    if check:
        assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    return r


def test_cli_matches_jax_cli(tmp_path):
    port, ref = tmp_path / "port", tmp_path / "ref"
    out = _run("macroc_tpu_torch", port, ["-log_phases"]).stdout
    _run("macroc_tpu", ref)
    assert "Boundary Condition : BC_BENDING" in out
    assert "Time Step = 2" in out and "|RES| =" in out and "KSP :" in out
    assert "FINISHING CALCULATION" in out and "ksp_solve" in out
    for name in ("info.dat", "gauss_evolution.dat"):
        assert (port / name).read_text() == (ref / name).read_text(), name
    for s in (0, 2):
        assert (port / f"solution_{s}.pvtu").read_text() == (
            ref / f"solution_{s}.pvtu"
        ).read_text()
        assert (port / f"solution_{s}-subdo-0.vtu").exists()
    assert not (port / "solution_1.pvtu").exists()


def test_fe2_launch_line_matches_jax_cli(tmp_path):
    """A -micro_mat_2 launch line runs the micro-FE engine; info.dat and
    gauss_evolution.dat equal the JAX CLI's (the golden survives summation
    order: tests/test_torch_golden.py)."""
    port, ref = tmp_path / "port", tmp_path / "ref"
    out = _run("macroc_tpu_torch", port, ["-log_phases"], flags=FE2_FLAGS).stdout
    _run("macroc_tpu", ref, flags=FE2_FLAGS)
    assert "Time Step = 1" in out and "homogenize" in out and "WARNING" not in out
    assert "Non-Linear Gauss points : 16" in out
    for name in ("info.dat", "gauss_evolution.dat"):
        assert (port / name).read_text() == (ref / name).read_text(), name


def test_micro_flags_reach_the_engine():
    """Every -micro_* flag macroc_tpu.config parses arrives in the engine."""
    from macroc_tpu_torch.constitutive.microfe import MicroFEEngine
    from macroc_tpu_torch.problem import MacroProblem

    cfg = cli.parse_cli([
        "-da_grid_x", "3", "-da_grid_y", "2", "-da_grid_z", "2", "-dtype", "float64",
        "-micro_n", "3", "-micro_type", "0", "-micro_mat_1", "2e7,0.2,2e4,3e6",
        "-micro_mat_2", "1e6,0.3,5e3,2e6", "-micro_params", "1,1,1,0.4",
        "-micro_elastic_fastpath", "0", "-micro_precond", "jacobi",
        "-micro_active_chunk", "7",
    ])
    eng = MacroProblem(cfg, "cpu").engine
    assert isinstance(eng, MicroFEEngine)
    assert (eng.n, eng.micro_type, eng.params) == (3, 0, (1.0, 1.0, 1.0, 0.4))
    assert (eng.mat1.E, eng.mat1.nu, eng.mat1.Sy, eng.mat1.Ka) == (2e7, 0.2, 2e4, 3e6)
    assert (eng.mat2.E, eng.mat2.nu, eng.mat2.Sy, eng.mat2.Ka) == (1e6, 0.3, 5e3, 2e6)
    assert not eng.elastic_fastpath and eng.precond == "jacobi"
    assert eng.active_chunk == 7 and eng.dtype == torch.float64


def test_cli_rejects_unported_flags(tmp_path):
    """One process asked for two ranks along x: the grid's own ValueError,
    as ``make_grid`` raises in both packages."""
    r = _run("macroc_tpu_torch", tmp_path, ["-da_processors_x", "2"], check=False)
    assert r.returncode != 0
    assert "ValueError: cannot decompose grid 5x3x3 over 1 devices" in r.stderr


def test_one_process_with_a_pinned_rank_grid_raises(monkeypatch):
    monkeypatch.setenv("MACROC_PLATFORM", "cpu")
    with pytest.raises(ValueError, match="processor grid 2x1x1 != device count 1"):
        cli.run(FLAGS + ["-da_processors_x", "2", "-da_processors_y", "1",
                         "-da_processors_z", "1"])


@pytest.mark.parametrize("flags,named", [
    (["-pc_type", "mg"], "-pc_type mg"),
    # 17x17x3: two deep dims, so auto resolves to MG
    (["-da_grid_x", "17", "-da_grid_z", "17"], "-pc_type auto (MG)"),
    (["-operator", "matfree"], "-operator matfree"),
    (FE2_FLAGS[-8:-2], "micro-FE"),
    (["-vtu_freq", "1"], "-vtu_freq"),
    (["-checkpoint_freq", "2"], "-checkpoint_freq"),
    (["-resume"], "-resume"),
    # 17x3x17 on ranks (1,2,1): MG splits the pancake's line dimension
    (["-da_grid_x", "17", "-da_grid_z", "17", "-da_processors_x", "1", "-da_processors_y",
      "2", "-da_processors_z", "1"], "-da_processors_y 2 (MG, split line)"),
])
def test_unsupported_flags_named(flags, named):
    """MG, the matrix-free operator, micro-FE, VTU output, checkpoints and
    resume, and MG on a split line dimension, which the port once refused
    under more than one rank: under 2 ranks both packages parse the same
    config, decompose it alike and resolve the same solver plan on the
    padded node box (tests/test_torch_dist_*.py run them)."""
    from macroc_tpu import config as jconfig
    from macroc_tpu.grid import make_grid as jmake_grid
    from macroc_tpu.problem import resolve_solver_plan
    from macroc_tpu_torch.grid import make_grid
    from macroc_tpu_torch.parallel.mesh import padded_node_shape
    from macroc_tpu_torch.problem import resolve_solver_plan_torch

    argv = ["-da_grid_x", "5", "-da_grid_y", "3", "-da_grid_z", "3"] + flags
    cfg, jcfg = cli.parse_cli(argv), jconfig.parse_cli(argv)
    assert repr(cfg) == repr(jcfg), named
    grid, jgrid = make_grid(cfg, 2), jmake_grid(jcfg, 2)
    assert grid.procs == jgrid.procs and grid.procs[0] * grid.procs[1] * grid.procs[2] == 2
    shape = padded_node_shape(grid)
    plan = resolve_solver_plan_torch(cfg, shape, "cpu")
    assert plan["pc_type"] == resolve_solver_plan(jcfg, shape, grid.procs, "cpu")["pc_type"]


def test_unsupported_raises_before_the_run(tmp_path, monkeypatch):
    """The line the port once refused before the run, MG on 17x3x17 with
    -da_processors_y 2 (the rank grid splits the pancake hierarchy's line
    dimension), runs as 2 ranks of ``python -m macroc_tpu_torch``: every
    step converges, rank 0 writes info.dat and the PVTU masters, and the
    forces agree with one process within tests/test_dist.py's bounds for a
    padded box (1e-4)."""
    from test_torch_halo import launch_ranks

    # tests/test_torch_dist_mg_pancake.py's 17x3x17 pancake (elastic)
    flags = ["-da_grid_x", "17", "-da_grid_y", "3", "-da_grid_z", "17", "-lx", "10", "-ly", "1",
             "-lz", "10", "-dt", "0.001", "-dtype", "float64", "-bc_type", "0", "-ts", "3",
             "-vtu_freq", "2", "-pc_type", "mg"]
    split = ["-da_processors_x", "1", "-da_processors_y", "2", "-da_processors_z", "1"]
    code = ("import sys; from macroc_tpu_torch import cli; "
            f"sys.exit(cli.main({flags + split + ['-output_dir', str(tmp_path / 'two')]!r}))")
    outs = launch_ranks(2, code)
    assert "NP_X : 1\tNP_Y : 2\tNP_Z : 1" in outs[0] and "Time Step = 2" in outs[0]
    its = [int(l.split("Its = ")[1]) for l in outs[0].splitlines() if l.startswith("KSP :")]
    assert len(its) == 2 and max(its) <= 25
    monkeypatch.setenv("MACROC_PLATFORM", "cpu")
    one = cli.run(flags + ["-output_dir", str(tmp_path / "one")])
    assert all(h["converged"] for h in one["history"])
    rows = [np.loadtxt(tmp_path / d / "info.dat", ndmin=2) for d in ("two", "one")]
    assert rows[0].shape == rows[1].shape == (3, 6)
    np.testing.assert_allclose(rows[0][:, 3], rows[1][:, 3], rtol=1e-4)
    assert sorted(f.name for f in (tmp_path / "two").glob("*.pvtu")) == [
        "solution_0.pvtu", "solution_2.pvtu"]


@pytest.mark.parametrize("flags", [
    ["-resume"], ["-checkpoint_freq", "2"], ["-profile_dir", "{tmp}/prof"],
    ["-mg_dtype", "bfloat16", "-pc_type", "mg"], ["-operator", "matfree"],
])
def test_flags_now_accepted(tmp_path, monkeypatch, flags):
    """The flags the port used to refuse run through the CLI: a 3-step
    bending line with the flag converges every step."""
    flags = [f.replace("{tmp}", str(tmp_path)) for f in flags]
    argv = FLAGS[:-2] + ["-output_dir", str(tmp_path / "out"),
                         "-checkpoint_dir", str(tmp_path / "ck")] + flags
    monkeypatch.setenv("MACROC_PLATFORM", "cpu")
    result = cli.run(argv)
    assert [h["ts"] for h in result["history"]] == [0, 1, 2]
    assert all(h["converged"] for h in result["history"])


def test_profile_dir_writes_a_trace(tmp_path):
    prof = tmp_path / "prof"
    _run("macroc_tpu_torch", tmp_path, ["-profile_dir", str(prof)])
    traces = list(prof.glob("trace_*.json"))
    assert len(traces) == 1
    text = traces[0].read_text()
    assert '"traceEvents"' in text and "aten::" in text


@pytest.mark.parametrize("extra", [["-ksp_type", "gmres"], ["-operator", "matfree"],
                                   ["-ksp_type", "gmres", "-operator", "matfree"]])
def test_solver_flags_match_jax_cli(tmp_path, extra):
    """GMRES and the matrix-free operator through both CLIs, with the KSP
    monitor and reasons: the same KSP lines and info.dat."""
    port, ref = tmp_path / "port", tmp_path / "ref"
    extra = extra + ["-ksp_monitor", "-ksp_converged_reason"]
    out_p = _run("macroc_tpu_torch", port, extra).stdout
    out_r = _run("macroc_tpu", ref, extra).stdout

    def ksp(out):
        lines = out.splitlines()
        its = [l.split("Its = ")[1] for l in lines if l.startswith("KSP :")]
        reasons = [l for l in lines if l.startswith("Linear solve")]
        monitor = [float(l.split()[-1]) for l in lines if "KSP Residual norm" in l]
        return its, reasons, np.array(monitor)

    its_p, reasons_p, mon_p = ksp(out_p)
    its_r, reasons_r, mon_r = ksp(out_r)
    assert its_p == its_r and reasons_p == reasons_r and len(its_p) >= 2
    assert "CONVERGED_RTOL" in reasons_p[0]
    assert mon_p.shape == mon_r.shape == (sum(map(int, its_p)) + len(its_p),)
    assert np.allclose(mon_p, mon_r, rtol=1e-6, atol=1e-10 * mon_r.max())
    for name in ("info.dat", "gauss_evolution.dat"):
        assert (port / name).read_text() == (ref / name).read_text(), name


def test_cuda_default_raises_without_a_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.delenv("MACROC_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.device_from_env()


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_card_or_repo(tmp_path, alone):
    """chip_smoke.py must fail, printing no result line, without a CUDA
    device and when copied out of the repo on its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        cwd = str(tmp_path)
        script = str(tmp_path / "chip_smoke.py")
        with open(os.path.join(REPO, "chip_smoke.py")) as f:
            (tmp_path / "chip_smoke.py").write_text(f.read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, script], capture_output=True, text=True,
                       env=env, cwd=cwd, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
