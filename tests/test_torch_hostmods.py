"""The port's copies of the JAX package's host modules (``config``,
``grid``, ``io``) against the originals: the same flags parse to the same
config, the same config gives the same grid, and the writers write the
same bytes."""

import dataclasses
import os
import shlex
from pathlib import Path

import numpy as np
import pytest

from macroc_tpu import config as jcfg
from macroc_tpu import grid as jgrid
from macroc_tpu import io as jio
from macroc_tpu_torch import config as tcfg
from macroc_tpu_torch import grid as tgrid
from macroc_tpu_torch import io as tio

REPO = Path(__file__).resolve().parents[1]


def _production_flags():
    """The flags of scripts/production_run.sh's ``exec python -m`` line."""
    text = (REPO / "scripts" / "production_run.sh").read_text()
    cmd = text[text.index("exec python -m macroc_tpu"):].replace("\\\n", " ")
    return [t for t in shlex.split(cmd.splitlines()[0])[3:] if t != "$@"]


ARGV = {
    "defaults": [],
    "production_run": _production_flags(),
    "fe2_golden": ("-da_grid_x 3 -da_grid_y 2 -da_grid_z 2 -lx 2 -ly 1 -lz 1 -bc_type 0 "
                   "-ts 2 -dt 0.1 -micro_n 4 -micro_type 1 -micro_mat_2 1e6,0.3,5e3,2e6 "
                   "-dtype float64").split(),
    "gmres": "-da_grid_x 9 -da_grid_y 3 -da_grid_z 9 -ksp_type gmres -ksp_monitor".split(),
    "matfree": "-operator matfree -pc_type jacobi -micro_elastic_fastpath 0 -resume".split(),
    "mg_dtype": ("-mg_dtype bfloat16 -pc_type mg -dtype float32 -micro_params 0.3,0.1 "
                 "-log_phases -ref_b_quirk false -unknown_flag 3").split(),
}


@pytest.mark.parametrize("name", list(ARGV))
def test_parse_cli_matches(name):
    argv = ARGV[name]
    a, b = tcfg.parse_cli(argv), jcfg.parse_cli(argv)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for t in range(3):
        assert a.displacement(t) == b.displacement(t)
    assert (a.dx, a.dy, a.dz, a.wg) == (b.dx, b.dy, b.dz, b.wg)
    if name == "production_run":
        assert (a.nx, a.ny, a.nz, a.ts, a.checkpoint_freq) == (50, 3, 50, 10000, 500)


GRIDS = [
    (dict(nx=5, ny=3, nz=3), 1),
    (dict(nx=50, ny=3, nz=50, lx=50.0, ly=1.0, lz=50.0), 4),
    (dict(nx=17, ny=9, nz=33), 8),
    (dict(nx=9, ny=3, nz=9, procs_x=2, procs_y=1), 2),
]


@pytest.mark.parametrize("kw,n_dev", GRIDS, ids=lambda v: str(v))
def test_make_grid_matches(kw, n_dev):
    a = tgrid.make_grid(tcfg.MacroConfig(**kw), n_dev)
    b = jgrid.make_grid(jcfg.MacroConfig(**kw), n_dev)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert (a.spacing, a.wg, a.nnodes, a.nelem_global) == (b.spacing, b.wg, b.nnodes,
                                                           b.nelem_global)
    for r in range(a.nproc):
        assert dataclasses.asdict(a.local_box(r)) == dataclasses.asdict(b.local_box(r))
    assert a.load_imbalance() == b.load_imbalance()


def _tree(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(Path(root).rglob("*")) if p.is_file()}


def _write_dat(io, out):
    with io.InfoWriter(os.path.join(out, "info.dat")) as w:
        for t in range(3):
            w.write_row(t, 0.1 * t, -0.001 * t, 123.4 / (t + 1), 5.6e3 * t, 7 * t)
    with io.InfoWriter(os.path.join(out, "info.dat"), append=True) as w:
        w.write_row(3, 0.3, -0.003, -1.5e-9, 0.0, 0)
    with io.GaussEvolutionWriter(os.path.join(out, "gauss_evolution.dat")) as w:
        w.write_row(0, [1, 2, 3, 4])
        w.write_row(1, [0])


def _write_vtu(io, grid_mod, out, encoding, reduced):
    grid = grid_mod.StructuredGrid3D(5, 3, 4, 4.0, 2.0, 3.0, procs=(2, 1, 1))
    rng = np.random.default_rng(11)
    ne = (4, 2, 3)
    u = rng.normal(size=(5, 3, 4, 3))
    stress = rng.normal(size=ne + (8, 6))
    strain = rng.normal(size=ne + (8, 6)) * 1e-3
    nl = rng.integers(0, 2, size=ne + (8,)).astype(bool)
    cost = rng.uniform(size=ne + (8,)) * 20
    if reduced:
        stress, strain = stress.sum(axis=3) * grid.wg, strain.sum(axis=3) * grid.wg
        nl, cost = nl.astype(np.int64).sum(axis=3), cost.sum(axis=3) / 8.0
    io.write_pvtu("solution_2", grid, u, stress, strain, nl, cost, grid.wg,
                  outdir=out, encoding=encoding, reduced=reduced)


WRITERS = ["dat"] + [f"vtu_{e}{'_reduced' if r else ''}"
                     for e in ("ascii", "binary", "appended") for r in (False, True)]


@pytest.mark.parametrize("case", WRITERS)
def test_writers_write_identical_bytes(case, tmp_path):
    files = {}
    for tag, io, grid_mod in (("port", tio, tgrid), ("jax", jio, jgrid)):
        out = str(tmp_path / tag)
        os.makedirs(out)
        if case == "dat":
            _write_dat(io, out)
        else:
            enc = case.split("_")[1]
            _write_vtu(io, grid_mod, out, enc, case.endswith("_reduced"))
        files[tag] = _tree(out)
    assert files["port"] and files["port"] == files["jax"]
    want = {"info.dat", "gauss_evolution.dat"} if case == "dat" else {
        "solution_2.pvtu", "solution_2-subdo-0.vtu", "solution_2-subdo-1.vtu"}
    assert set(files["port"]) == want


def _script_lines(name):
    """The lines of scripts/``name`` from ``set -euo pipefail`` on, comments
    dropped."""
    text = (REPO / "scripts" / name).read_text()
    body = text[text.index("set -euo pipefail"):]
    return [l.split("#")[0].rstrip() for l in body.splitlines()]


@pytest.mark.parametrize("name", ["production_run", "pod_run"])
def test_launch_scripts_have_the_jax_scripts_lines(name):
    """scripts/<name>_torch.sh runs the port with the JAX script's flags and
    MACROC_* handling: its lines are the JAX script's but for the module."""
    port = _script_lines(f"{name}_torch.sh")
    assert "exec python -m macroc_tpu_torch \\" in port
    jax = _script_lines(f"{name}.sh")
    assert [l.replace("macroc_tpu_torch", "macroc_tpu") for l in port] == jax


@pytest.mark.parametrize("name,env,flags", [
    ("production_run", {}, "-da_grid_x 5 -da_grid_z 5 -ts 2 -checkpoint_freq 1"),
    ("pod_run", {"MACROC_GRID": "5", "MACROC_TS": "2"}, ""),
])
def test_launch_scripts_run_on_the_cpu(name, env, flags, tmp_path):
    """Each launch script run as written on a small grid (later flags
    override its own), MACROC_PLATFORM=cpu: the port's CLI writes info.dat
    rows for every step (and the checkpoints production_run asks for)."""
    import subprocess
    import sys

    argv = ["bash", str(REPO / "scripts" / f"{name}_torch.sh")] + flags.split() + [
        "-output_dir", str(tmp_path), "-checkpoint_dir", str(tmp_path / "ck")]
    e = dict(os.environ, MACROC_PLATFORM="cpu", OMP_NUM_THREADS="1", **env)
    e["PATH"] = os.path.dirname(sys.executable) + os.pathsep + e.get("PATH", "")
    r = subprocess.run(argv, env=e, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert len((tmp_path / "info.dat").read_text().splitlines()) == 2
    if name == "production_run":
        assert sorted(os.listdir(tmp_path / "ck")) == ["step_1", "step_2"]
