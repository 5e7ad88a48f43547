"""End-to-end CLI of the torch port: ``python -m macroc_tpu_torch`` on the
CPU (MACROC_PLATFORM=cpu) against ``python -m macroc_tpu`` on one CTest
grid at float64 (tests/test_cli.py is the model)."""

import os
import subprocess
import sys

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


def _run(package, outdir, extra=(), check=True):
    env = dict(os.environ, MACROC_PLATFORM="cpu", XLA_FLAGS="",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, "-m", package, *FLAGS, "-output_dir", str(outdir), *extra],
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


def test_cli_rejects_unported_flags(tmp_path):
    r = _run("macroc_tpu_torch", tmp_path, ["-ksp_type", "gmres"], check=False)
    assert r.returncode != 0
    assert "NotImplementedError" in r.stderr and "gmres" in r.stderr


@pytest.mark.parametrize("flags,named", [
    (["-da_processors_x", "2"], "-da_processors_*"), (["-resume"], "-resume"),
    (["-checkpoint_freq", "2"], "-checkpoint_freq"), (["-profile_dir", "p"], "-profile_dir"),
    (["-mg_dtype", "bfloat16"], "-mg_dtype"), (["-operator", "matfree"], "-operator"),
])
def test_unsupported_flags_named(flags, named):
    missing = cli.unsupported(cli.parse_cli(flags))
    assert len(missing) == 1 and missing[0].startswith(named)


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
