"""The torch port must not pull in jax, nor anything of the JAX package
``macroc_tpu``: it keeps its own copies of the host modules it needs.

Checked in a subprocess: this test process already imported jax and
``macroc_tpu`` through conftest.py and the other test files."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "macroc_tpu_torch",
    "macroc_tpu_torch.cli",
    "macroc_tpu_torch.driver",
    "macroc_tpu_torch.problem",
    "macroc_tpu_torch.constitutive.microfe",
    "macroc_tpu_torch.ops.assembly",
    "macroc_tpu_torch.ops.stencil_spmv",
    "macroc_tpu_torch.parallel.distributed",
    "macroc_tpu_torch.parallel.halo",
    "macroc_tpu_torch.parallel.mesh",
    "macroc_tpu_torch.solve.mg",
    "macroc_tpu_torch.solve.gmres",
    "macroc_tpu_torch.utils.checkpoint",
    "macroc_tpu_torch.utils.profiling",
]


def _run(code):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def test_import_leaves_jax_out():
    _run(
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
        "assert not bad, bad\n"
    )


def test_import_leaves_the_jax_package_out():
    """Every module of the port imported (``__main__`` aside: it runs the
    CLI): no ``macroc_tpu`` module is loaded."""
    out = _run(
        "import importlib, pkgutil, sys\n"
        "import macroc_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')\n"
        "         if not m.name.endswith('__main__')]\n"
        "for m in names: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'macroc_tpu' or m.startswith('macroc_tpu.'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    assert int(out.split()[-1]) >= 30


def test_bench_entry_points_leave_jax_and_the_jax_package_out():
    """bench_torch.py and scripts/profile_newton_torch.py imported as
    modules: neither jax nor ``macroc_tpu`` is loaded."""
    _run(
        "import sys\n"
        "import bench_torch\n"
        "from macroc_tpu_torch.utils.profiling import load_script\n"
        "load_script('profile_newton_torch')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'macroc_tpu'))\n"
        "assert not bad, bad\n"
    )


# the port's scripts, each the counterpart of the JAX script of its name
# without ``_torch``
SCRIPTS = ["profile_newton_torch.py", "tune_microfe_torch.py", "_pancake_mg_check_torch.py",
           "bisect_newton_torch.py", "scaling_sweep_torch.py"]


@pytest.mark.parametrize("script", SCRIPTS)
def test_scripts_leave_jax_and_the_jax_package_out(script):
    """Each of the port's scripts imported as a module, its functions'
    imports included: neither jax nor ``macroc_tpu`` is loaded."""
    _run(
        "import importlib.util, sys\n"
        f"path = {os.path.join(REPO, 'scripts', script)!r}\n"
        "spec = importlib.util.spec_from_file_location('s', path)\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "import bench_torch, macroc_tpu_torch.cli, macroc_tpu_torch.parallel.launch\n"
        "import macroc_tpu_torch.problem, macroc_tpu_torch.solve.mg\n"
        "assert callable(mod.main)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'macroc_tpu'))\n"
        "assert not bad, bad\n"
    )


def _sources():
    root = Path(REPO)
    return sorted((root / "macroc_tpu_torch").rglob("*.py")) + [
        root / "chip_smoke.py", root / "bench_torch.py"] + [root / "scripts" / s for s in SCRIPTS]


def _jax_package_imports(path):
    """(line, text) of every import of ``macroc_tpu`` or a module under it."""
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [(node.lineno, n) for n in names
                if n == "macroc_tpu" or n.startswith("macroc_tpu.")]
    return bad


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_source_imports_the_jax_package(path):
    """No ``import macroc_tpu[...]`` or ``from macroc_tpu[.x] import`` in
    the port's sources, chip_smoke.py or its bench entry points, at any
    depth of the file."""
    assert not _jax_package_imports(path)


def test_the_import_scan_finds_an_import(tmp_path):
    src = tmp_path / "probe.py"
    src.write_text("import macroc_tpu_torch\nif 1:\n    from macroc_tpu.grid import make_grid\n"
                   "import macroc_tpu.io as io\n")
    assert sorted(_jax_package_imports(src)) == [(3, "macroc_tpu.grid"), (4, "macroc_tpu.io")]
