"""The torch port must not pull in jax.

Checked in a subprocess: this test process already imported jax through
conftest.py."""

import os
import subprocess
import sys

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
    "macroc_tpu_torch.solve.mg",
    "macroc_tpu_torch.solve.gmres",
    "macroc_tpu_torch.utils.checkpoint",
    "macroc_tpu_torch.utils.profiling",
]


def test_import_leaves_jax_out():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
