"""Shared machinery of the tests/test_torch_scripts_*.py files: the port's
scripts loaded as modules, and the JAX side of a comparison run in
subprocesses (each group of a test module's JAX program in its own
process, started with the module's first test so that the XLA compiles
overlap the port's side; each prints one ``JAX <json>`` line)."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from macroc_tpu_torch.utils.profiling import load_script  # noqa: E402,F401

JAX_TIMEOUT_S = 300
# the head of every JAX program: the CPU, float64 available, no persistent
# compile cache (as conftest.py sets for the test process)
JAX_HEAD = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
from macroc_tpu.utils.cache import setup_runtime
setup_runtime()
jax.config.update("jax_enable_compilation_cache", False)
import jax.numpy as jnp
import numpy as np
"""


class JaxRuns:
    """``python -c JAX_HEAD + program group`` for each group, started now;
    ``get(key)`` waits for all of them at its first call and returns the
    key of the merged ``JAX`` records."""

    def __init__(self, program, groups):
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        self.groups = groups
        self.procs = [subprocess.Popen([sys.executable, "-c", JAX_HEAD + program, g],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True, env=env, cwd=REPO) for g in groups]
        self.results = {}

    def get(self, key):
        if not self.results:
            for g, p in zip(self.groups, self.procs):
                out = p.communicate(timeout=JAX_TIMEOUT_S)[0]
                lines = [l for l in out.splitlines() if l.startswith("JAX ")]
                assert p.returncode == 0 and lines, f"JAX side {g} failed:\n{out[-4000:]}"
                self.results.update(json.loads(lines[-1][4:]))
        return self.results[key]

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def rel(got, want):
    """Largest deviation relative to the largest entry of ``want``."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300))
