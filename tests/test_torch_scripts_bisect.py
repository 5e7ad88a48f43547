"""scripts/bisect_newton_torch.py on the CPU: at n=9 every assembly form
(the CPU's slab and plain forms, K2's and the two-stage path's plain
versions) agrees with the plain form within 1e-12 at float64, and
``fused_step(coarse_direct)`` for True and False gives the KSP its of the
JAX package's ``scripts/bisect_newton.py::fused_step`` (assembly
``slab``) at n=9, both run as their scripts run them (float32).  And the
script's exit code: 1 when a part fails, 0 otherwise."""

import json

import pytest
import torch

import _torch_scripts_common as common
from macroc_tpu_torch.utils.profiling import Timings

torch.set_num_threads(1)

bisect = common.load_script("bisect_newton_torch")

N = 9
# the JAX script's fused_step as it runs it (its module calls
# setup_runtime on import; the compile cache stays off as in the head)
JAX_PROGRAM = f"N = {N}\n" + r"""
import importlib.util
spec = importlib.util.spec_from_file_location("bisect_newton", "scripts/bisect_newton.py")
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
jax.config.update("jax_enable_compilation_cache", False)
cd = sys.argv[1] == "1"
print("JAX " + json.dumps({f"cd{int(cd)}": mod.fused_step("slab", cd, n=N)}), flush=True)
"""


@pytest.fixture(scope="module", autouse=True)
def jax_side():
    runs = common.JaxRuns(JAX_PROGRAM, ["1", "0"])
    yield runs.get
    runs.close()


def test_assembly_forms_agree():
    r = bisect.standalone_assembly(n=N, dtype=torch.float64, device="cpu",
                                   timings=Timings("cpu", reps=1))
    assert list(r["ms"]) == list(r["rel_dev"]) == ["fused", "two_stage", "slab", "plain"]
    assert all(v <= 1e-12 for v in r["rel_dev"].values())
    assert r["rel_dev"]["slab"] > 0 and all(v > 0 for v in r["ms"].values())


@pytest.mark.parametrize("coarse_direct", [True, False])
def test_fused_step_matches_the_jax_script(jax_side, coarse_direct):
    r = bisect.fused_step(coarse_direct, n=N, device="cpu", timings=Timings("cpu", reps=1))
    want = jax_side(f"cd{int(coarse_direct)}")
    assert r["ksp_its"] == want["ksp_its"]
    assert 0 < r["step_min_s"] <= r["step_s"]


@pytest.mark.parametrize("fail", [False, True])
def test_main_exits_non_zero_on_a_failed_part(monkeypatch, tmp_path, capsys, fail):
    fused_step = bisect.fused_step

    def step(cd, *a, **kw):
        if fail and not cd:
            raise RuntimeError("made to fail")
        return fused_step(cd, *a, **kw)

    monkeypatch.setattr(bisect, "fused_step", step)
    monkeypatch.setenv("MACROC_PLATFORM", "cpu")
    out = tmp_path / "bisect.json"
    monkeypatch.setattr(bisect, "N", 5)
    code = bisect.main(["--out", str(out)])
    printed = capsys.readouterr().out
    result = json.loads(out.read_text())
    assert code == int(fail)
    assert result["failures"] == (["step_cd0"] if fail else [])
    assert set(result["assembly"]["ms"]) == {"fused", "two_stage", "slab", "plain"}
    assert ("step_cd0" in result) != fail and "step_cd1" in result
    assert ("step_cd0: FAILED" in printed) == fail
    assert "the port ignores -assembly" in printed
