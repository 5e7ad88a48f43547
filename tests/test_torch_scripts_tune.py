"""scripts/tune_microfe_torch.py against the JAX package's micro-FE engine
(the engine scripts/tune_microfe.py times), on the CPU at float64:
``rate``'s stresses for each (precond, gp_chunk) and on the elastic fast
path for two screen_chunk values, at micro_n=2 on 64 GPs, within 1e-10 of
the jitted JAX ``MicroFEEngine.homogenize`` on the same numpy-seeded
strains and settings, also on the draw with every 10th strain driven past
yield (``--driven-every 10``: the fast path then solves those in full) (the micro CG tolerance lets another summation order
move the last bits: tests/test_torch_microfe.py's bound); the same count
of micro solves at the Newton cap.  And the script's exit code: 1 when a
configuration fails, 0 otherwise."""

import json

import numpy as np
import pytest
import torch

import _torch_scripts_common as common
from macroc_tpu_torch.utils.profiling import Timings

torch.set_num_threads(1)

tune = common.load_script("tune_microfe_torch")

N_GPS, MICRO_N = 64, 2
CONFIGS = {
    "jacobi_16": dict(precond="jacobi", chunk=16),
    "jacobi_32": dict(precond="jacobi", chunk=32),
    "dense_elastic_16": dict(precond="dense_elastic", chunk=16),
    "dense_elastic_32": dict(precond="dense_elastic", chunk=32),
    "fastpath_16": dict(fastpath=True, screen_chunk=16),
    "fastpath_32": dict(fastpath=True, screen_chunk=32),
}
# the same engines on the driven draw (every 10th strain 600x)
DRIVEN = {
    "driven_dense_elastic_16": dict(precond="dense_elastic", chunk=16),
    "driven_fastpath_16": dict(fastpath=True, screen_chunk=16),
    "driven_fastpath_32": dict(fastpath=True, screen_chunk=32),
}
JAX_PROGRAM = f"CONFIGS = {dict(CONFIGS, **DRIVEN)!r}\n" + r"""
from macroc_tpu.config import MIC_LAYER_Y, MaterialParams
from macroc_tpu.constitutive.microfe import MicroFEEngine

draw = np.random.default_rng(3).standard_normal((64, 6)) * 1e-4
driven = draw.copy()
driven[::10] *= 600.0
out = {}
for key in sys.argv[1].split(","):
    eps = jnp.asarray(driven if key.startswith("driven_") else draw)
    c = {**dict(precond="auto", chunk=0, fastpath=False, screen_chunk=0), **CONFIGS[key]}
    eng = MicroFEEngine(n=2, micro_type=MIC_LAYER_Y, mat1=MaterialParams(),
                        mat2=MaterialParams(E=1.0e6, nu=0.3, Sy=1.0e4, Ka=1.0e7),
                        dtype=jnp.float64, elastic_fastpath=c["fastpath"],
                        precond=c["precond"], gp_chunk=c["chunk"],
                        screen_chunk=c["screen_chunk"])
    r = jax.jit(eng.homogenize)(eps, eng.init_state((64,)))
    out[key] = dict(stress=np.asarray(r.stress).tolist(), capped=int(jnp.sum(r.unconverged)))
print("JAX " + json.dumps(out), flush=True)
"""
GROUPS = ("jacobi_16,dense_elastic_32,fastpath_16,driven_fastpath_32",
          "jacobi_32,dense_elastic_16,fastpath_32", "driven_dense_elastic_16,driven_fastpath_16")


@pytest.fixture(scope="module", autouse=True)
def jax_side():
    runs = common.JaxRuns(JAX_PROGRAM, GROUPS)
    yield runs.get
    runs.close()


@pytest.mark.parametrize("driven_every", [0, 10])
def test_the_strains_are_the_seeded_draw(driven_every):
    eps = tune.strains(N_GPS, driven_every)
    want = np.random.default_rng(3).standard_normal((N_GPS, 6)) * 1e-4
    if driven_every:
        want[::10] *= 600.0
    assert np.array_equal(eps, want)


@pytest.mark.parametrize("key", list(CONFIGS) + list(DRIVEN))
def test_rate_matches_the_jax_engine(jax_side, key):
    config = CONFIGS.get(key) or DRIVEN[key]
    eps = tune.strains(N_GPS, 10 if key in DRIVEN else 0)
    r = tune.rate(**config, micro_n=MICRO_N, dtype=torch.float64, eps=eps, device="cpu",
                  timings=Timings("cpu", reps=1))
    want = jax_side(key)
    assert common.rel(r["stress"], want["stress"]) < 1e-10
    assert r["capped"] == want["capped"]
    assert r["gp_per_s"] > 0


@pytest.mark.parametrize("fail", [False, True])
def test_main_exits_non_zero_on_a_failed_configuration(monkeypatch, tmp_path, capsys, fail):
    rate = tune.rate

    def failing(**kw):
        if fail and tune.label(**{k: kw[k] for k in ("precond", "chunk") if k in kw}) == (
                "jacobi chunk=256"):
            raise RuntimeError("made to fail")
        return rate(**kw)

    monkeypatch.setattr(tune, "rate", failing)
    monkeypatch.setenv("MACROC_PLATFORM", "cpu")
    out = tmp_path / "tune.json"
    monkeypatch.setattr(tune, "N_GPS", 8)
    monkeypatch.setattr(tune, "MICRO_N", 2)
    code = tune.main(["--out", str(out)])
    printed = capsys.readouterr().out
    result = json.loads(out.read_text())
    assert code == int(fail)
    assert result["failures"] == (["jacobi chunk=256"] if fail else [])
    assert len(result["rows"]) == 6 - fail and result["device"] == "cpu"
    assert ("jacobi chunk=256: FAILED" in printed) == fail
    assert json.loads(printed.splitlines()[-1])["failures"] == result["failures"]
